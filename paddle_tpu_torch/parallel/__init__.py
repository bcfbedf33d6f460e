"""Distribution: ONE named mesh over the ranks of the default
torch.distributed process group, plus sharding annotations (the port's
copy of `paddle_tpu/parallel/`, its mesh and api modules), the mesh step
(step.py) and the tensor-parallel layout plan that runs the annotations
over the `model` axis (tensor_parallel.py, the port's own: GSPMD has no
module to copy). The pipeline, Ulysses and MoE modules are ROADMAP Queue
1 item 9c."""

from .mesh import (  # noqa: F401
    AXES,
    P,
    build_mesh,
    canonical_axis,
    canonicalize_spec,
    current_mesh,
    mesh_signature,
)
from .api import (  # noqa: F401
    DistributedStrategy,
    compile_distributed,
    get_mesh,
    make_mesh,
    shard_parameter,
    sharding_specs,
)
