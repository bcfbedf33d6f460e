"""Distribution: ONE named mesh over the ranks of the default
torch.distributed process group, plus sharding annotations (the port's
copy of `paddle_tpu/parallel/`, its mesh and api modules), the mesh step
(step.py) and the tensor-parallel layout plan that runs the annotations
over the `model` axis (tensor_parallel.py, the port's own: GSPMD has no
module to copy), with its sequence layout and expert rule; Ulysses
(ulysses.py) and mixture of experts (moe.py). The pipeline modules are
ROADMAP Queue 1 item 9d."""

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
from .moe import MoEParams, init_moe_params, moe_ffn, moe_shardings  # noqa: F401,E402
from .ulysses import ulysses_attention  # noqa: F401,E402
