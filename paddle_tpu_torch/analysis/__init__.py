"""Static analysis over the Program IR: the part of
`paddle_tpu/analysis/` the autoshard planner reads — the VarMeta
abstraction (meta.py), the shape-inference engine (shape_infer.py), the
sharding consistency checker (sharding_check.py) and the verifier's
`Finding` record (verifier.py). Analysis never mutates programs.

The JAX package's library of per-op shape functions and its IR verifier
are ROADMAP Queue 1 item 11: here every op poisons its non-persistable
outputs to unknown, and persistables keep the declared shapes they were
seeded with, which is all the planner reads.
"""

from .meta import InferError, Unknown, VarMeta, lowered_dtype  # noqa: F401
from .shape_infer import InferContext, InferResult, infer_block, infer_program  # noqa: F401
from .sharding_check import check_sharding, check_spec_axes  # noqa: F401
from .verifier import Finding  # noqa: F401

__all__ = [
    "VarMeta",
    "InferError",
    "Unknown",
    "lowered_dtype",
    "InferContext",
    "InferResult",
    "infer_block",
    "infer_program",
    "check_sharding",
    "check_spec_axes",
    "Finding",
]
