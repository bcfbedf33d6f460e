"""Op lowerings. Importing this package registers every ported op."""

from . import (fused_ops, math_ops, misc_ops, moe_ops, nn_ops, optimizer_ops,  # noqa: F401
               scan_ops, sequence_ops, tensor_ops, vision_ops)
