"""Op lowerings. Importing this package registers every ported op."""

from . import (fused_ops, math_ops, misc_ops, nn_ops, optimizer_ops, scan_ops,  # noqa: F401
               sequence_ops, tensor_ops, vision_ops)
