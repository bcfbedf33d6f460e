"""fluid.layers surface: the layers that have been ported so far."""

from . import io, nn, ops, tensor
from .io import *  # noqa: F401,F403
from .math_op_patch import monkey_patch_variable
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403

monkey_patch_variable()
