"""BuildStrategy: the knobs that choose the Program passes
(`paddle_tpu/compiler.py:76-104`, the pass knobs only).

Each knob gates one pass of `passes/`; the PADDLE_TPU_PASSES environment
variable overrides all of them. A strategy reaches a run as
`Executor.run(..., build_strategy=bs)`: the JAX package hands it over
through `CompiledProgram` (the mesh path), which is not ported yet, nor
is the `auto_shard` knob with its pass (ROADMAP Queue 1, item 9).
"""

from __future__ import annotations

__all__ = ["BuildStrategy"]


class BuildStrategy:
    """Pass selection (reference: details/build_strategy.h).

      * constant_folding (default True): passes/const_fold.py
      * enable_inplace (default True): passes/copy_prop.py
      * memory_optimize (default True): passes/dce.py
      * fuse_conv_bn (default True): passes/fuse_conv_bn.py, inference
        programs only
      * enable_layout_opt (default True): passes/layout_opt.py
      * fuse_layer_scan (default False, opt-in; also
        PADDLE_TPU_FUSE_LAYER_SCAN=1): passes/fuse_layer_scan.py
      * fuse_all_optimizer_ops (default True): passes/fuse_optimizer.py
      * optimizer_overlap (default False, opt-in; also
        PADDLE_TPU_OPTIMIZER_OVERLAP=1): passes/optimizer_overlap.py
    """

    def __init__(self):
        self.constant_folding = True
        self.enable_inplace = True
        self.memory_optimize = True
        self.fuse_conv_bn = True
        self.enable_layout_opt = True
        self.fuse_layer_scan = False
        self.fuse_all_optimizer_ops = True
        self.optimizer_overlap = False
