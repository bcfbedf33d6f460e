"""paddle_tpu_torch — the PyTorch / CUDA port of paddle_tpu, for an NVIDIA
H100. It keeps the JAX package's `fluid`-style surface, Program IR, op
types and attrs, and on-disk formats, and runs a Program eagerly on torch
tensors. The attention and LayerNorm-backward kernels that paddle_tpu
wrote in Pallas for the TPU are hand-written CUDA here
(ops/kernels/csrc/). It imports neither jax nor paddle_tpu.

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.bert import BertConfig, build_bert_pretrain
    h = build_bert_pretrain(BertConfig.base(), 8, 128, mlm_only=True, max_preds=20)
    fluid.optimizer.Adam(1e-4).minimize(h["loss"])
    exe = fluid.Executor()            # CUDAPlace(0); CPUPlace() for the CPU
    exe.run(fluid.default_startup_program())
    loss, = exe.run(feed=feed, fetch_list=[h["loss"]])

This package holds the ported slices so far: BERT encoder serving; BERT
pretraining (the masked-LM and next-sentence heads, every attention
path of `BertConfig`) with SGD, Momentum, Adam, AdamW or Lamb, weight
decay (`regularizer`) and gradient clipping (`clip`), in fp32 or under
AMP with static or dynamic loss scaling (`contrib.mixed_precision.
decorate`, bf16 or fp16), also with activation recomputation
(`recompute_scope`, `optimizer.RecomputeOptimizer`); ResNet, VGG,
SE-ResNeXt and LeNet-5 training, and ResNet serving; and the Transformer
(`models.transformer`: training, and incremental decode through an
encode and a decode-step program, with beam search in `decoding`). The
Executor runs the JAX package's default Program passes (`passes/`:
const_fold, copy_prop, dce, fuse_conv_bn, layout_opt, fuse_optimizer)
over a cached clone of each Program before it walks it;
PADDLE_TPU_PASSES=none turns them off, and PADDLE_TPU_FUSE_LAYER_SCAN=1
adds fuse_layer_scan. Dygraph (`dygraph`: `with fluid.dygraph.guard():`,
the Layer classes, `optimizer.*(parameter_list=...)`, `loss.backward()`)
runs eagerly on torch tensors, and `dygraph.to_compiled` replays a whole
train step as one CUDA graph. The input pipeline (`reader`: the decorators
and `DataLoader`, which stages batches onto the card ahead of the step;
`DataFeeder`; `DatasetFactory` with `Executor.train_from_dataset`;
`datasets`; `incubate.data_generator`) and `contrib.Trainer` feed it.
`CompiledProgram(main).with_data_parallel(loss_name=...)` trains over the
mesh (`parallel`): a torch.distributed DeviceMesh over the ranks of the
default process group, one device a rank, ZeRO-1 with `zero1=True`.
"""

from . import (clip, contrib, data_feeder, dataset, datasets, decoding, dygraph, incubate,
               inference, initializer, io, layers, models, nets, optimizer, param_attr,
               parallel, passes, profiler, reader, regularizer)
from .backward import append_backward, calc_gradient, gradients
from .compiler import BuildStrategy, CompiledProgram, ExecutionStrategy
from .data_feeder import DataFeeder
from .dataset import DatasetFactory
from .executor import Executor
from .framework import (
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    in_dygraph_mode,
    name_scope,
    program_guard,
    recompute_scope,
    unique_name,
)
from .param_attr import ParamAttr
from .place import CPUPlace, CUDAPlace
from .scope import Scope, global_scope, scope_guard

__version__ = "0.1.0"

fluid = __import__(__name__)
