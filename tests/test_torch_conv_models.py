"""The rest of the conv stack on the CPU, held against the JAX package:
VGG, SE-ResNeXt, LeNet-5 (`nets.simple_img_conv_pool`), and the
sigmoid, adaptive pool2d, conv2d_transpose and conv3d lowerings.

- The training Programs of VGG-16 and SE-ResNeXt-50 (b 64, 224x224,
  1000 classes, Momentum(0.1, 0.9) under bf16 AMP) and LeNet-5 (b 64,
  1x28x28, fp32) equal the JAX package's op for op, main and startup
  (types, slots, names, attrs, variables), and so do their post-pass
  Programs.
- VGG-11 and SE-ResNeXt-26 at 32x32, 10 classes, b 4, and LeNet-5 at
  b 8: three Momentum(0.05, 0.9) steps, each from the JAX package's state
  before it (its startup state first), as tests/test_torch_resnet.py
  runs ResNet-18.
- Each new lowering and its grad through both packages' Executors on the
  same numpy inputs: sigmoid; adaptive pool2d, avg over bins that do not
  divide the input (the reference's floor / ceil windows), avg and max
  over an even split, and the uneven max, which both packages refuse;
  conv2d_transpose at stride 2, with groups, with unequal pads, and
  through the layer with `output_size`; conv3d with padding, stride and
  groups.

Tolerances, each with its reason:
- Single ops: atol and rtol 1e-5 (fp32 summation order).
- Model steps: losses rtol 1e-4 and each persistable within 1e-3 of its
  largest magnitude, tests/test_torch_resnet.py's gates. Each step starts
  from the JAX state: at b 4 and 32x32 the last blocks' batch norms
  normalise 4 values a channel and amplify a summation-order difference
  about a hundredfold a step, so free-running steps part after the
  second. SE-ResNeXt-26's grads are discontinuous at every size tried:
  a relu input within rounding of zero flips, and the grad of every
  tensor upstream of it jumps. The port's own step, with its input
  moved by one float32 ulp, moves the velocities by up to 17% of their
  largest element (sx3a_a.w_0), and the JAX package's own step so moved
  differs from it unmoved as the port does (b 16 at 64x64: 7.87e-2 of
  sx5a_c.w_0's velocity, one output channel, either way). A larger size
  does not remove it: the worst elementwise gap over three steps was
  1.5e-1 at b 8 on 64x64, 7.9e-2 at b 16 on 64x64, 1.2e-1 at b 32 on
  32x32 and 1.5e-1 at b 8 on 128x128. So there the velocities and each
  parameter's change in the step (param - param before it) are held
  within 5e-2 of their norm (measured: 2.5e-2, sx3a_a_bn.w_1's change),
  the losses and batch-norm statistics at the gates above.

The `gpu` test (`python -m pytest -m gpu --noconftest
tests/test_torch_conv_models.py` on the card) runs the new ops and their
grads on the card against the CPU within 1e-4.
"""

import importlib
import json

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.ops.kernels import LAUNCHES
from paddle_tpu_torch.passes import apply_program_passes
from paddle_tpu_torch.scope import to_numpy
from test_torch_resnet import _data, _programs, _raw_op, _run_both, _with_grads

TOL = dict(atol=1e-5, rtol=1e-5)
RS = np.random.RandomState(11)


# -- the model Programs -----------------------------------------------------------


def _model(name, b, hw, classes, amp, lr=0.1, depth=None):
    def build(fluid):
        mp = importlib.import_module(fluid.__name__ + ".contrib.mixed_precision")
        channels = 1 if name == "lenet" else 3
        img = _data(fluid, "img", [b, channels, hw, hw], grad=False)
        label = _data(fluid, "label", [b, 1], dtype="int64", grad=False)
        if name == "vgg":
            m = importlib.import_module(fluid.__name__ + ".models.vgg")
            handles = m.vgg(img, label, depth=depth or 16, class_num=classes)
        elif name == "se_resnext":
            m = importlib.import_module(fluid.__name__ + ".models.se_resnext")
            handles = m.se_resnext(img, label, depth=depth or 50, class_num=classes)
        else:
            m = importlib.import_module(fluid.__name__ + ".models.lenet")
            handles = m.lenet5(img, label, class_num=classes)
        opt = fluid.optimizer.Momentum(lr, 0.9)
        (mp.decorate(opt) if amp else opt).minimize(handles[1])
        return handles
    return build


PROGRAM_CASES = {
    # name: (build, main ops)
    "vgg16_bf16": (_model("vgg", 64, 224, 1000, True), 262),
    "se_resnext50_bf16": (_model("se_resnext", 64, 224, 1000, True), 1419),
    "lenet5_fp32": (_model("lenet", 64, 28, 10, False), 80),
}


@pytest.mark.parametrize("name", sorted(PROGRAM_CASES))
def test_model_program_equals_jax(name, monkeypatch):
    import paddle_tpu as jfluid
    from paddle_tpu.passes import apply_program_passes as japply

    monkeypatch.setenv("PADDLE_TPU_VERIFY", "0")
    build, n_ops = PROGRAM_CASES[name]
    (jmain, jstartup, jh), (tmain, tstartup, th) = (_programs(jfluid, build),
                                                   _programs(tfluid, build))
    assert len(tmain.global_block().ops) == n_ops
    for jp, tp in ((jmain, tmain), (jstartup, tstartup)):
        assert json.dumps(jp.to_dict(), sort_keys=True) == json.dumps(tp.to_dict(),
                                                                     sort_keys=True)
    feeds, fetch = ("img", "label"), (th[1].name,)
    _, jblock, jstats = japply(jmain, feeds, fetch)
    _, tblock, tstats = apply_program_passes(tmain, feeds, fetch)
    assert tstats == jstats
    assert [op.to_dict() for op in jblock.ops] == [op.to_dict() for op in tblock.ops]


# -- model steps from the JAX state -----------------------------------------------


def _numpy_state(scope, names):
    return {n: np.asarray(scope.get(n)) for n in names}


STEP_CASES = {
    # name: (build, feed batch, hw, classes)
    "vgg11": (_model("vgg", 4, 32, 10, False, lr=0.05, depth=11), 4, 32, 10),
    "se_resnext26": (_model("se_resnext", 4, 32, 10, False, lr=0.005, depth=26), 4, 32, 10),
    "lenet5": (_model("lenet", 8, 28, 10, False, lr=0.01), 8, 28, 10),
}


def _ill_conditioned(model, name):
    """SE-ResNeXt's parameters and velocities, held by their changes'
    norms (see the docstring)."""
    return model == "se_resnext26" and not name.endswith((".mean", ".var"))


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_model_steps_match_jax(name):
    import paddle_tpu as jfluid

    build, b, hw, classes = STEP_CASES[name]
    rs = np.random.RandomState(0)
    feed = {"img": rs.randn(b, 1 if name == "lenet5" else 3, hw, hw).astype(np.float32),
            "label": rs.randint(0, classes, (b, 1)).astype(np.int64)}
    jmain, jstartup, jh = _programs(jfluid, build)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    names = sorted(v.name for v in jmain.list_vars() if v.persistable)
    tmain, tstartup, th = _programs(tfluid, build)
    assert sorted(v.name for v in tmain.list_vars() if v.persistable) == names
    tscope = tfluid.Scope()
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.run(tstartup, scope=tscope)
    launches = dict(LAUNCHES)
    losses = []
    for step in range(3):
        before = _numpy_state(jscope, names)
        tfluid.io.set_persistables_from_numpy(tscope, before, "cpu")
        jl = float(np.asarray(jexe.run(jmain, feed=dict(feed), fetch_list=[jh[1]],
                                       scope=jscope)[0]).reshape(-1)[0])
        tl = float(np.asarray(texe.run(tmain, feed=dict(feed), fetch_list=[th[1]],
                                       scope=tscope)[0]).reshape(-1)[0])
        assert np.isfinite(tl)
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=0, err_msg=f"step {step}")
        js = _numpy_state(jscope, names)
        for n in names:
            t = to_numpy(tscope.get(n))
            if _ill_conditioned(name, n):
                base = 0 if "_velocity_" in n else before[n]
                norm = max(float(np.linalg.norm(js[n] - base)), 1e-6)
                assert np.linalg.norm(t - js[n]) <= 5e-2 * norm, (step, n)
                continue
            scale = max(float(np.abs(js[n]).max()), 1e-6)
            assert np.abs(t - js[n]).max() <= 1e-3 * scale, (step, n)
        losses.append(jl)
    assert texe.recomputed_forwards == []
    assert LAUNCHES == launches  # the conv paths run none of the kernels
    assert losses[-1] < losses[0]


# -- the new lowerings -------------------------------------------------------------


def _sigmoid(fluid):
    x = _data(fluid, "x", [3, 7])
    return _with_grads(fluid, fluid.layers.sigmoid(x), [x])


def _adaptive(ptype, out_hw, h=9, w=7):
    def build(fluid):
        x = _data(fluid, "x", [2, 3, h, w])
        out = fluid.layers.adaptive_pool2d(x, out_hw, pool_type=ptype)
        return _with_grads(fluid, out, [x])
    return build


def _conv_t(stride, padding, groups, out_shape, cin=4, cout=6):
    def build(fluid):
        x = _data(fluid, "x", [2, cin, 5, 5])
        w = _data(fluid, "w", [cin, cout // groups, 3, 3])
        out = _raw_op(fluid, "conv2d_transpose", {"Input": [x], "Filter": [w]},
                      {"strides": stride, "paddings": padding, "dilations": [1, 1],
                       "groups": groups}, "Output", out_shape)
        return _with_grads(fluid, out, [x, w])
    return build


def _conv_t_layer(fluid):
    x = _data(fluid, "x", [2, 4, 5, 5])
    out = fluid.layers.conv2d_transpose(x, 6, output_size=[11, 11], filter_size=3, stride=2,
                                        padding=0, groups=2, act="relu",
                                        param_attr=fluid.ParamAttr(name="w"),
                                        bias_attr=fluid.ParamAttr(name="b"))
    return _with_grads(fluid, out, [x])


def _conv3d(fluid):
    x = _data(fluid, "x", [2, 4, 5, 6, 7])
    out = fluid.layers.conv3d(x, 6, 3, stride=[1, 2, 1], padding=1, groups=2,
                              param_attr=fluid.ParamAttr(name="w"),
                              bias_attr=fluid.ParamAttr(name="b"))
    return _with_grads(fluid, out, [x])


def _g(*shape):
    return RS.randn(*shape).astype(np.float32)


X_POOL = _g(2, 3, 9, 7)
X_CT = _g(2, 4, 5, 5)
OP_CASES = {
    "sigmoid": (_sigmoid, {"x": 3 * _g(3, 7), "g": _g(3, 7)}),
    "adaptive_avg_uneven": (_adaptive("avg", [4, 3]), {"x": X_POOL, "g": _g(2, 3, 4, 3)}),
    "adaptive_avg_uneven_int": (_adaptive("avg", 5), {"x": X_POOL, "g": _g(2, 3, 5, 5)}),
    "adaptive_avg_even": (_adaptive("avg", [3, 7]), {"x": X_POOL, "g": _g(2, 3, 3, 7)}),
    "adaptive_max_even": (_adaptive("max", [3, 1]), {"x": X_POOL, "g": _g(2, 3, 3, 1)}),
    "adaptive_avg_1x1": (_adaptive("avg", 1), {"x": X_POOL, "g": _g(2, 3, 1, 1)}),
    "conv2d_transpose_s2": (_conv_t([2, 2], [1, 1], 1, [2, 6, 9, 9]),
                            {"x": X_CT, "w": 0.3 * _g(4, 6, 3, 3), "g": _g(2, 6, 9, 9)}),
    "conv2d_transpose_groups": (_conv_t([2, 1], [0, 1], 2, [2, 6, 11, 5]),
                                {"x": X_CT, "w": 0.3 * _g(4, 3, 3, 3), "g": _g(2, 6, 11, 5)}),
    "conv2d_transpose_unequal_pads": (_conv_t([2, 2], [0, 1, 1, 0], 1, [2, 6, 10, 10]),
                                      {"x": X_CT, "w": 0.3 * _g(4, 6, 3, 3),
                                       "g": _g(2, 6, 10, 10)}),
    "conv2d_transpose_layer": (_conv_t_layer, {"x": X_CT, "w": 0.3 * _g(4, 3, 3, 3),
                                               "b": _g(6), "g": _g(2, 6, 11, 11)}),
    "conv3d": (_conv3d, {"x": _g(2, 4, 5, 6, 7), "w": 0.3 * _g(6, 2, 3, 3, 3), "b": _g(6),
                         "g": _g(2, 6, 5, 3, 7)}),
}


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_op_and_grad_match_jax(name):
    build, feed = OP_CASES[name]
    jax_out, port_out = _run_both(build, feed)
    assert len(jax_out) == len(port_out)
    for j, t in zip(jax_out, port_out):
        assert j.shape == t.shape and j.dtype == t.dtype, (j.shape, t.shape, j.dtype, t.dtype)
        np.testing.assert_allclose(t, j, **TOL)


def test_adaptive_max_uneven_raises_like_jax():
    import paddle_tpu as jfluid

    for fluid in (jfluid, tfluid):
        main, startup, fetch = _programs(fluid, _adaptive("max", [4, 3]))
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        with pytest.raises(ValueError, match="adaptive max pool needs output sizes"):
            exe.run(main, feed={"x": X_POOL, "g": _g(2, 3, 4, 3)}, fetch_list=fetch,
                    scope=scope)


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_conv_models.py` on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_cuda_op_and_grad_match_cpu(name, cuda_device):
    build, feed = OP_CASES[name]
    outs = []
    for place in (tfluid.CUDAPlace(0), tfluid.CPUPlace()):
        main, startup, fetch = _programs(tfluid, build)
        scope = tfluid.Scope()
        exe = tfluid.Executor(place)
        exe.run(startup, scope=scope)
        outs.append(exe.run(main, feed=dict(feed), fetch_list=fetch, scope=scope))
    for g, c in zip(*outs):
        np.testing.assert_allclose(g, c, atol=1e-4, rtol=1e-4)
