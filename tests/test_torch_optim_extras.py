"""Weight decay, gradient clipping, AdamW, Lamb and loss scaling, held
against the JAX package on the CPU.

Each case builds the same small program with both packages (two fc
layers and a squared-error mean, the JAX package's tests/test_amp.py
model), runs the JAX startup program, copies its state into the port's
scope by name, and takes 3 steps on each from there. The Programs must
be equal op for op (types, slots, var names, attrs): regularizers and
clips append ops with names from `unique_name`, so equal names show that
the same ops were appended in the same order.

Tolerances: in fp32, losses rtol 1e-5 and every persistable atol 1e-5
(fp32 summation order over a few dozen products). Under AMP (bf16 or
fp16 products, fp32 master weights): the losses within one ulp of the
AMP dtype (bf16 2^-8, fp16 2^-11 relative), and every persistable within
one such ulp of the larger magnitude of the two, plus 1e-7. In bf16 the
persistables are held against the JAX steps in a process without XLA's
excess precision (`jax_exact_bf16`): on the CPU, XLA keeps fp32 across
fused bf16 ops by default and skips roundings its lowerings ask for
(ROADMAP Queue 3), which moves a parameter by up to 5 bf16 ulps of its
update in 3 steps."""

import importlib
import json

import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.scope import to_numpy

STEPS = 3
TOL = dict(atol=1e-5, rtol=1e-5)
ULP = {"bfloat16": 2.0**-8, "float16": 2.0**-11}


def _model(fluid, param_attr=None):
    """tests/test_amp.py's regression model: x [-1, 8] -> fc 16 relu ->
    fc 1 -> mean squared error against y."""
    x = fluid.layers.data("x", [8])
    y = fluid.layers.data("y", [1])
    h = fluid.layers.fc(x, 16, act="relu", param_attr=param_attr)
    pred = fluid.layers.fc(h, 1)
    return fluid.layers.mean(fluid.layers.square_error_cost(pred, y))


def _build(fluid, make_opt, amp=None, param_attr=None, global_clip=None, split=False):
    """-> (main, startup, loss, the AMP wrapper or None)."""
    main, startup = fluid.Program(), fluid.Program()
    fluid.clip.set_gradient_clip(global_clip(fluid) if global_clip else None)
    try:
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            loss = _model(fluid, param_attr(fluid) if param_attr else None)
            opt = make_opt(fluid)
            if amp is not None:
                mp = importlib.import_module(fluid.__name__ + ".contrib.mixed_precision")
                opt = mp.decorate(opt, **amp)
            if split:
                opt.apply_gradients(opt.backward(loss))
            else:
                opt.minimize(loss)
    finally:
        fluid.clip.set_gradient_clip(None)
    return main, startup, loss, opt if amp is not None else None


def _feeds(steps, seed=0, poison=()):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(steps):
        x = rs.randn(32, 8).astype(np.float32)
        y = (x.sum(1, keepdims=True) * 0.1).astype(np.float32)
        if i in poison:
            x[0, 0] = np.inf
        out.append({"x": x, "y": y})
    return out


def _run(fluid, built, feeds, state=None):
    """Startup (then `state` by name), one step a feed -> (per-step
    fetches of the loss and, under loss scaling, the scale; the
    persistables as numpy)."""
    main, startup, loss, opt = built
    fetch = [loss]
    if opt is not None and not isinstance(opt.get_loss_scaling(), float):
        fetch.append(opt.get_loss_scaling())
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    if state is not None:
        tfluid.io.set_persistables_from_numpy(scope, state, "cpu")
    steps = [[np.asarray(a).reshape(-1)[0] for a in exe.run(
        main, feed=dict(f), fetch_list=fetch, scope=scope)] for f in feeds]
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    get = (lambda n: np.asarray(scope.get(n))) if fluid is not tfluid else (
        lambda n: np.asarray(to_numpy(scope.get(n))))
    return np.array(steps, dtype=np.float64), {n: get(n) for n in names}


def _both(feeds=None, **build_kw):
    """The case through both packages, the port from the JAX startup
    state -> (jax steps, jax state, port steps, port state, jax main, port
    main)."""
    import paddle_tpu as jfluid

    feeds = feeds or _feeds(STEPS)
    jb, tb = _build(jfluid, **build_kw), _build(tfluid, **build_kw)
    jd, td = jb[0].to_dict(), tb[0].to_dict()
    assert json.dumps(jd, sort_keys=True) == json.dumps(td, sort_keys=True)
    assert json.dumps(jb[1].to_dict(), sort_keys=True) == json.dumps(
        tb[1].to_dict(), sort_keys=True)
    scope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jb[1], scope=scope)
    state0 = {v.name: np.asarray(scope.get(v.name)) for v in jb[0].list_vars()
              if v.persistable}
    jsteps, jstate = _run(jfluid, jb, feeds, state0)
    tsteps, tstate = _run(tfluid, tb, feeds, state0)
    assert sorted(jstate) == sorted(tstate)
    return jsteps, jstate, tsteps, tstate, jb[0], tb[0]


def _types(main):
    return [op.type for op in main.global_block().ops]


def _assert_fp32(jsteps, jstate, tsteps, tstate):
    np.testing.assert_allclose(tsteps, jsteps, **TOL)
    for n in jstate:
        np.testing.assert_allclose(tstate[n], jstate[n], err_msg=n, **TOL)


def _assert_amp(jsteps, jstate, tsteps, tstate, dtype):
    ulp = ULP[dtype]
    np.testing.assert_allclose(tsteps, jsteps, rtol=ulp, atol=0)
    for n in jstate:
        j, t = jstate[n].astype(np.float64), tstate[n].astype(np.float64)
        assert (np.abs(t - j) <= ulp * np.maximum(np.abs(j), np.abs(t)) + 1e-7).all(), n


# -- weight decay, clipping, AdamW, Lamb in fp32 ------------------------------

def _sgd(fluid, **kw):
    return fluid.optimizer.SGD(0.05, **kw)


FP32_CASES = {
    "l2_decay": dict(make_opt=lambda f: _sgd(f, regularization=f.regularizer.L2Decay(0.1))),
    "l1_decay": dict(make_opt=lambda f: _sgd(f, regularization=f.regularizer.L1Decay(0.05))),
    # the ParamAttr's regularizer on the first fc's weight, the optimizer's
    # on every other parameter
    "param_attr_decay": dict(
        make_opt=lambda f: _sgd(f, regularization=f.regularizer.L2Decay(0.1)),
        param_attr=lambda f: f.ParamAttr(regularizer=f.regularizer.L1Decay(0.2))),
    "param_attr_decay_alone": dict(
        make_opt=_sgd,
        param_attr=lambda f: f.ParamAttr(regularizer=f.regularizer.L2Decay(0.3))),
    "clip_by_value": dict(
        make_opt=lambda f: _sgd(f, grad_clip=f.clip.GradientClipByValue(0.05))),
    "clip_by_value_min": dict(
        make_opt=lambda f: _sgd(f, grad_clip=f.clip.GradientClipByValue(0.2, min=-0.01))),
    "clip_by_norm": dict(
        make_opt=lambda f: _sgd(f, grad_clip=f.clip.GradientClipByNorm(0.1))),
    "clip_by_global_norm": dict(
        make_opt=lambda f: _sgd(f, grad_clip=f.clip.GradientClipByGlobalNorm(0.2))),
    "error_clip_by_value": dict(
        make_opt=lambda f: _sgd(f, grad_clip=f.clip.ErrorClipByValue(0.05))),
    "set_gradient_clip": dict(make_opt=_sgd,
                              global_clip=lambda f: f.clip.GradientClipByGlobalNorm(0.2)),
    # the optimizer's own clip wins over the program-wide one
    "own_clip_over_set_gradient_clip": dict(
        make_opt=lambda f: _sgd(f, grad_clip=f.clip.GradientClipByValue(0.05)),
        global_clip=lambda f: f.clip.GradientClipByGlobalNorm(0.2)),
    "decay_then_clip": dict(make_opt=lambda f: _sgd(
        f, regularization=f.regularizer.L2Decay(0.1),
        grad_clip=f.clip.GradientClipByGlobalNorm(0.2))),
    "adamw": dict(make_opt=lambda f: f.optimizer.AdamW(0.01, weight_decay=0.05)),
    "lamb": dict(make_opt=lambda f: f.optimizer.Lamb(0.01, lamb_weight_decay=0.01)),
    "lamb_clipped": dict(make_opt=lambda f: f.optimizer.Lamb(
        0.01, grad_clip=f.clip.GradientClipByGlobalNorm(1.0))),
}


@pytest.mark.parametrize("name", sorted(FP32_CASES))
def test_training_extras_match_jax(name):
    jsteps, jstate, tsteps, tstate, jmain, _ = _both(**FP32_CASES[name])
    _assert_fp32(jsteps, jstate, tsteps, tstate)
    types = _types(jmain)
    want = {"l1_decay": "sign", "param_attr_decay": "sign", "l2_decay": "scale",
            "clip_by_value": "clip", "clip_by_norm": "clip_by_norm",
            "clip_by_global_norm": "squared_l2_norm", "set_gradient_clip": "elementwise_max",
            "adamw": "adamw", "lamb": "lamb"}.get(name)
    assert want is None or want in types
    if name == "own_clip_over_set_gradient_clip":
        assert "clip" in types and "squared_l2_norm" not in types


def test_lamb_trust_ratio_where_a_norm_is_zero():
    """A zero parameter with a zero grad: both norms 0, ratio 1, and the
    parameter stays 0 in both packages; a zero parameter with a live
    grad: ||p|| = 0, ratio 1."""
    def build(fluid):
        return fluid.optimizer.Lamb(0.1, lamb_weight_decay=0.5)

    feeds = _feeds(STEPS)
    for f in feeds:
        f["x"][:, 4:] = 0.0  # the first fc's rows 4..7 get zero grads
    jsteps, jstate, tsteps, tstate, _, _ = _both(
        feeds=feeds, make_opt=build,
        param_attr=lambda f: f.ParamAttr(initializer=f.initializer.Constant(0.0)))
    _assert_fp32(jsteps, jstate, tsteps, tstate)
    assert np.isfinite(tsteps).all() and all(np.isfinite(v).all() for v in tstate.values())


# -- loss scaling -------------------------------------------------------------

def _scaled(dtype, dynamic, init=8.0):
    return dict(amp_dtype=dtype, init_loss_scaling=init, use_dynamic_loss_scaling=dynamic,
                incr_every_n_steps=2, decr_every_n_nan_or_inf=1, incr_ratio=2.0,
                decr_ratio=0.5)


def _sgd_05(fluid):
    return fluid.optimizer.SGD(0.05)


# name -> (build keywords, feeds); the bf16 cases are also held against
# the JAX steps without excess precision (`jax_exact_bf16`)
AMP_CASES = {
    **{f"{dtype}_{'dynamic' if dyn else 'static'}": (
        dict(make_opt=_sgd_05, amp=_scaled(dtype, dyn)), _feeds(STEPS))
       for dtype in ("bfloat16", "float16") for dyn in (False, True)},
    **{f"{dtype}_overflow": (dict(make_opt=_sgd_05, amp=_scaled(dtype, True, init=4.0)),
                             _feeds(3, seed=1, poison=(1, 2)))
       for dtype in ("bfloat16", "float16")},
}


def _jax_steps(name):
    """The JAX package's steps of AMP_CASES[name] from its startup state ->
    (steps, persistables)."""
    import paddle_tpu as jfluid

    build_kw, feeds = AMP_CASES[name]
    built = _build(jfluid, **build_kw)
    return _run(jfluid, built, feeds)


@pytest.fixture(scope="module")
def jax_exact_bf16(tmp_path_factory):
    """The bf16 AMP_CASES through the JAX package in a process with
    XLA_FLAGS=--xla_allow_excess_precision=false, which rounds every bf16
    value its lowerings ask for, as torch does -> {name: (steps,
    persistables)}. With excess precision (XLA's default on the CPU) the
    JAX steps keep fp32 across fused ops, and after 3 SGD steps a
    parameter differs from the port's by up to 2.3% of its update (5
    bf16 ulps; measured on an Intel Xeon); without it they agree within
    1e-7."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    out = tmp_path_factory.mktemp("jax_exact") / "ref.npz"
    names = [n for n in AMP_CASES if n.startswith("bfloat16")]
    here = Path(__file__).resolve().parent
    code = (
        "import sys, numpy as np, jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        f"sys.path[:0] = [{str(here.parent)!r}, {str(here)!r}]\n"
        "import test_torch_optim_extras as t\n"
        "arrays = {}\n"
        f"for name in {names!r}:\n"
        "    steps, state = t._jax_steps(name)\n"
        "    arrays[name + '/steps'] = steps\n"
        "    arrays.update({name + '/' + k: v for k, v in state.items()})\n"
        f"np.savez({str(out)!r}, **arrays)\n"
    )
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    data = np.load(out)
    refs = {}
    for name in names:
        state = {k.split("/", 1)[1]: data[k] for k in data.files
                 if k.startswith(name + "/") and k != name + "/steps"}
        refs[name] = (data[name + "/steps"], state)
    return refs


def _amp_case(name, exact):
    """AMP_CASES[name] through both packages, the port from the JAX
    startup state: the losses within one ulp of the JAX ones, and, in
    fp16, the persistables too; in bf16 the persistables within one bf16
    ulp of the JAX steps without excess precision -> (jax steps, port
    steps, port persistables, jax main)."""
    build_kw, feeds = AMP_CASES[name]
    dtype = build_kw["amp"]["amp_dtype"]
    jsteps, jstate, tsteps, tstate, jmain, _ = _both(feeds=feeds, **build_kw)
    if dtype == "bfloat16":
        np.testing.assert_allclose(tsteps, jsteps, rtol=ULP[dtype], atol=0)
        jsteps, jstate = exact[name]
    _assert_amp(jsteps, jstate, tsteps, tstate, dtype)
    return jsteps, tsteps, tstate, jmain


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("dynamic", [False, True])
def test_loss_scaling_matches_jax(dtype, dynamic, jax_exact_bf16):
    """Static and dynamic scaling in bf16 and fp16: the Program's
    scaling ops (none for bf16 with a static scale, which needs none),
    3 steps against the JAX steps."""
    jsteps, tsteps, _, jmain = _amp_case(f"{dtype}_{'dynamic' if dynamic else 'static'}",
                                         jax_exact_bf16)
    types = _types(jmain)
    assert ("check_finite_and_unscale" in types) == (dynamic or dtype == "float16")
    assert ("update_loss_scaling" in types) == dynamic
    if dynamic:  # two finite steps close the window: 8 -> 16 at step 3
        assert tsteps[:, 1].tolist() == jsteps[:, 1].tolist() == [8.0, 8.0, 16.0]


def test_fp16_static_scaling_split_api_matches_jax():
    """use_dynamic_loss_scaling=False through backward() / apply_gradients()
    (tests/test_amp.py:213-251)."""
    jsteps, jstate, tsteps, tstate, jmain, _ = _both(
        make_opt=lambda f: f.optimizer.SGD(0.1), amp=_scaled("float16", False, 64.0),
        split=True)
    _assert_amp(jsteps, jstate, tsteps, tstate, "float16")
    assert "update_loss_scaling" not in _types(jmain)


def test_fp16_trains_and_scale_grows_like_jax():
    """tests/test_amp.py:95-120 ported: 6 fp16 steps with dynamic scaling
    (init 8, incr_every_n_steps 2): finite losses that fall, and the
    scale grows, step by step as in the JAX package."""
    amp = dict(amp_dtype="float16", init_loss_scaling=8.0, incr_every_n_steps=2,
               decr_every_n_nan_or_inf=1, incr_ratio=2.0, decr_ratio=0.5)
    jsteps, jstate, tsteps, tstate, _, _ = _both(feeds=_feeds(6), make_opt=_sgd_05, amp=amp)
    _assert_amp(jsteps, jstate, tsteps, tstate, "float16")
    assert np.isfinite(tsteps[:, 0]).all() and tsteps[-1, 0] < tsteps[0, 0]
    assert tsteps[:, 1].tolist() == jsteps[:, 1].tolist() and tsteps[-1, 1] > 8.0


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_overflow_shrinks_scale_and_skips_update_like_jax(dtype, jax_exact_bf16):
    """tests/test_amp.py:122-162 ported: after a good step, two steps with
    an inf input: the first only counts (the window compares the count
    before the increment), the second halves the scale; both leave every
    parameter as it was, and the port's FoundInfinite is true on both."""
    name = f"{dtype}_overflow"
    jsteps, tsteps, _, _ = _amp_case(name, jax_exact_bf16)
    assert tsteps[:, 1].tolist() == jsteps[:, 1].tolist() == [4.0, 4.0, 2.0]
    build_kw, feeds = AMP_CASES[name]
    built = _build(tfluid, **build_kw)
    found = next(op.output("FoundInfinite")[0] for op in built[0].global_block().ops
                 if op.type == "check_finite_and_unscale")
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(built[1], scope=scope)
    params = [p.name for p in built[0].all_parameters()]
    seen = []
    for f in feeds:
        seen.append(bool(exe.run(built[0], feed=dict(f), fetch_list=[found],
                                 scope=scope)[0][0]))
        if len(seen) == 1:  # the parameters after the good step
            good = {n: to_numpy(scope.get(n)).copy() for n in params}
    assert seen == [False, True, True]
    for n in params:
        np.testing.assert_array_equal(to_numpy(scope.get(n)), good[n], err_msg=n)
        assert np.isfinite(to_numpy(scope.get(n))).all()


def test_decorate_defaults():
    """fp16 turns dynamic scaling on by default, bf16 leaves it off; any
    other dtype raises."""
    mp = tfluid.contrib.mixed_precision
    assert mp.decorate(tfluid.optimizer.SGD(0.1), amp_dtype="float16")._use_dynamic
    assert not mp.decorate(tfluid.optimizer.SGD(0.1))._use_dynamic
    assert mp.decorate(tfluid.optimizer.SGD(0.1)).get_loss_scaling() == 2.0**15
    with pytest.raises(ValueError, match="amp_dtype"):
        mp.decorate(tfluid.optimizer.SGD(0.1), amp_dtype="float64")
