"""The dygraph JIT bridge of paddle_tpu_torch (dygraph/jit.py) on the CPU,
mirroring tests/test_dygraph_jit.py: the compiled forward, grads and train
step against the port's eager dygraph and against the JAX bridge (same
weights by set_dict, same inputs), cache accounting and the LRU cap, the
loud fallback and the strict paths, closure threading, and the dropout
masks of cached calls, bit-equal to the JAX bridge's.

On the CPU a record runs the pure step each call (no graph); the `gpu`
tests (`python -m pytest -m gpu --noconftest
tests/test_torch_dygraph_jit.py` on the card) capture and replay CUDA
graphs: train steps against eager on the card, the replays' dropout keys,
the copies handed back, eviction, and a fallback before any capture.

Tolerances: forward and grads 1e-5 absolute (fp32, another op order than
eager's in the Adam step's bias correction, which the compiled step
computes from a float32 device scalar); the JAX bridge within 1e-5
absolute; dropout masks exactly.
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import profiler
from paddle_tpu_torch import dygraph as TD
from paddle_tpu_torch.dygraph import (Dropout, Layer, Linear, TracedLayer, to_compiled,
                                      to_variable)
from paddle_tpu_torch.dygraph.autograd import UncapturableError, record


@pytest.fixture
def rng():
    return np.random.RandomState(7)


@pytest.fixture
def cpu():
    with TD.guard(tfluid.CPUPlace()):
        yield


def _mlp(D, din=16, dhid=32, dout=8):
    class MLP(D.Layer):
        def __init__(self):
            super().__init__("mlp")
            self.fc1 = D.Linear(din, dhid, act="relu")
            self.fc2 = D.Linear(dhid, dout)

        def forward(self, x):
            return self.fc2(self.fc1(x))

    return MLP()


def _convnet(D):
    class ConvNet(D.Layer):
        """Conv + BN + pool: buffer (running stats) threading."""

        def __init__(self):
            super().__init__("convnet")
            self.conv = D.Conv2D(2, 4, 3, padding=1, act="relu")
            self.bn = D.BatchNorm(4)
            self.pool = D.Pool2D(pool_size=2, pool_type="max", pool_stride=2)
            self.fc = D.Linear(4 * 4 * 4, 5)

        def forward(self, x):
            h = self.pool(self.bn(self.conv(x)))
            return self.fc(D.record(lambda v: v.reshape(v.shape[0], -1), h))

    return ConvNet()


class LSTMCellNet(Layer):
    """A single LSTM layer unrolled over a fixed length: the Python loop is
    shape-static, so the bridge captures all T steps into one step."""

    def __init__(self, din=6, dhid=8):
        super().__init__("lstmcell")
        self.gates = Linear(din + dhid, 4 * dhid)
        self._dhid = dhid

    def forward(self, x):
        b, t, d = x.shape[0], x.shape[1], self._dhid
        h = to_variable(np.zeros((b, d), "float32"))
        c = to_variable(np.zeros((b, d), "float32"))
        for i in range(t):
            g = self.gates(record(lambda a, bb: torch.cat([a, bb], -1), x[:, i, :], h))
            it, ft, ot, cand = g[:, :d], g[:, d:2 * d], g[:, 2 * d:3 * d], g[:, 3 * d:]
            sig = lambda v: record(torch.sigmoid, v)  # noqa: E731
            c = sig(ft) * c + sig(it) * record(torch.tanh, cand)
            h = sig(ot) * record(torch.tanh, c)
        return h


NETS = {"mlp": (lambda: _mlp(TD), (4, 16)), "convnet": (lambda: _convnet(TD), (2, 2, 8, 8)),
        "lstm": (LSTMCellNet, (3, 5, 6))}


def _clone_params(src, dst):
    """Copies, not aliases: a compiled step writes into the live tensors."""
    dst.set_dict(src.state_dict())


def _max_param_diff(a, b):
    return max(float(np.abs(p.numpy() - q.numpy()).max())
               for (_, p), (_, q) in zip(a.named_parameters(), b.named_parameters()))


# -- forward and grads --------------------------------------------------------


@pytest.mark.parametrize("net", sorted(NETS))
def test_traced_forward_matches_eager(rng, cpu, net):
    make, shape = NETS[net]
    model = make()
    model.eval()
    x = to_variable(rng.randn(*shape).astype("float32"))
    want = model(x).numpy()
    out, traced = TracedLayer.trace(model, inputs=[x])
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(traced([x]).numpy(), want, atol=1e-5)
    assert traced.cache_info()["hits"] == 1


def test_traced_conv_bn_train_updates_buffers_like_eager(rng, cpu):
    x = rng.randn(2, 2, 8, 8).astype("float32")
    a, b = _convnet(TD), _convnet(TD)
    _clone_params(a, b)
    a(to_variable(x))
    _, traced = TracedLayer.trace(b, inputs=[to_variable(x)])
    np.testing.assert_allclose(traced([to_variable(x)]).numpy(), a(to_variable(x)).numpy(),
                               atol=1e-5)
    for buf in ("_mean", "_variance"):
        np.testing.assert_allclose(getattr(b.bn, buf).numpy(), getattr(a.bn, buf).numpy(),
                                   atol=1e-6)


@pytest.mark.parametrize("net", sorted(NETS))
def test_traced_grads_match_eager(rng, cpu, net):
    make, shape = NETS[net]
    x = rng.randn(*shape).astype("float32")
    a, b = make(), make()
    a.eval(), b.eval()
    _clone_params(a, b)
    a.clear_gradients()
    (a(to_variable(x)) ** 2).mean().backward()

    @to_compiled(layer=b)
    def traced_loss():
        loss = (b(to_variable(x)) ** 2).mean()
        loss.backward()
        return loss

    traced_loss()
    assert traced_loss.cache_info()["fallbacks"] == 0
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        np.testing.assert_allclose(q.gradient(), p.gradient(), atol=1e-5, err_msg=n)


def test_traced_input_gradients_written_back(rng, cpu):
    net = _mlp(TD)
    net.eval()
    x_np = rng.randn(4, 16).astype("float32")
    xe = to_variable(x_np)
    xe.stop_gradient = False
    (net(xe) ** 2).sum().backward()

    @to_compiled(layer=net)
    def step(v):
        (net(v) ** 2).sum().backward()

    xt = to_variable(x_np)
    xt.stop_gradient = False
    step(xt)
    np.testing.assert_allclose(xt.gradient(), xe.gradient(), atol=1e-5)


def test_forward_only_call_leaves_grads_none(rng, cpu):
    net = _mlp(TD)
    net.eval()
    x = to_variable(rng.randn(4, 16).astype("float32"))
    x.stop_gradient = False
    compiled = to_compiled(net)
    compiled(x)
    compiled(x)
    assert all(p.grad is None for _, p in net.named_parameters()) and x.grad is None


# -- the train step, against eager and against the JAX bridge -----------------


def _train_pair(make_opt_name, steps=4, drop=False, sched=False):
    """The same MLP (fc, fc[, dropout]) and step compiled in both packages
    from one state: -> {pkg: (losses, outputs, state, opt state, info)}."""
    rs = np.random.RandomState(3)
    x, y = rs.randn(8, 16).astype("float32"), rs.randn(8, 8).astype("float32")
    import paddle_tpu as jfluid
    from paddle_tpu import dygraph as JD

    res = {}
    for name, fl, D in (("jax", jfluid, JD), ("torch", tfluid, TD)):
        place = jfluid.CPUPlace() if name == "jax" else tfluid.CPUPlace()
        with fl.dygraph.guard(place):
            net = _mlp(D)
            net.drop = D.Dropout(0.5) if drop else None
            if name == "torch":
                net.set_dict(res["jax"][5])
            else:  # the same weights in every process (hash-seeded init)
                wr = np.random.RandomState(1)
                net.set_dict({k: (wr.uniform(-1, 1, v.shape) / np.sqrt(v.shape[0]))
                              .astype(v.dtype) for k, v in net.state_dict().items()})
            sd0 = net.state_dict()
            lr = D.NaturalExpDecay(0.1, 1, 0.5) if sched else 0.05
            opt = {"sgd": lambda: fl.optimizer.SGD(lr, parameter_list=net.parameters()),
                   "momentum": lambda: fl.optimizer.Momentum(lr, 0.9,
                                                             parameter_list=net.parameters()),
                   "adam": lambda: fl.optimizer.Adam(0.01, parameter_list=net.parameters())
                   }[make_opt_name]()

            @D.to_compiled(layer=net, optimizer=opt)
            def step():
                out = net(D.to_variable(x))
                if net.drop is not None:
                    out = net.drop(out)
                loss = ((out - D.to_variable(y)) ** 2).mean()
                loss.backward()
                opt.minimize(loss)
                net.clear_gradients()
                return loss, out

            losses, outs = [], []
            for _ in range(steps):
                loss, out = step()
                losses.append(float(loss.numpy()))
                outs.append(out.numpy())
            res[name] = (losses, outs, net.state_dict(), opt.state_dict(), step.cache_info(),
                         sd0, opt._dy_step, net.drop._step if drop else None)
    return res


@pytest.mark.parametrize("opt_name", ["sgd", "momentum", "adam"])
def test_compiled_train_step_matches_jax_bridge(opt_name):
    res = _train_pair(opt_name)
    j, t = res["jax"], res["torch"]
    np.testing.assert_allclose(t[0], j[0], atol=1e-5)
    for part in (2, 3):
        assert sorted(j[part]) == sorted(t[part])
        for k in j[part]:
            np.testing.assert_allclose(t[part][k], j[part][k], atol=1e-5, err_msg=k)
    assert t[4] == j[4] == {"entries": 1, "hits": 3, "misses": 1, "fallbacks": 0,
                            "fallen_back": False, "evictions": 0, "cap": 128}
    assert t[6] == j[6] == 4


def test_replayed_dropout_masks_bit_equal_jax_bridge():
    """Each cached call draws the JAX bridge's per-call key
    fold_in(fold_in(fold_in(key(0), ncalls), seed), step): the masks of
    every call equal the JAX bridge's bit for bit, differ call to call, and
    the dropout's host step counter advances as the JAX package's does."""
    res = _train_pair("momentum", steps=3, drop=True)
    j, t = res["jax"], res["torch"]
    for oj, ot in zip(j[1], t[1]):
        np.testing.assert_array_equal(ot == 0, oj == 0)
    assert not np.array_equal(t[1][0] == 0, t[1][1] == 0)
    np.testing.assert_allclose(t[0], j[0], atol=1e-5)
    assert t[7] == j[7]


def test_lr_schedule_advances_with_minimize_like_jax_bridge():
    res = _train_pair("sgd", steps=3, sched=True)
    np.testing.assert_allclose(res["torch"][0], res["jax"][0], atol=1e-5)
    for k, a in res["jax"][2].items():
        np.testing.assert_allclose(res["torch"][2][k], a, atol=1e-5)


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_compiled_train_step_matches_eager(rng, cpu, opt_name):
    x, y = rng.randn(8, 16).astype("float32"), rng.randn(8, 8).astype("float32")
    a, b = _mlp(TD), _mlp(TD)
    a.eval(), b.eval()
    _clone_params(a, b)
    make = {"sgd": lambda ps: tfluid.optimizer.SGD(0.1, parameter_list=ps),
            "adam": lambda ps: tfluid.optimizer.Adam(0.01, parameter_list=ps)}[opt_name]
    opt_a, opt_b = make(a.parameters()), make(b.parameters())

    @to_compiled(layer=b, optimizer=opt_b)
    def traced_step():
        loss = ((b(to_variable(x)) - to_variable(y)) ** 2).mean()
        loss.backward()
        opt_b.minimize(loss)
        b.clear_gradients()
        return loss

    for i in range(4):
        loss = ((a(to_variable(x)) - to_variable(y)) ** 2).mean()
        loss.backward()
        opt_a.minimize(loss)
        a.clear_gradients()
        assert abs(float(loss.numpy()) - float(traced_step().numpy())) < 1e-5, i
    assert _max_param_diff(a, b) < 1e-5
    assert opt_b._dy_step == opt_a._dy_step == 4
    assert traced_step.cache_info()["hits"] == 3


# -- cache behaviour ----------------------------------------------------------


def test_cache_hit_same_signature_counters(rng, cpu):
    net = _mlp(TD)
    net.eval()
    compiled = to_compiled(net)
    c0 = profiler.counters()
    compiled(to_variable(rng.randn(4, 16).astype("float32")))
    x2 = to_variable(rng.randn(4, 16).astype("float32"))
    compiled(x2)
    compiled(x2)
    info = compiled.cache_info()
    assert info["misses"] == 1 and info["hits"] == 2 and info["entries"] == 1
    c1 = profiler.counters()
    assert c1["dygraph_jit_cache_hit"] - c0.get("dygraph_jit_cache_hit", 0) == 2
    assert c1["dygraph_jit_cache_miss"] - c0.get("dygraph_jit_cache_miss", 0) == 1


def test_recompile_on_new_input_signature(rng, cpu):
    net = _mlp(TD)
    net.eval()
    compiled = to_compiled(net)
    compiled(to_variable(rng.randn(4, 16).astype("float32")))
    compiled(to_variable(rng.randn(9, 16).astype("float32")))
    compiled(to_variable(rng.randn(4, 16).astype("float32")))
    info = compiled.cache_info()
    assert info["misses"] == 2 and info["hits"] == 1 and info["entries"] == 2


def test_kwarg_name_is_part_of_signature(rng, cpu):
    net = _mlp(TD)
    net.eval()

    @to_compiled(layer=net)
    def step(a=None, b=None):
        return net(a) if b is None else net(b) * 0.0

    x = rng.randn(4, 16).astype("float32")
    oa, ob = step(a=to_variable(x)), step(b=to_variable(x))
    info = step.cache_info()
    assert info["misses"] == 2 and info["entries"] == 2, info
    assert float(np.abs(oa.numpy()).sum()) > 0
    np.testing.assert_array_equal(ob.numpy(), 0.0 * ob.numpy())


def test_container_structure_is_part_of_signature(rng, cpu):
    net = _mlp(TD)
    net.eval()

    @to_compiled(layer=net)
    def step(first, second):
        total = net(first[0])
        for v in first[1:]:
            total = total + net(v)
        for v in second:
            total = total + 2.0 * net(v)
        return total

    x, y = rng.randn(4, 16).astype("float32"), rng.randn(4, 16).astype("float32")
    o1 = step([to_variable(x)], [to_variable(y)])
    o2 = step([to_variable(x), to_variable(y)], [])
    assert step.cache_info()["misses"] == 2
    nx, ny = net(to_variable(x)).numpy(), net(to_variable(y)).numpy()
    np.testing.assert_allclose(o1.numpy(), nx + 2 * ny, atol=1e-5)
    np.testing.assert_allclose(o2.numpy(), nx + ny, atol=1e-5)


def test_layer_mutation_after_first_call_is_loud(rng, cpu):
    net = _mlp(TD)
    net.eval()
    compiled = to_compiled(net)
    x = to_variable(rng.randn(4, 16).astype("float32"))
    compiled(x)
    net.extra = Linear(8, 8)
    orig_forward = net.forward
    net.forward = lambda v: net.extra(orig_forward(v))
    want = net.forward(x).numpy()
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        out = compiled(x)
    assert any("state changed after the first compiled call" in str(w.message) for w in log)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)
    (net.forward(x) ** 2).mean().backward()
    assert all(np.isfinite(p.gradient()).all() for _, p in net.extra.named_parameters())


def test_zero_grad_buffers_are_reused_across_calls(rng, cpu):
    net = _mlp(TD)
    net.eval()

    @to_compiled(layer=net)
    def step(v):
        (net(v) ** 2).mean().backward()
        net.clear_gradients()

    x_np = rng.randn(4, 16).astype("float32")

    def fresh():
        v = to_variable(x_np)
        v.stop_gradient = False
        return v

    step(fresh())
    cached = dict(step._zeros_cache)
    assert cached
    step(fresh())
    assert step.cache_info()["hits"] == 1
    for k, z in step._zeros_cache.items():
        assert z is cached[k]


def test_minimize_skips_gradless_params_like_eager(rng, cpu):
    x, h = rng.randn(4, 16).astype("float32"), rng.randn(4, 32).astype("float32")
    a, b = _mlp(TD), _mlp(TD)
    _clone_params(a, b)
    opt_a, opt_b = (tfluid.optimizer.Momentum(0.1, momentum=0.9, parameter_list=n.parameters())
                    for n in (a, b))
    for net, opt in ((a, opt_a), (b, opt_b)):
        loss = (net.fc1(to_variable(x)) ** 2).mean() + (net.fc2(to_variable(h)) ** 2).mean()
        loss.backward()
        opt.minimize(loss)
        net.clear_gradients()

    @to_compiled(layer=b, optimizer=opt_b)
    def step():
        loss = (b.fc1(to_variable(x)) ** 2).mean()
        loss.backward()
        opt_b.minimize(loss)
        b.clear_gradients()

    for _ in range(3):
        loss = (a.fc1(to_variable(x)) ** 2).mean()
        loss.backward()
        opt_a.minimize(loss)
        a.clear_gradients()
        step()
    assert step.cache_info()["fallbacks"] == 0
    assert _max_param_diff(a, b) < 1e-5


def test_recompile_on_training_flag_flip(rng, cpu):
    net = _convnet(TD)
    compiled = to_compiled(net)
    x = rng.randn(2, 2, 8, 8).astype("float32")
    compiled(to_variable(x))
    net.eval()
    compiled(to_variable(x))
    net.train()
    compiled(to_variable(x))
    info = compiled.cache_info()
    assert info["misses"] == 2 and info["hits"] == 1


def test_forward_only_call_does_not_advance_the_schedule(rng, cpu):
    x = rng.randn(8, 16).astype("float32")
    net = _mlp(TD)
    opt = tfluid.optimizer.SGD(TD.NaturalExpDecay(0.1, 1, 0.5), parameter_list=net.parameters())

    @to_compiled(layer=net, optimizer=opt)
    def train():
        loss = (net(to_variable(x)) ** 2).mean()
        loss.backward()
        opt.minimize(loss)
        net.clear_gradients()

    @to_compiled(layer=net, optimizer=opt)
    def infer(v):
        return net(v)

    for _ in range(3):
        train()
        infer(to_variable(x))
    assert opt._learning_rate.step_num == 3 and opt._dy_step == 3


# -- the fallback contract ----------------------------------------------------


class HostRead(Layer):
    def __init__(self):
        super().__init__("hostread")
        self.fc = Linear(16, 8)

    def forward(self, x):
        h = self.fc(x)
        h.numpy()  # a host read of a traced value
        return h


def test_to_compiled_falls_back_loudly_once(rng, cpu):
    net = HostRead()
    compiled = to_compiled(net)
    x = to_variable(rng.randn(4, 16).astype("float32"))
    want = net(x).numpy()
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        o1, o2 = compiled(x), compiled(x)
    assert len([w for w in log if "falling back to EAGER" in str(w.message)]) == 1
    np.testing.assert_allclose(o1.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(o2.numpy(), want, atol=1e-6)
    info = compiled.cache_info()
    assert info["fallen_back"] and info["fallbacks"] == 1 and info["entries"] == 0


def test_traced_layer_strict_raises_on_host_read(rng, cpu):
    x = to_variable(rng.randn(4, 16).astype("float32"))
    with pytest.raises(UncapturableError, match="numpy"):
        TracedLayer.trace(HostRead(), inputs=[x])


def test_to_compiled_strict_mode_raises(rng, cpu):
    compiled = to_compiled(HostRead(), fallback=False)
    with pytest.raises(UncapturableError, match="trace capture failed"):
        compiled(to_variable(rng.randn(4, 16).astype("float32")))


def test_data_dependent_control_flow_is_loud(rng, cpu):
    class Branchy(Layer):
        def __init__(self):
            super().__init__("branchy")
            self.fc = Linear(16, 8)

        def forward(self, x):
            h = self.fc(x)
            if float(h.numpy().sum()) > 0:
                return h * 2.0
            return h

    with pytest.raises(UncapturableError):
        TracedLayer.trace(Branchy(), inputs=[to_variable(rng.randn(4, 16).astype("float32"))])


def test_gradient_read_inside_the_step_is_loud(rng, cpu):
    net = _mlp(TD)

    @to_compiled(layer=net, fallback=False)
    def step():
        (net(to_variable(np.ones((2, 16), "float32"))) ** 2).mean().backward()
        return net.fc1.weight.gradient()

    with pytest.raises(UncapturableError, match="gradient"):
        step()
    assert all(p.grad is None for p in net.parameters())


def test_grad_accumulation_across_compiled_calls(rng, cpu):
    x = rng.randn(4, 16).astype("float32")
    a, b = _mlp(TD), _mlp(TD)
    a.eval(), b.eval()
    _clone_params(a, b)
    for _ in range(2):
        (a(to_variable(x)) ** 2).mean().backward()

    @to_compiled(layer=b)
    def step():
        (b(to_variable(x)) ** 2).mean().backward()

    step()
    g1 = {n: p.gradient() for n, p in b.named_parameters()}
    step()
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        np.testing.assert_allclose(q.gradient(), p.gradient(), atol=1e-5, err_msg=n)
    step()
    for n, p in b.named_parameters():
        np.testing.assert_allclose(p.gradient(), 3 * g1[n], rtol=1e-4, err_msg=n)
    info = step.cache_info()
    assert info["misses"] == 2 and info["hits"] == 1


def test_duplicate_varbase_arg_accumulates_grads_like_eager(rng, cpu):
    x_np = rng.randn(4, 16).astype("float32")
    net = _mlp(TD)
    net.eval()
    ones = np.ones((16, 8), "float32")
    xe = to_variable(x_np)
    xe.stop_gradient = False
    ((net(xe) + xe @ to_variable(ones)) ** 2).sum().backward()

    @to_compiled(layer=net)
    def step(a, b):
        ((net(a) + b @ to_variable(ones)) ** 2).sum().backward()

    xt = to_variable(x_np)
    xt.stop_gradient = False
    step(xt, xt)
    np.testing.assert_allclose(xt.gradient(), xe.gradient(), atol=1e-4)


def test_closure_varbase_is_threaded_not_baked(rng, cpu):
    net = _mlp(TD)
    net.eval()
    x = to_variable(rng.randn(4, 16).astype("float32"))
    y = to_variable(np.zeros((4, 8), "float32"))

    @to_compiled(layer=net)
    def loss_fn():
        return ((net(x) - y) ** 2).mean()

    first = float(loss_fn().numpy())
    y.set_value(np.full((4, 8), 100.0, "float32"))
    second = float(loss_fn().numpy())
    info = loss_fn.cache_info()
    assert info["hits"] == 1 and info["misses"] == 1
    assert abs(second - first) > 1.0
    want = float(np.mean((net(x).numpy() - y.numpy()) ** 2))
    np.testing.assert_allclose(second, want, rtol=1e-5)


def test_host_data_inside_the_step_is_frozen_at_trace(rng, cpu):
    """to_variable(numpy) inside the step is staged at the first run and
    handed back on later calls, as the JAX bridge freezes it."""
    net = _mlp(TD)
    net.eval()
    data = np.zeros((4, 16), "float32")

    @to_compiled(layer=net)
    def step():
        return net(to_variable(data))

    first = step().numpy()
    data[:] = 5.0
    np.testing.assert_array_equal(step().numpy(), first)
    assert step.cache_info()["hits"] == 1


def test_closure_rebinding_is_loud(rng, cpu):
    net = _mlp(TD)
    net.eval()
    x = to_variable(rng.randn(4, 16).astype("float32"))
    scale = to_variable(np.full((1,), 2.0, "float32"))

    def step(v):
        return net(v) * scale

    compiled = to_compiled(step, layer=net)
    first = compiled(x).numpy()
    scale = to_variable(np.full((1,), 100.0, "float32"))  # noqa: F841 (rebinds the cell)
    want = net(x).numpy() * 100.0
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        out = compiled(x)
    assert any("changed identity" in str(w.message) for w in log)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)
    assert not np.allclose(out.numpy(), first)


def test_stateless_optimizer_skips_a_second_discovery_run(rng, cpu):
    """SGD makes no accumulators: after the first signature found that, a
    later signature runs no discovery pass (the JAX bridge's eval_shape)."""
    net = _mlp(TD)
    net.eval()
    opt = tfluid.optimizer.SGD(0.1, parameter_list=net.parameters())

    @to_compiled(layer=net, optimizer=opt)
    def step(v):
        loss = (net(v) ** 2).mean()
        loss.backward()
        opt.minimize(loss)
        net.clear_gradients()

    step(to_variable(rng.randn(4, 16).astype("float32")))
    (stateless,) = step._opt_stateless.values()
    assert stateless == set(step._params) and step.discovery_runs == 1
    step(to_variable(rng.randn(9, 16).astype("float32")))
    assert step.cache_info()["misses"] == 2 and step.discovery_runs == 1


def test_stateful_optimizer_state_is_made_before_the_step(rng, cpu):
    """Momentum's velocities are found by one discovery run and made as
    zeros before the step is compiled; the second call discovers nothing."""
    net = _mlp(TD)
    opt = tfluid.optimizer.Momentum(0.1, 0.9, parameter_list=net.parameters())

    @to_compiled(layer=net, optimizer=opt)
    def step():
        loss = (net(to_variable(np.ones((2, 16), "float32"))) ** 2).mean()
        loss.backward()
        opt.minimize(loss)
        net.clear_gradients()

    step()
    step()
    assert step.discovery_runs == 1 and len(opt._dy_state) == 4
    assert step.cache_info()["hits"] == 1


def test_identity_hashed_static_arg_is_loud_per_call(rng, cpu):
    class Cfg:
        scale = 1.0

    net = _mlp(TD)
    net.eval()

    @to_compiled(layer=net)
    def step(v, cfg=None):
        out = net(v)
        return out * cfg.scale if cfg is not None else out

    x = to_variable(rng.randn(4, 16).astype("float32"))
    step(x)
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        step(x, Cfg())
    assert any("running THIS call eagerly" in str(w.message) for w in log)
    assert step.cache_info()["fallbacks"] == 1 and not step.cache_info()["fallen_back"]
    step(x)
    assert step.cache_info()["hits"] == 1 and step.cache_info()["misses"] == 1


def test_second_optimizer_in_traced_step_is_loud(rng, cpu):
    g, d = _mlp(TD), _mlp(TD)
    opt_g = tfluid.optimizer.SGD(0.1, parameter_list=g.parameters())
    opt_d = tfluid.optimizer.SGD(0.1, parameter_list=d.parameters())
    x = rng.randn(4, 16).astype("float32")

    @to_compiled(layer=g, optimizer=opt_g)
    def step():
        loss = (g(to_variable(x)) ** 2).mean()
        loss.backward()
        opt_g.minimize(loss)
        g.clear_gradients()
        loss_d = (d(to_variable(x)) ** 2).mean()
        loss_d.backward()
        opt_d.minimize(loss_d)
        d.clear_gradients()

    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        step()
    assert any("falling back to EAGER" in str(w.message) for w in log)
    assert opt_g._dy_step == 1 and opt_d._dy_step == 1
    step()
    assert opt_g._dy_step == 2 and opt_d._dy_step == 2


def test_unbound_layer_in_traced_step_is_loud(rng, cpu):
    g, d = _mlp(TD), _mlp(TD)
    hidden = {"d": d}
    x = rng.randn(4, 16).astype("float32")

    @to_compiled(layer=g)
    def step():
        ((g(to_variable(x)) + hidden["d"](to_variable(x))) ** 2).mean().backward()

    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        step()
    assert any("falling back to EAGER" in str(w.message) for w in log)
    assert all(np.isfinite(p.gradient()).all() for _, p in d.named_parameters())


def test_explicit_layer_still_binds_closure_optimizer(rng, cpu):
    x, y = rng.randn(4, 16).astype("float32"), rng.randn(4, 8).astype("float32")
    net = _mlp(TD)
    opt = tfluid.optimizer.SGD(0.1, parameter_list=net.parameters())

    @to_compiled(layer=net)
    def step():
        loss = ((net(to_variable(x)) - to_variable(y)) ** 2).mean()
        loss.backward()
        opt.minimize(loss)
        net.clear_gradients()
        return loss

    l0 = float(step().numpy())
    for _ in range(5):
        l1 = float(step().numpy())
    info = step.cache_info()
    assert info["fallbacks"] == 0 and info["misses"] == 1 and info["hits"] == 5
    assert l1 < l0 and opt._dy_step == 6


def test_parameter_replacement_after_first_call_is_loud(rng, cpu):
    net = _mlp(TD)
    net.eval()
    compiled = to_compiled(net)
    x = to_variable(rng.randn(4, 16).astype("float32"))
    compiled(x)
    replacement = net.fc2.create_parameter(list(net.fc2.weight.shape))
    replacement.value = torch.zeros_like(net.fc2.weight.value)
    net.fc2.weight = replacement
    want = net(x).numpy()
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        out = compiled(x)
    assert any("state changed after the first compiled call" in str(w.message) for w in log)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)


def test_host_read_of_unbound_concrete_tensor_is_loud(rng, cpu):
    net = _mlp(TD)
    net.eval()
    hidden = {"t": to_variable(np.full((1,), 3.0, "float32"))}

    @to_compiled(layer=net)
    def step(v):
        return net(v) * float(hidden["t"].numpy()[0])

    x = to_variable(rng.randn(4, 16).astype("float32"))
    want = net(x).numpy() * 3.0
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        out = step(x)
    assert any("falling back to EAGER" in str(w.message) for w in log)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)


def test_unbound_layer_forward_only_is_loud(rng, cpu):
    g, d = _mlp(TD), _mlp(TD)
    g.eval(), d.eval()
    hidden = {"d": d}
    x = to_variable(rng.randn(4, 16).astype("float32"))

    @to_compiled(layer=g)
    def step(v):
        return g(v) + hidden["d"](v)

    want = g(x).numpy() + d(x).numpy()
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        out = step(x)
    assert any("falling back to EAGER" in str(w.message) for w in log)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)


def test_traced_layer_rejects_non_layer():
    with pytest.raises(TypeError, match="dygraph Layer"):
        TracedLayer.trace(lambda x: x, inputs=[np.zeros((2, 2))])


def test_to_compiled_requires_a_layer():
    with pytest.raises(ValueError, match="could not find any dygraph"):
        to_compiled(lambda x: x)


def test_traced_layer_strategy_and_export(rng, cpu):
    net = _mlp(TD)
    net.eval()
    _, traced = TracedLayer.trace(net, inputs=[to_variable(rng.randn(2, 16).astype("float32"))])
    traced.set_strategy(object(), object())
    with pytest.raises(NotImplementedError, match="save_dygraph"):
        traced.save_inference_model("unused")


def test_cache_lru_eviction_recompiles_correctly(rng, cpu, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_JIT_CACHE_CAP", "1")
    net = _mlp(TD)
    net.eval()
    compiled = to_compiled(net)
    xa, xb = rng.randn(4, 16).astype("float32"), rng.randn(9, 16).astype("float32")
    e0 = profiler.counters().get("dygraph_jit_cache_evictions", 0)
    ya = compiled(to_variable(xa)).numpy()
    compiled(to_variable(xb))
    info = compiled.cache_info()
    assert info["cap"] == 1 and info["entries"] == 1 and info["evictions"] == 1
    ya2 = compiled(to_variable(xa)).numpy()
    info = compiled.cache_info()
    assert info["misses"] == 3 and info["entries"] == 1 and info["evictions"] == 2
    np.testing.assert_array_equal(ya2, ya)
    assert profiler.counters()["dygraph_jit_cache_evictions"] == e0 + 2


def test_cache_cap_lru_keeps_recently_used(rng, cpu, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_JIT_CACHE_CAP", "2")
    net = _mlp(TD)
    net.eval()
    compiled = to_compiled(net)
    xs = [rng.randn(n, 16).astype("float32") for n in (2, 3, 5)]
    for i in (0, 1, 0, 2):
        compiled(to_variable(xs[i]))
    misses = compiled.cache_info()["misses"]
    compiled(to_variable(xs[0]))
    assert compiled.cache_info()["misses"] == misses and compiled.cache_info()["hits"] >= 2


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_dygraph_jit.py` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # eager and replayed steps compared closely: deterministic algorithms
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with TD.guard(tfluid.CUDAPlace(0)):
            yield
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.gpu
@pytest.mark.parametrize("net,opt_name", [("mlp", "adam"), ("convnet", "momentum"),
                                          ("lstm", "sgd")])
def test_cuda_graph_train_step_matches_eager(card, net, opt_name):
    make, shape = NETS[net]
    x = np.random.RandomState(1).randn(*shape).astype("float32")
    a, b = make(), make()
    _clone_params(a, b)
    mk = {"adam": lambda ps: tfluid.optimizer.Adam(0.01, parameter_list=ps),
          "momentum": lambda ps: tfluid.optimizer.Momentum(0.05, 0.9, parameter_list=ps),
          "sgd": lambda ps: tfluid.optimizer.SGD(0.1, parameter_list=ps)}[opt_name]
    opt_a, opt_b = mk(a.parameters()), mk(b.parameters())

    def body(model, opt, v):
        loss = (model(v) ** 2).mean()
        loss.backward()
        opt.minimize(loss)
        model.clear_gradients()
        return loss

    step = to_compiled(lambda v: body(b, opt_b, v), layer=b, optimizer=opt_b)
    for i in range(4):
        le = float(body(a, opt_a, to_variable(x)).numpy())
        lc = float(step(to_variable(x)).numpy())
        assert abs(le - lc) <= 1e-5 * max(1.0, abs(le)), (i, le, lc)
    rec, = step._cache.values()
    assert rec.graph is not None and step.cache_info()["hits"] == 3
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        np.testing.assert_allclose(q.numpy(), p.numpy(), atol=1e-5, err_msg=n)


@pytest.mark.gpu
def test_cuda_graph_dropout_replays_draw_the_host_keys(card):
    from paddle_tpu_torch.ops import prng

    net = _mlp(TD)
    net.drop = Dropout(0.5)
    compiled = to_compiled(lambda v: net.drop(net(v)), layer=net)
    x = to_variable(np.ones((4, 16), "float32"))
    masks = [compiled(x).numpy() != 0 for _ in range(3)]
    seed = net.drop._seed
    with torch.no_grad():
        plain = net(x).numpy() != 0
    for call, m in enumerate(masks, 1):
        key = prng.fold_in(prng.fold_in(prng.fold_in(prng.key(0), call), seed), 1)
        want = prng.bernoulli_mask(prng.key_tensor(key), 0.5, (4, 8)).numpy()
        np.testing.assert_array_equal(m, want & plain)
    assert not np.array_equal(masks[0], masks[1]) and net.drop._step == 1


@pytest.mark.gpu
def test_cuda_graph_outputs_are_copies_and_eviction_frees(card, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_JIT_CACHE_CAP", "1")
    net = _mlp(TD)
    net.eval()
    compiled = to_compiled(net)
    xa = to_variable(np.ones((4, 16), "float32"))
    ya = compiled(xa)
    keep = ya.numpy().copy()
    compiled(to_variable(np.zeros((4, 16), "float32")))  # same signature
    np.testing.assert_array_equal(ya.numpy(), keep)
    rec, = compiled._cache.values()
    compiled(to_variable(np.ones((9, 16), "float32")))  # evicts
    assert rec.graph is None and compiled.cache_info()["evictions"] == 1


@pytest.mark.gpu
def test_cuda_graph_host_read_falls_back_before_capture(card):
    net = HostRead()
    compiled = to_compiled(net)
    x = to_variable(np.ones((4, 16), "float32"))
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        out = compiled(x)
    assert any("falling back to EAGER" in str(w.message) for w in log)
    np.testing.assert_allclose(out.numpy(), net(x).numpy(), atol=1e-6)


def test_donate_false_raises(cpu):
    """The compiled step updates the layers' own tensors: that is how a
    replayed graph writes its state back, so it cannot be turned off."""
    with pytest.raises(ValueError, match="donate=False"):
        to_compiled(_mlp(TD), donate=False)
