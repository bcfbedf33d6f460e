"""paddle_tpu_torch.dygraph on the CPU, held against the JAX package's
dygraph: the same numpy inputs, and weights carried from the JAX
`state_dict()` into the port's `set_dict`.

- The tape: backward against manual grads, accumulation and clearing,
  `no_grad` in its three forms, a second backward (a no-op in both), the
  numpy-style reductions, registration and state_dict, BatchNorm's grads
  through its batch statistics (tests/test_dygraph.py's cases).
- Every layer class of `dygraph.__all__`: output and grads (each
  parameter's and each float input's) against the JAX class, fp32, atol
  and rtol 1e-5 (convolutions 1e-4: another summation order), and the
  buffers a forward moves.
- The three lowerings the port lacked (conv3d_transpose, row_conv,
  sequence_conv) and three more the part-2 classes run
  (bilinear_tensor_product, group_norm, spectral_norm), each through both
  packages' `_run_op` with a cotangent, at attrs the layer cases do not
  reach; tree_conv, the seventh, through its layer case (two trees, one
  padded).
- An MLP and a small ConvNet trained 5 eager steps under SGD, Momentum and
  Adam: losses, parameters, BN statistics and optimizer state within
  1e-5.
- Dropout masks bit-equal to the JAX package's and to the host threefry.
- save_dygraph in one package read by load_dygraph in the other, both
  ways, with the optimizer's state; the learning-rate schedulers equal.

Conv2D and Embedding start from RandomState(0) and other layers from
`hash(full_name)`, which Python salts per process: both packages agree on
initial weights within one process only, so the tests carry them with
set_dict anyway.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import dygraph as TD


def _jax():
    """The JAX package, imported where a test uses it: the `gpu` tests run
    on the card, which has no jax."""
    import paddle_tpu
    from paddle_tpu import dygraph

    return paddle_tpu, dygraph


def _pkgs():
    jfluid, jd = _jax()
    return (("jax", jfluid, jd), ("torch", tfluid, TD))


def _place(name):
    return _jax()[0].CPUPlace() if name == "jax" else tfluid.CPUPlace()


def _np(v):
    return None if v is None else np.asarray(v.numpy() if hasattr(v, "numpy") else v)


def _run_layer(build, inputs, grad_mask=None, cot_seed=0, calls=1):
    """build(D) -> layer, in each package: the JAX layer's weights seeded
    (_seed_weights), the port's set from its state_dict. Each call: forward on `inputs` (float ones with
    grads unless grad_mask says no), loss = sum(out * g) over the outputs,
    backward. -> {pkg: (outputs, param grads, input grads, state)}."""
    res = {}
    for name, fl, D in _pkgs():
        with fl.dygraph.guard(_place(name)):
            layer = build(D)
            if name == "torch":
                layer.set_dict(res["jax"]["state0"])
            else:
                _seed_weights(layer)
            state0 = layer.state_dict()
            for _ in range(calls):
                layer.clear_gradients()
                vs = []
                for i, a in enumerate(inputs):
                    v = D.to_variable(a)
                    if a.dtype.kind == "f" and (grad_mask is None or grad_mask[i]):
                        v.stop_gradient = False
                    vs.append(v)
                out = layer(*vs)
                outs = out if isinstance(out, tuple) else (out,)
                rs = np.random.RandomState(cot_seed)
                loss = None
                for o in outs:
                    term = (o * D.to_variable(rs.randn(*o.shape).astype("float32"))).sum()
                    loss = term if loss is None else loss + term
                loss.backward()
            res[name] = dict(
                state0=state0, outs=[_np(o) for o in outs],
                pgrads={n: p.gradient() for n, p in layer.named_parameters()},
                igrads=[v.gradient() for v in vs], state=layer.state_dict())
    return res


def _assert_same(res, tol=1e-5):
    j, t = res["jax"], res["torch"]
    for a, b in zip(j["outs"], t["outs"]):
        np.testing.assert_allclose(b, a, atol=tol, rtol=tol)
    assert set(j["pgrads"]) == set(t["pgrads"])
    for n in j["pgrads"]:
        if j["pgrads"][n] is None:
            assert t["pgrads"][n] is None, n
            continue
        np.testing.assert_allclose(t["pgrads"][n], j["pgrads"][n], atol=tol, rtol=tol,
                                   err_msg=n)
    for a, b in zip(j["igrads"], t["igrads"]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b, a, atol=tol, rtol=tol)
    assert list(j["state"]) == list(t["state"])
    for n in j["state"]:
        assert t["state"][n].dtype == j["state"][n].dtype, n
        np.testing.assert_allclose(t["state"][n], j["state"][n], atol=tol, rtol=tol,
                                   err_msg=n)


RS = np.random.RandomState(11)


def _seed_weights(model, seed=0):
    """Every parameter from a seeded RandomState, the same in every process:
    the default initializers seed from hash(full_name), which Python salts
    per process. Batch-norm statistics stay as they are."""
    rs = np.random.RandomState(seed)
    state = {}
    for k, v in model.state_dict().items():
        fan = v.shape[0] if v.ndim else 1
        state[k] = v if k.endswith(("_mean", "_variance")) else (
            rs.uniform(-1.0, 1.0, v.shape) / np.sqrt(max(fan, 1))).astype(v.dtype)
    model.set_dict(state)


def _f(*shape, scale=1.0):
    return (scale * RS.randn(*shape)).astype("float32")


# (build, inputs, grad_mask, tol)
LAYER_CASES = {
    **{f"linear_{act}": (lambda D, act=act: D.Linear(6, 5, act=act), [_f(3, 2, 3)], None, 1e-5)
       for act in (None, "relu", "sigmoid", "tanh", "softmax", "gelu")},
    "fc": (lambda D: D.FC(4, 3), [_f(5, 4)], None, 1e-5),
    "conv2d": (lambda D: D.Conv2D(3, 4, 3, stride=2, padding=1, act="relu"),
               [_f(2, 3, 9, 9)], None, 1e-4),
    "conv2d_groups_dilation": (lambda D: D.Conv2D(4, 6, 3, padding=2, dilation=2, groups=2),
                               [_f(2, 4, 8, 8)], None, 1e-4),
    "pool2d_max": (lambda D: D.Pool2D(3, "max", 2, 1), [_f(2, 3, 9, 9)], None, 1e-5),
    "pool2d_max_wide_pad": (lambda D: D.Pool2D(3, "max", 2, 2), [_f(2, 3, 8, 8)], None, 1e-5),
    "pool2d_avg_exclusive": (lambda D: D.Pool2D(3, "avg", 2, 1), [_f(2, 3, 9, 9)], None, 1e-5),
    "pool2d_avg_inclusive": (lambda D: D.Pool2D(3, "avg", 2, 1, exclusive=False),
                             [_f(2, 3, 9, 9)], None, 1e-5),
    "pool2d_avg_wide_pad": (lambda D: D.Pool2D(3, "avg", 2, 2), [_f(2, 3, 8, 8)], None, 1e-5),
    "pool2d_avg_wide_pad_inclusive": (lambda D: D.Pool2D(3, "avg", 2, 2, exclusive=False),
                                      [_f(2, 3, 8, 8)], None, 1e-5),
    "pool2d_global_max": (lambda D: D.Pool2D(pool_type="max", global_pooling=True),
                          [_f(2, 3, 5, 5)], None, 1e-5),
    "pool2d_global_avg": (lambda D: D.Pool2D(pool_type="avg", global_pooling=True),
                          [_f(2, 3, 5, 5)], None, 1e-5),
    "batch_norm_4d": (lambda D: D.BatchNorm(3, act="relu"), [_f(4, 3, 5, 5, scale=3.0)],
                      None, 1e-5),
    "batch_norm_2d": (lambda D: D.BatchNorm(3), [_f(8, 3, scale=3.0) + 2.0], None, 1e-5),
    "embedding": (lambda D: D.Embedding([10, 4], padding_idx=0),
                  [np.array([[1], [0], [3], [9]], "int64")], None, 1e-5),
    "embedding_2d_ids": (lambda D: D.Embedding([10, 4]),
                         [np.array([[1, 2], [0, 7]], "int64")], None, 1e-5),
    "layer_norm": (lambda D: D.LayerNorm(4), [_f(3, 4, scale=2.0)], None, 1e-5),
    "layer_norm_2d_shape": (lambda D: D.LayerNorm([3, 4]), [_f(2, 3, 4)], None, 1e-5),
    "gru_unit": (lambda D: D.GRUUnit(12), [_f(2, 12), _f(2, 4)], None, 1e-5),
    "gru_unit_origin": (lambda D: D.GRUUnit(12, origin_mode=True), [_f(2, 12), _f(2, 4)],
                        None, 1e-5),
    "prelu_all": (lambda D: D.PRelu("all"), [_f(2, 3, 4, 4)], None, 1e-5),
    "prelu_channel": (lambda D: D.PRelu("channel", channel=3), [_f(2, 3, 4, 4)], None, 1e-5),
    "prelu_element": (lambda D: D.PRelu("element", input_shape=[2, 5]), [_f(2, 5)], None,
                      1e-5),
    "nce_uniform": (lambda D: D.NCE(20, 6, num_neg_samples=5, seed=3),
                    [_f(4, 6), np.array([[1], [5], [19], [0]], "int64")], None, 1e-5),
    "nce_log_uniform": (lambda D: D.NCE(20, 6, num_neg_samples=5, sampler="log_uniform",
                                        seed=4),
                        [_f(4, 6), np.array([[2], [3], [11], [7]], "int64")], None, 1e-5),
    "conv2d_transpose": (lambda D: D.Conv2DTranspose(3, 4, 3, stride=2, padding=1, act="relu"),
                         [_f(2, 3, 5, 5)], None, 1e-4),
    "conv3d": (lambda D: D.Conv3D(2, 3, 3, padding=1), [_f(1, 2, 4, 4, 4)], None, 1e-4),
    "conv3d_transpose": (lambda D: D.Conv3DTranspose(3, 2, 2, stride=2),
                         [_f(1, 3, 3, 3, 3)], None, 1e-4),
    "bilinear_tensor_product": (lambda D: D.BilinearTensorProduct(4, 5, 2, act="tanh"),
                                [_f(3, 4), _f(3, 5)], None, 1e-5),
    "sequence_conv": (lambda D: D.SequenceConv(4, 5, filter_size=3), [_f(2, 6, 4)], None,
                      1e-5),
    "sequence_conv_mask": (
        lambda D: D.SequenceConv(4, 5, filter_size=3),
        [_f(2, 6, 4), np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]], "float32")],
        [True, False], 1e-5),
    "row_conv": (lambda D: D.RowConv(5, future_context_size=2, act="relu"), [_f(2, 6, 5)],
                 None, 1e-5),
    "group_norm": (lambda D: D.GroupNorm(4, groups=2), [_f(2, 4, 3, 3, scale=5.0)], None,
                   1e-4),
    "spectral_norm": (lambda D: D.SpectralNorm([6, 4], power_iters=3), [_f(6, 4, scale=3.0)],
                      None, 1e-5),
    # two trees, the second padded with (0, 0) edges
    "tree_conv": (lambda D: D.TreeConv(3, 5, num_filters=2, max_depth=2),
                  [_f(2, 5, 3), np.array([[[1, 2], [1, 3], [3, 4], [3, 5]],
                                          [[1, 2], [2, 3], [0, 0], [0, 0]]], "int32")],
                  None, 1e-5),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_layer_output_and_grads_match_jax(name):
    build, inputs, mask, tol = LAYER_CASES[name]
    _assert_same(_run_layer(build, inputs, mask), tol)


@pytest.mark.parametrize("name", ["batch_norm_4d", "spectral_norm", "nce_uniform"])
def test_layer_state_moves_over_calls_like_jax(name):
    """Three forward/backward calls: BN running stats, spectral-norm u / v
    and the NCE sampler's draws move as the JAX package's do."""
    build, inputs, mask, tol = LAYER_CASES[name]
    _assert_same(_run_layer(build, inputs, mask, calls=3), tol)


def test_batch_norm_eval_uses_running_stats_like_jax():
    x = _f(4, 3, 5, 5, scale=2.0)

    def build(D):
        bn = D.BatchNorm(3)
        with D.no_grad():
            bn(D.to_variable(x + 1.0))  # move the running stats once
        bn.eval()
        return bn

    _assert_same(_run_layer(build, [x]))


# -- the lowerings the part-2 classes run --------------------------------------

OP_CASES = {
    "conv3d_transpose": ({"Input": _f(1, 2, 3, 3, 3), "Filter": _f(2, 3, 3, 3, 3)},
                         {"strides": [2, 2, 2], "paddings": [1, 1, 1],
                          "dilations": [1, 1, 1], "groups": 1}, "Output", None),
    "conv3d_transpose_dilated": ({"Input": _f(1, 2, 3, 4, 3), "Filter": _f(2, 2, 2, 2, 2)},
                                 {"strides": [1, 2, 1], "paddings": [0, 1, 0],
                                  "dilations": [2, 1, 2], "groups": 1}, "Output", None),
    "row_conv": ({"X": _f(2, 5, 3), "Filter": _f(3, 3)}, {}, "Out", None),
    "sequence_conv": ({"X": _f(2, 5, 3), "Filter": _f(9, 4)},
                      {"contextLength": 3, "contextStart": -1}, "Out", None),
    "sequence_conv_mask_offset": (
        {"X": _f(2, 5, 3), "Filter": _f(12, 2),
         "Mask": np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], "float32")},
        {"contextLength": 4, "contextStart": -3}, "Out", None),
    "bilinear_tensor_product": ({"X": _f(3, 4), "Y": _f(3, 5), "Weight": _f(2, 4, 5),
                                 "Bias": _f(2)}, {}, "Out", None),
    "group_norm": ({"X": _f(2, 6, 3, 2, scale=4.0), "Scale": _f(6), "Bias": _f(6)},
                   {"groups": 3, "epsilon": 1e-5}, "Y", ("Y", "Mean", "Variance")),
    "spectral_norm": ({"Weight": _f(4, 3, 2), "U": _f(3), "V": _f(8)},
                      {"dim": 1, "power_iters": 2, "eps": 1e-12}, "Out", None),
}
NO_GRAD_SLOTS = {"Mask", "U", "V"}


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_lowering_and_grad_match_jax(name):
    from paddle_tpu.dygraph.nn import _run_op as jax_run_op
    from paddle_tpu_torch.dygraph.nn import _run_op as torch_run_op

    inputs, attrs, out_slot, out_slots = OP_CASES[name]
    op_type = name.split("_dilated")[0].split("_mask")[0]
    res = {}
    for (pkg, fl, D), run_op in zip(_pkgs(), (jax_run_op, torch_run_op)):
        with fl.dygraph.guard(_place(pkg)):
            vs = {}
            for slot, a in inputs.items():
                v = D.to_variable(a)
                v.stop_gradient = slot in NO_GRAD_SLOTS or a.dtype.kind != "f"
                vs[slot] = v
            out = run_op(op_type, vs, attrs, out_slot, out_slots)
            g = np.random.RandomState(5).randn(*out.shape).astype("float32")
            (out * D.to_variable(g)).sum().backward()
            res[pkg] = (out.numpy(), {s: v.gradient() for s, v in vs.items()})
    np.testing.assert_allclose(res["torch"][0], res["jax"][0], atol=1e-5, rtol=1e-5)
    for s, gj in res["jax"][1].items():
        gt = res["torch"][1][s]
        assert (gj is None) == (gt is None), s
        if gj is not None:
            np.testing.assert_allclose(gt, gj, atol=1e-5, rtol=1e-5, err_msg=s)


# -- the tape (tests/test_dygraph.py's cases, in the port) ---------------------


def test_varbase_backward_matches_manual():
    with TD.guard(tfluid.CPUPlace()):
        x = TD.to_variable(np.array([[1.0, 2.0], [3.0, 4.0]], "float32"))
        x.stop_gradient = False
        y = (x * x + 2.0 * x).astype("float32")
        total = (y * 0.5 * 1.0) @ TD.to_variable(np.ones((2, 1), "float32"))
        total.backward(grad=np.ones((2, 1), "float32"))
        np.testing.assert_allclose(x.gradient(), [[2.0, 3.0], [4.0, 5.0]], atol=1e-6)


def test_gradient_accumulates_clears_and_second_backward_is_a_noop():
    """Grads accumulate over backward calls and clear to None; a second
    backward of the same output adds nothing, in both packages (torch alone
    would raise: the graph's buffers are freed)."""
    got = {}
    for name, fl, D in _pkgs():
        with fl.dygraph.guard(_place(name)):
            x = D.to_variable(np.ones((3,), "float32"))
            x.stop_gradient = False
            for _ in range(2):
                (x * 3.0).backward(grad=np.ones((3,), "float32"))
            twice = x.gradient()
            y = x * x
            y.backward(grad=np.ones((3,), "float32"))
            once = x.gradient()
            y.backward(grad=np.ones((3,), "float32"))
            again = x.gradient()
            x.clear_gradient()
            got[name] = (twice, once, again, x.gradient())
    for g in got.values():
        np.testing.assert_allclose(g[0], 6.0 * np.ones(3))
        np.testing.assert_allclose(g[1], 8.0 * np.ones(3))
        np.testing.assert_allclose(g[2], g[1])
        assert g[3] is None


def test_retain_graph_allows_a_second_backward():
    with TD.guard(tfluid.CPUPlace()):
        x = TD.to_variable(np.array([1.0, 2.0], "float32"))
        x.stop_gradient = False
        y = (x * x).sum()
        y.backward(retain_graph=True)
        y.backward()
        np.testing.assert_allclose(x.gradient(), [4.0, 8.0])


def test_stop_gradient_input_with_a_node_is_skipped_like_jax():
    """An input whose stop_gradient is set is detached even when it was
    computed on the tape: no grad reaches what it came from."""
    got = {}
    for name, fl, D in _pkgs():
        with fl.dygraph.guard(_place(name)):
            x = D.to_variable(np.array([1.0, 2.0, 3.0], "float32"))
            x.stop_gradient = False
            h = x * 2.0
            h.stop_gradient = True
            loss = (h * x).sum()
            loss.backward()
            got[name] = x.gradient()
    np.testing.assert_allclose(got["torch"], got["jax"])
    np.testing.assert_allclose(got["torch"], [2.0, 4.0, 6.0])


class _MLP:
    @staticmethod
    def make(D):
        class MLP(D.Layer):
            def __init__(self):
                super().__init__("mlp")
                self.fc1 = D.Linear(16, 32, act="relu")
                self.fc2 = D.Linear(32, 1)

            def forward(self, x):
                return self.fc2(self.fc1(x))

        return MLP()


def test_layer_registration_and_state_dict():
    with TD.guard(tfluid.CPUPlace()):
        m = _MLP.make(TD)
        assert set(dict(m.named_parameters())) == {"fc1.weight", "fc1.bias", "fc2.weight",
                                                   "fc2.bias"}
        assert len(m.parameters()) == 4
        m2 = _MLP.make(TD)
        m2.set_dict(m.state_dict())
        for (_, p1), (_, p2) in zip(m.named_parameters(), m2.named_parameters()):
            np.testing.assert_array_equal(p1.numpy(), p2.numpy())
        with pytest.raises(KeyError, match="missing"):
            m2.set_dict({"fc1.weight": m.state_dict()["fc1.weight"]})


def test_initial_weights_equal_jax_within_one_process():
    """create_parameter keeps the JAX initializers: hash(full_name) seeds
    (equal within a process), RandomState(0) for Conv2D and Embedding."""
    sds = []
    for name, fl, D in _pkgs():
        with fl.dygraph.guard(_place(name)):
            sds.append((_MLP.make(D).state_dict(), D.Conv2D(3, 4, 3).state_dict(),
                        D.Embedding([7, 3]).state_dict(), D.BatchNorm(3).state_dict()))
    for a, b in zip(*sds):
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])


def test_set_value_writes_in_place():
    """set_value copies into the tensor the VarBase holds when shape and
    dtype match (a captured graph reads that tensor); otherwise it takes a
    new one."""
    with TD.guard(tfluid.CPUPlace()):
        m = _MLP.make(TD)
        held = m.fc2.bias.value
        m.fc2.bias.set_value(np.full((1,), 3.0, "float32"))
        assert m.fc2.bias.value is held and float(held.detach()[0]) == 3.0
        assert held.requires_grad
        m.fc2.bias.set_value(np.zeros((2,), "float32"))
        assert m.fc2.bias.value is not held and m.fc2.bias.shape == (2,)


def test_dygraph_training_converges():
    rng = np.random.RandomState(0)
    w_true = rng.randn(16, 1).astype("float32")
    with TD.guard(tfluid.CPUPlace()):
        m = _MLP.make(TD)
        opt = tfluid.optimizer.Adam(1e-2, parameter_list=m.parameters())
        losses = []
        for _ in range(60):
            xv = rng.randn(64, 16).astype("float32")
            yv = xv @ w_true
            pred = m(TD.to_variable(xv))
            diff = pred - TD.to_variable(yv)
            loss = (diff * diff) * (1.0 / 64)
            loss.backward(grad=np.ones(loss.shape, "float32"))
            opt.minimize(loss)
            m.clear_gradients()
            losses.append(float(np.sum((pred.numpy() - yv) ** 2) / 64))
        assert losses[-1] < losses[0] * 0.1, (losses[0], losses[-1])


def test_dygraph_matches_graph_forward():
    """Same weights -> same forward in dygraph and in a graph Program of the
    port (the reference's imperative-vs-graph equivalence)."""
    from paddle_tpu_torch.framework import Program, program_guard

    xv = np.random.RandomState(1).randn(4, 16).astype("float32")
    with TD.guard(tfluid.CPUPlace()):
        m = _MLP.make(TD)
        dy_out = m(TD.to_variable(xv)).numpy()
        sd = m.state_dict()
    main, startup = Program(), Program()
    with program_guard(main, startup):
        x = tfluid.layers.data("x", [16])
        h = tfluid.layers.fc(x, 32, act="relu")
        out = tfluid.layers.fc(h, 1)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    params = [p.name for p in main.global_block().all_parameters()]
    for name, key in zip(params, ["fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"]):
        scope.set(name, torch.as_tensor(sd[key]))
    (graph_out,) = exe.run(main, feed={"x": xv}, fetch_list=[out], scope=scope)
    np.testing.assert_allclose(dy_out, graph_out, atol=1e-5)


def test_batchnorm_gradients_flow_through_stats():
    xv = np.random.RandomState(3).randn(4, 3).astype("float32")
    with TD.guard(tfluid.CPUPlace()):
        bn = TD.BatchNorm(3)
        x = TD.to_variable(xv)
        x.stop_gradient = False
        bn(x).backward(grad=np.ones_like(xv))
        xt = torch.tensor(xv, requires_grad=True)
        mean = xt.mean(0, keepdim=True)
        var = ((xt - mean) ** 2).mean(0, keepdim=True)
        ((xt - mean) / torch.sqrt(var + 1e-5)).sum().backward()
        np.testing.assert_allclose(x.gradient(), xt.grad.numpy(), atol=1e-4)
        assert len(bn.parameters()) == 2
        assert not np.allclose(bn.state_dict()["_mean"], 0.0)


def test_no_grad_three_forms():
    @TD.no_grad
    def f(v):
        return v * 2.0

    @TD.no_grad()
    def g(v):
        return v * 3.0

    with TD.guard(tfluid.CPUPlace()):
        x = TD.to_variable(np.ones((2,), "float32"))
        x.stop_gradient = False
        assert f(x).stop_gradient and g(x).stop_gradient
        with TD.no_grad():
            y = x * 2.0
        assert y.stop_gradient and y._node is None and not y.value.requires_grad
        z = x * 2.0
        assert not z.stop_gradient and z._node is not None


def test_varbase_numpy_style_reductions():
    x_np = np.arange(12, dtype="float32").reshape(3, 4)
    got = {}
    for name, fl, D in _pkgs():
        with fl.dygraph.guard(_place(name)):
            v = D.to_variable(x_np)
            v.stop_gradient = False
            s, m = v.sum(), v.mean(axis=1)
            mx, mn = v.max(axis=0, keepdim=True), v.min()
            mk = v.mean(keepdim=True)
            (s + m.sum() + mx.sum() + mn + mk.sum()).backward()
            got[name] = [s.numpy(), m.numpy(), mx.numpy(), mn.numpy(), mk.numpy(),
                         v.gradient()]
    for a, b in zip(got["jax"], got["torch"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-6)


def test_varbase_surface_matches_jax():
    for name, fl, D in _pkgs():
        with fl.dygraph.guard(_place(name)):
            v = D.to_variable(np.arange(6, dtype="float64").reshape(2, 3))
            i = D.to_variable(np.arange(3, dtype="int64"))
            assert (v.shape, v.dtype, len(v), i.dtype) == ((2, 3), "float32", 2, "int32")
            assert v.numpy().dtype == np.float32 and i.numpy().dtype == np.int32
            assert v.detach().stop_gradient and repr(v).startswith("VarBase(shape=(2, 3)")
            np.testing.assert_allclose((2.0 - v).numpy(), 2.0 - v.numpy())
            np.testing.assert_allclose((2.0 / (v + 1.0)).numpy(), 2.0 / (v.numpy() + 1.0),
                                       rtol=1e-6)
            np.testing.assert_allclose((-v)[1].numpy(), -v.numpy()[1])
            np.testing.assert_allclose((v ** 2.0).numpy(), v.numpy() ** 2)


def test_guard_place_mode_and_device(monkeypatch):
    assert not TD.enabled() and not tfluid.in_dygraph_mode()
    with TD.guard(tfluid.CPUPlace()):
        assert TD.enabled() and tfluid.in_dygraph_mode()
        assert TD._current_tracer() is not None
        assert TD.to_variable(np.ones(2)).value.device == torch.device("cpu")
        assert TD.Linear(2, 3).weight.value.device == torch.device("cpu")
    assert not TD.enabled()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with TD.guard():
            pass
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.Linear(2, 3)  # outside any guard: cuda:0


def test_parallel_env_and_tracer_match_jax(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "3")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", "10.0.0.1:6170,10.0.0.2:6170")
    monkeypatch.setenv("PADDLE_CURRENT_ENDPOINT", "10.0.0.2:6170")
    envs = [D.ParallelEnv() for D in (_jax()[1], TD)]
    for attr in ("nranks", "local_rank", "dev_id", "current_endpoint", "trainer_endpoints"):
        assert getattr(envs[1], attr) == getattr(envs[0], attr), attr
    tracers = [D.Tracer() for D in (_jax()[1], TD)]
    for t in tracers:
        t.eval_mode()
    assert [t._train_mode for t in tracers] == [False, False]


def test_data_parallel_single_process_and_multi_rank_raises(monkeypatch):
    with TD.guard(tfluid.CPUPlace()):
        m = TD.DataParallel(_MLP.make(TD))
        out = m(TD.to_variable(np.random.randn(4, 16).astype("float32")))
        assert out.shape == (4, 1)
        assert m.scale_loss(out) is out
        m.apply_collective_grads()
        assert len(m.parameters()) == 4
        assert TD.prepare_context().nranks == 1
        # more ranks need the PADDLE_* contract's endpoints (or a process
        # group the caller initialized); without either both raise
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
        with pytest.raises(RuntimeError, match="PADDLE_TRAINER_ENDPOINTS is empty"):
            TD.prepare_context()
        with pytest.raises(RuntimeError, match="call prepare_context"):
            TD.DataParallel(_MLP.make(TD)).apply_collective_grads()


# -- training against the JAX package ------------------------------------------


def _convnet(D):
    class ConvNet(D.Layer):
        def __init__(self):
            super().__init__("convnet")
            self.conv = D.Conv2D(2, 4, 3, padding=1, act="relu")
            self.bn = D.BatchNorm(4)
            self.pool = D.Pool2D(pool_size=2, pool_type="max", pool_stride=2)
            self.fc = D.Linear(4 * 4 * 4, 1)

        def forward(self, x):
            return self.fc(self.pool(self.bn(self.conv(x))))

    return ConvNet()


OPTS = {
    "sgd": lambda fl, ps: fl.optimizer.SGD(0.005, parameter_list=ps),
    "momentum": lambda fl, ps: fl.optimizer.Momentum(0.002, 0.9, parameter_list=ps),
    "adam": lambda fl, ps: fl.optimizer.Adam(0.01, parameter_list=ps),
}


@pytest.mark.parametrize("net", ["mlp", "convnet"])
@pytest.mark.parametrize("opt_name", sorted(OPTS))
def test_five_steps_match_jax(net, opt_name):
    """From seeded weights, at learning rates where the 5 steps descend: at
    SGD 0.02 from one process's hash-seeded weights the ConvNet's loss swung
    9.7 -> 59.8 -> 7.7 -> 22.1 and the two packages' rounding grew to
    1.1e-5 of it by the fourth step."""
    rs = np.random.RandomState(2)
    x = rs.randn(4, 16).astype("float32") if net == "mlp" else rs.randn(4, 2, 8, 8).astype(
        "float32")
    y = rs.randn(4, 1).astype("float32")
    res = {}
    for name, fl, D in _pkgs():
        with fl.dygraph.guard(_place(name)):
            model = _MLP.make(D) if net == "mlp" else _convnet(D)
            if name == "torch":
                model.set_dict(res["jax"][3])
            else:
                _seed_weights(model)
            sd0 = model.state_dict()
            opt = OPTS[opt_name](fl, model.parameters())
            losses = []
            for _ in range(5):
                loss = ((model(D.to_variable(x)) - D.to_variable(y)) ** 2).mean()
                loss.backward()
                opt.minimize(loss)
                model.clear_gradients()
                losses.append(float(loss.numpy()))
            res[name] = (losses, model.state_dict(), opt.state_dict(), sd0)
    np.testing.assert_allclose(res["torch"][0], res["jax"][0], rtol=1e-5)
    for part in (1, 2):
        a, b = res["jax"][part], res["torch"][part]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], atol=1e-5, rtol=1e-5, err_msg=k)
    assert int(res["torch"][2]["@step"]) == 5


@pytest.mark.parametrize("cls", ["AdamW", "Lamb"])
def test_adamw_and_lamb_take_adams_dygraph_rule_as_in_jax(cls):
    rs = np.random.RandomState(4)
    x, y = rs.randn(4, 16).astype("float32"), rs.randn(4, 1).astype("float32")
    res = {}
    for name, fl, D in _pkgs():
        with fl.dygraph.guard(_place(name)):
            model = _MLP.make(D)
            if name == "torch":
                model.set_dict(res["jax"][1])
            else:
                _seed_weights(model)
            sd0 = model.state_dict()
            opt = getattr(fl.optimizer, cls)(0.01, parameter_list=model.parameters())
            for _ in range(2):
                loss = ((model(D.to_variable(x)) - D.to_variable(y)) ** 2).mean()
                loss.backward()
                opt.minimize(loss)
                model.clear_gradients()
            res[name] = (model.state_dict(), sd0)
    for k, a in res["jax"][0].items():
        np.testing.assert_allclose(res["torch"][0][k], a, atol=1e-5, rtol=1e-5)


def test_minimize_needs_a_parameter_list_and_skips_gradless():
    with TD.guard(tfluid.CPUPlace()):
        m = _MLP.make(TD)
        loss = (m.fc1(TD.to_variable(np.ones((2, 16), "float32"))) ** 2).mean()
        loss.backward()
        with pytest.raises(ValueError, match="parameter_list"):
            tfluid.optimizer.SGD(0.1).minimize(loss)
        opt = tfluid.optimizer.Momentum(0.1, 0.9, parameter_list=m.parameters())
        before = m.fc2.weight.numpy().copy()
        _, updated = opt.minimize(loss)
        assert len(updated) == 2 and np.array_equal(m.fc2.weight.numpy(), before)
        assert m.fc1.weight.value.requires_grad and m.fc1.weight.value.grad_fn is None


# -- dropout ---------------------------------------------------------------------


@pytest.mark.parametrize("p,shape", [(0.5, (4, 16)), (0.1, (2, 3, 5, 7)), (0.9, (1000,))])
def test_dropout_masks_bit_equal_jax_and_host_threefry(p, shape):
    from paddle_tpu_torch.ops import prng

    x = np.ones(shape, "float32")
    masks = {}
    for name, fl, D in _pkgs():
        with fl.dygraph.guard(_place(name)):
            drop = D.Dropout(p)
            masks[name] = [drop(D.to_variable(x)).numpy() != 0 for _ in range(3)]
            seed = drop._seed
            drop.eval()
            assert drop(D.to_variable(x)).numpy().min() == 1.0
    n = int(np.prod(shape))
    for step in range(3):
        np.testing.assert_array_equal(masks["torch"][step], masks["jax"][step])
        bits = np.asarray(prng.random_bits(prng.fold_in(prng.key(seed), step + 1), n),
                          np.uint32)
        u = ((bits >> 9) | 0x3F800000).view(np.float32) - 1.0
        np.testing.assert_array_equal(masks["torch"][step].reshape(-1), u < 1.0 - p)
    assert not np.array_equal(masks["torch"][0], masks["torch"][1])


def test_dropout_scales_kept_values_like_jax():
    x = np.random.RandomState(6).randn(3, 8).astype("float32")
    outs = {}
    for name, fl, D in _pkgs():
        with fl.dygraph.guard(_place(name)):
            v = D.to_variable(x)
            v.stop_gradient = False
            out = D.Dropout(0.25)(v)
            out.sum().backward()
            outs[name] = (out.numpy(), v.gradient())
    np.testing.assert_allclose(outs["torch"][0], outs["jax"][0], rtol=1e-6)
    np.testing.assert_allclose(outs["torch"][1], outs["jax"][1], rtol=1e-6)


# -- checkpoints and schedulers --------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_save_dygraph_read_by_the_other_package(writer, tmp_path):
    rs = np.random.RandomState(8)
    x, y = rs.randn(4, 2, 8, 8).astype("float32"), rs.randn(4, 1).astype("float32")
    states = {}
    for name, fl, D in _pkgs():
        with fl.dygraph.guard(_place(name)):
            model = _convnet(D)
            params = model.parameters()
            for i, p in enumerate(params):
                p.name = f"p{i}"
            opt = fl.optimizer.Adam(0.01, parameter_list=params)
            if name == writer:
                for _ in range(2):
                    loss = ((model(D.to_variable(x)) - D.to_variable(y)) ** 2).mean()
                    loss.backward()
                    opt.minimize(loss)
                    model.clear_gradients()
                D.save_dygraph(model.state_dict(), str(tmp_path / "ck"), optimizer=opt)
                states["written"] = (model.state_dict(), opt.state_dict())
            states[name] = (model, opt, D)
    reader = "torch" if writer == "jax" else "jax"
    model, opt, D = states[reader]
    with _jax()[0].dygraph.guard(_place(reader)) if reader == "jax" else \
            TD.guard(tfluid.CPUPlace()):
        params, opt_state = D.load_dygraph(str(tmp_path / "ck"))
        model.set_dict(params)
        opt.set_state_dict(opt_state)
        sd, osd = model.state_dict(), opt.state_dict()
    want_sd, want_osd = states["written"]
    assert list(sd) == list(want_sd) and sorted(osd) == sorted(want_osd)
    for k in want_sd:
        np.testing.assert_array_equal(sd[k], want_sd[k])
    for k in want_osd:
        np.testing.assert_array_equal(osd[k], want_osd[k])
    assert int(osd["@step"]) == 2


def test_save_load_persistables_and_optimizer_only(tmp_path):
    with TD.guard(tfluid.CPUPlace()):
        m = _MLP.make(TD)
        opt = tfluid.optimizer.Momentum(0.1, 0.9, parameter_list=m.parameters())
        loss = (m(TD.to_variable(np.ones((2, 16), "float32"))) ** 2).mean()
        loss.backward()
        opt.minimize(loss)
        TD.save_persistables(m.state_dict(), str(tmp_path / "d"), optimizers=opt)
        got = TD.load_persistables(str(tmp_path / "d"))
        for k, v in m.state_dict().items():
            np.testing.assert_array_equal(got[k], v)
        TD.save_dygraph(opt.state_dict(), str(tmp_path / "o"))
        params, ost = TD.load_dygraph(str(tmp_path / "o"))
        assert params is None and int(ost["@step"]) == 1
        with pytest.raises(FileNotFoundError):
            TD.load_dygraph(str(tmp_path / "none"))
    # the JAX package reads the port's optimizer-only archive and its
    # persistables too
    params, ost_j = _jax()[1].load_dygraph(str(tmp_path / "o"))
    assert params is None and sorted(ost_j) == sorted(ost)
    got_j = _jax()[1].load_persistables(str(tmp_path / "d"))
    assert sorted(got_j) == sorted(got)
    for k in got:
        np.testing.assert_array_equal(got_j[k], got[k])


SCHEDULERS = {
    "PiecewiseDecay": lambda D: D.PiecewiseDecay([3, 6], [0.1, 0.01, 0.001], 0),
    "NaturalExpDecay": lambda D: D.NaturalExpDecay(0.1, 2, 0.5, staircase=True),
    "ExponentialDecay": lambda D: D.ExponentialDecay(0.1, 3, 0.9),
    "InverseTimeDecay": lambda D: D.InverseTimeDecay(0.1, 2, 0.5),
    "PolynomialDecay": lambda D: D.PolynomialDecay(0.1, 5, cycle=True),
    "PolynomialDecay_nocycle": lambda D: D.PolynomialDecay(0.1, 5, power=2.0),
    "CosineDecay": lambda D: D.CosineDecay(0.1, 2, 5),
    "NoamDecay": lambda D: D.NoamDecay(512, 4),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_lr_schedulers_equal_jax(name):
    j, t = SCHEDULERS[name](_jax()[1]), SCHEDULERS[name](TD)
    assert [j() for _ in range(12)] == [t() for _ in range(12)]
    assert j.step_num == t.step_num


def test_scheduler_drives_the_eager_optimizer_like_jax():
    rs = np.random.RandomState(9)
    x, y = rs.randn(4, 16).astype("float32"), rs.randn(4, 1).astype("float32")
    res = {}
    for name, fl, D in _pkgs():
        with fl.dygraph.guard(_place(name)):
            m = _MLP.make(D)
            if name == "torch":
                m.set_dict(res["jax"][1])
            else:
                _seed_weights(m)
            sd0 = m.state_dict()
            opt = fl.optimizer.SGD(D.NaturalExpDecay(0.1, 1, 0.5), parameter_list=m.parameters())
            for _ in range(3):
                loss = ((m(D.to_variable(x)) - D.to_variable(y)) ** 2).mean()
                loss.backward()
                opt.minimize(loss)
                m.clear_gradients()
            res[name] = (m.state_dict(), sd0, opt._learning_rate.step_num)
    assert res["torch"][2] == res["jax"][2] == 3
    for k, a in res["jax"][0].items():
        np.testing.assert_allclose(res["torch"][0][k], a, atol=1e-6, rtol=1e-6)


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_dygraph.py` on the card")
    # full fp32 on the card (no TF32), as the CPU computes it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_cuda_layer_matches_cpu(name, cuda_device):
    """Each layer class on the card against the port on the CPU, output and
    grads within 1e-4."""
    build, inputs, mask, _ = LAYER_CASES[name]
    res = {}
    for place in (tfluid.CPUPlace(), tfluid.CUDAPlace(0)):
        with TD.guard(place):
            layer = build(TD)
            if "cpu" in res:
                layer.set_dict(res["cpu"][0])
            sd = layer.state_dict()
            vs = []
            for i, a in enumerate(inputs):
                v = TD.to_variable(a)
                if a.dtype.kind == "f" and (mask is None or mask[i]):
                    v.stop_gradient = False
                vs.append(v)
            out = layer(*vs)
            outs = out if isinstance(out, tuple) else (out,)
            sum(o.sum() for o in outs).backward()
            res[place.torch_device().type] = (
                sd, [o.numpy() for o in outs],
                [p.gradient() for p in layer.parameters()], [v.gradient() for v in vs])
    for a, b in zip(res["cpu"][1:], res["cuda"][1:]):
        for x, y in zip(a, b):
            if x is not None:
                np.testing.assert_allclose(y, x, atol=1e-4, rtol=1e-4)
