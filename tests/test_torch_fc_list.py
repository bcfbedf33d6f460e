"""`layers.fc` over a list of inputs, held against the JAX package on the
CPU: one `mul` per input (each with its own param_attr when a list is
given), a `sum`, then the bias and the activation.

The Programs (main and startup) must be equal op for op, var names
included. One SGD step from the JAX startup state must give the same
loss, the same grads of every parameter and the same updated parameters,
within atol / rtol 1e-6 (fp32 sums over a few dozen products)."""

import json

import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.scope import to_numpy

TOL = dict(atol=1e-6, rtol=1e-6)


def _build(fluid, param_attr):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        a = fluid.layers.data("a", [5])
        b = fluid.layers.data("b", [3])
        y = fluid.layers.data("y", [4])
        attr = param_attr(fluid) if param_attr else None
        h = fluid.layers.fc([a, b], 4, act="tanh", param_attr=attr)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(h, y))
        fluid.optimizer.SGD(0.5).minimize(loss)
    return main, startup, loss


def _run(fluid, built, feed, state):
    main, startup, loss = built
    params = sorted(v.name for v in main.list_vars()
                    if v.persistable and not v.name.startswith("learning_rate"))
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    tfluid.io.set_persistables_from_numpy(scope, state, "cpu")
    fetch = [loss.name] + [p + "@GRAD" for p in params]
    outs = exe.run(main, feed=dict(feed), fetch_list=fetch, scope=scope)
    get = (lambda n: np.asarray(scope.get(n))) if fluid is not tfluid else (
        lambda n: np.asarray(to_numpy(scope.get(n))))
    return [np.asarray(o) for o in outs], {p: get(p) for p in params}


@pytest.mark.parametrize("param_attr", [
    None,
    lambda fluid: [fluid.ParamAttr(name="wa"), fluid.ParamAttr(name="wb")],
], ids=["shared_attr", "attr_per_input"])
def test_fc_over_a_list_matches_jax(param_attr):
    import paddle_tpu as jfluid

    jb, tb = _build(jfluid, param_attr), _build(tfluid, param_attr)
    assert json.dumps(jb[0].to_dict(), sort_keys=True) == json.dumps(
        tb[0].to_dict(), sort_keys=True)
    assert json.dumps(jb[1].to_dict(), sort_keys=True) == json.dumps(
        tb[1].to_dict(), sort_keys=True)
    types = [op.type for op in tb[0].global_block().ops]
    assert types[:4] == ["mul", "mul", "sum", "elementwise_add"]
    if param_attr is not None:
        assert [op.input("Y")[0] for op in tb[0].global_block().ops[:2]] == ["wa", "wb"]

    scope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jb[1], scope=scope)
    state = {v.name: np.asarray(scope.get(v.name)) for v in jb[0].list_vars()
             if v.persistable}
    rs = np.random.RandomState(0)
    feed = {"a": rs.randn(6, 5).astype(np.float32),
            "b": rs.randn(6, 3).astype(np.float32),
            "y": rs.randn(6, 4).astype(np.float32)}
    jouts, jstate = _run(jfluid, jb, feed, state)
    touts, tstate = _run(tfluid, tb, feed, state)
    assert len(jouts) == len(touts) == 1 + len(jstate)
    for j, t in zip(jouts, touts):
        np.testing.assert_allclose(t, j, **TOL)
    assert sorted(jstate) == sorted(tstate)
    for n in jstate:
        np.testing.assert_allclose(tstate[n], jstate[n], err_msg=n, **TOL)
        assert not np.array_equal(tstate[n], state[n]), n  # the step moved it
