"""The port's contrib Trainer, Inferencer and distributed_batch_reader, held
against the JAX package on the CPU: the cases of the JAX package's contrib
tests. The two Trainers start from one state (the JAX Trainer's startup
values copied into the port's scope); their EndStepEvent losses and
test() metrics agree within rtol 1e-5 (fp32 sums over a few dozen
terms), and an Inferencer of either package reads the params the other's
Trainer saved."""

import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import contrib as tcontrib
from paddle_tpu_torch.scope import to_numpy

W = np.array([[1.0], [2.0], [-1.0], [0.5]], "float32")


def _jax():
    import paddle_tpu as jfluid
    from paddle_tpu import contrib as jcontrib

    return jfluid, jcontrib


def _train_func(fluid):
    def train_func():
        x = fluid.layers.data("x", [4], dtype="float32")
        y = fluid.layers.data("y", [1], dtype="float32")
        pred = fluid.layers.fc(x, 1)
        return fluid.layers.mean(fluid.layers.square_error_cost(pred, y))

    return train_func


def _infer_func(fluid):
    def infer_func():
        x = fluid.layers.data("x", [4], dtype="float32")
        return fluid.layers.fc(x, 1)

    return infer_func


def _reader():
    rng = np.random.RandomState(11)
    batches = []
    for _ in range(8):
        xb = rng.randn(16, 4).astype("float32")
        batches.append(list(zip(xb, xb @ W)))
    return lambda: iter(batches)


def _trainers():
    jfluid, jcontrib = _jax()
    jt = jcontrib.Trainer(_train_func(jfluid), lambda: jfluid.optimizer.SGD(0.05),
                          place=jfluid.CPUPlace())
    tt = tcontrib.Trainer(_train_func(tfluid), lambda: tfluid.optimizer.SGD(0.05),
                          place=tfluid.CPUPlace())
    state = {v.name: np.asarray(jt.scope.get(v.name))
             for v in jt.train_program.list_vars() if v.persistable and jt.scope.has(v.name)}
    assert sorted(state) == sorted(v.name for v in tt.train_program.list_vars()
                                   if v.persistable and tt.scope.has(v.name))
    tfluid.io.set_persistables_from_numpy(tt.scope, state, "cpu")
    return (jfluid, jcontrib, jt), (tfluid, tcontrib, tt)


def test_trainer_and_inferencer_match_jax(tmp_path):
    res = {}
    for fluid, contrib, trainer in _trainers():
        seen = {"epochs": 0, "losses": [], "events": []}

        def handler(event, seen=seen, contrib=contrib):
            seen["events"].append(type(event).__name__)
            if isinstance(event, contrib.BeginEpochEvent):
                seen["epochs"] += 1
            elif isinstance(event, contrib.EndStepEvent):
                seen["losses"].append(float(np.asarray(event.metrics[0]).reshape(-1)[0]))

        trainer.train(3, handler, reader=_reader(), feed_order=["x", "y"])
        metrics = trainer.test(reader=_reader(), feed_order=["x", "y"])
        path = str(tmp_path / f"{fluid.__name__}_params")
        trainer.save_params(path)
        trainer.save_inference_model(str(tmp_path / f"{fluid.__name__}_export"), ["x"], [0])
        res[fluid.__name__] = (seen, metrics, path)
    (jseen, jmetrics, jpath), (tseen, tmetrics, tpath) = (res["paddle_tpu"],
                                                          res["paddle_tpu_torch"])
    assert tseen["epochs"] == jseen["epochs"] == 3
    assert tseen["events"] == jseen["events"]
    assert len(tseen["losses"]) == 24
    np.testing.assert_allclose(tseen["losses"], jseen["losses"], rtol=1e-5)
    assert tseen["losses"][-1] < tseen["losses"][0]
    assert len(tmetrics) == 1
    np.testing.assert_allclose(tmetrics, jmetrics, rtol=1e-5)

    jfluid, jcontrib = _jax()
    xb = np.random.RandomState(3).randn(5, 4).astype("float32")
    outs = {}
    for tag, fluid, contrib, path in (("t<-t", tfluid, tcontrib, tpath),
                                      ("t<-j", tfluid, tcontrib, jpath),
                                      ("j<-t", jfluid, jcontrib, tpath),
                                      ("j<-j", jfluid, jcontrib, jpath)):
        inferencer = contrib.Inferencer(_infer_func(fluid), path, place=fluid.CPUPlace())
        (out,) = inferencer.infer({"x": xb})
        outs[tag] = np.asarray(out)
    assert outs["t<-t"].shape == (5, 1)
    for tag in ("t<-j", "j<-t", "j<-j"):
        np.testing.assert_allclose(outs[tag], outs["t<-t"], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="map"):
        tcontrib.Inferencer(_infer_func(tfluid), tpath, place=tfluid.CPUPlace()).infer(xb)
    # the exported test program serves the trained params
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        prog, feeds, fetch = tfluid.io.load_inference_model(
            str(tmp_path / "paddle_tpu_torch_export"), exe)
        assert feeds == ["x"]
        loss = exe.run(prog, feed={"x": xb, "y": xb @ W}, fetch_list=fetch)[0]
    assert np.isfinite(loss).all()


def test_trainer_stop_matches_jax():
    steps = {}
    for fluid, contrib, trainer in _trainers():
        seen = []

        def handler(event, seen=seen, contrib=contrib, trainer=trainer):
            if isinstance(event, contrib.BeginStepEvent):
                seen.append(event.step)
                if len(seen) >= 2:
                    trainer.stop()

        trainer.train(1, handler, reader=_reader(), feed_order=["x", "y"])
        steps[fluid.__name__] = seen
    assert steps["paddle_tpu_torch"] == steps["paddle_tpu"] == [0, 1]


def test_trainer_without_feed_order_and_unfetched_metrics():
    """feed dicts go to the step as they are; fetch_metrics False fetches
    nothing."""
    _, (_, _, tt) = _trainers()
    metrics = []

    def handler(event):
        if isinstance(event, tcontrib.BeginStepEvent):
            event.fetch_metrics = event.step % 2 == 0
        elif isinstance(event, tcontrib.EndStepEvent):
            metrics.append(len(event.metrics))

    def feeds():
        rs = np.random.RandomState(1)
        for _ in range(4):
            x = rs.randn(8, 4).astype("float32")
            yield {"x": x, "y": x @ W}

    tt.train(1, handler, reader=feeds)
    assert metrics == [1, 0, 1, 0]


def test_trainer_rejects_a_non_optimizer():
    with pytest.raises(TypeError, match="Optimizer"):
        tcontrib.Trainer(_train_func(tfluid), lambda: object(), place=tfluid.CPUPlace())


def test_trainer_param_path_warm_start(tmp_path):
    _, (_, _, tt) = _trainers()
    tt.train(1, lambda e: None, reader=_reader(), feed_order=["x", "y"])
    path = str(tmp_path / "warm")
    tt.save_params(path)
    want = {v.name: to_numpy(tt.scope.get(v.name)) for v in tt.startup_program.list_vars()
            if v.persistable}
    warm = tcontrib.Trainer(_train_func(tfluid), lambda: tfluid.optimizer.SGD(0.05),
                            param_path=path, place=tfluid.CPUPlace())
    for n, a in want.items():
        np.testing.assert_array_equal(to_numpy(warm.scope.get(n)), a, err_msg=n)


def _base_reader():
    for i in range(7):  # 7 batches, 3 trainers -> 2 full groups
        yield [i]


@pytest.mark.parametrize("trainers,trainer_id", [("3", "1"), ("3", "0"), ("3", "2"),
                                                 ("1", "0"), ("2", "1")])
def test_distributed_batch_reader_matches_jax(trainers, trainer_id, monkeypatch):
    from paddle_tpu.contrib.reader import distributed_batch_reader as jdbr
    from paddle_tpu_torch.contrib.reader import distributed_batch_reader as tdbr

    monkeypatch.setenv("PADDLE_TRAINERS_NUM", trainers)
    monkeypatch.setenv("PADDLE_TRAINER_ID", trainer_id)
    got = list(tdbr(_base_reader)())
    assert got == list(jdbr(_base_reader)())
    if (trainers, trainer_id) == ("3", "1"):
        assert got == [[1], [4]]  # every 3rd batch, offset 1; tail dropped
    if trainers == "1":
        assert got == [[i] for i in range(7)]
    monkeypatch.setenv("PADDLE_TRAINER_ID", trainers)
    with pytest.raises(AssertionError):
        tdbr(_base_reader)
