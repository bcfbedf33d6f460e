"""The port's beam search (`paddle_tpu_torch/decoding.py`) against the JAX
package's `paddle_tpu/decoding.py`, on the CPU.

- `beam_search_step` on the same random log-probabilities, scores,
  finished flags and lengths: every output equal (scores within 1e-6),
  with and without an end token and a GNMT length penalty; and the JAX
  test's enumeration invariants (`tests/test_decoding.py:13`).
- `BeamSearchDecoder` over a one-step decoder program (token embedding,
  a tanh recurrence with a constant encoder feed, a vocabulary fc) built
  in each package with the same weights: the same hypotheses, scores
  within 1e-5."""

import importlib
import itertools

import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.decoding import BeamSearchDecoder, beam_search_step


def _jax_decoding():
    return importlib.import_module("paddle_tpu.decoding")


@pytest.mark.parametrize("eos_id, length_penalty", [(2, 0.0), (2, 0.6), (99, 0.0)])
def test_beam_search_step_matches_jax(eos_id, length_penalty):
    jdec = _jax_decoding()
    rs = np.random.RandomState(1)
    b, k, v = 3, 4, 12
    logits = rs.randn(b, k, v).astype(np.float32)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    scores = rs.randn(b, k).astype(np.float32)
    finished = rs.rand(b, k) < 0.3
    lengths = rs.randint(1, 6, (b, k)).astype(np.int64)
    kw = dict(length_penalty=length_penalty, step=5, lengths=lengths)
    got = beam_search_step(logp, scores, finished, k, eos_id, **kw)
    ref = jdec.beam_search_step(logp, scores, finished, k, eos_id, **kw)
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        assert np.asarray(g).dtype == np.asarray(r).dtype
        np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(r, np.float64),
                                   rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="length_penalty needs"):
        beam_search_step(logp, scores, finished, k, eos_id, length_penalty=0.5)


def test_beam_search_step_matches_enumeration():
    """With beam_size == V and a fixed transition table, T steps of
    beam_search_step: scores equal to their paths' sums, sorted, distinct,
    no worse than greedy and no better than the best path."""
    rng = np.random.RandomState(0)
    V, T = 4, 3
    table = rng.randn(T, V, V).astype("float32")  # step, prev_tok, next_tok

    def run_beam(k):
        scores = np.full((1, k), -1e9, np.float32)
        scores[:, 0] = 0.0
        tokens = np.zeros((1, k), np.int64)
        finished = np.zeros((1, k), bool)
        seqs = np.zeros((1, k, T), np.int64)
        for t in range(T):
            logp = np.stack([table[t, tok] for tok in tokens[0]])[None]
            tokens, beam_idx, scores, finished = beam_search_step(
                logp, scores, finished, k, eos_id=V + 10)  # never finishes
            seqs = np.take_along_axis(seqs, beam_idx[:, :, None], axis=1)
            seqs[:, :, t] = tokens
        return seqs[0], scores[0]

    def path_score(p):
        s, prev = 0.0, 0
        for t, tok in enumerate(p):
            s += table[t, prev, tok]
            prev = tok
        return s

    seqs, scores = run_beam(V)
    for i in range(V):
        np.testing.assert_allclose(scores[i], path_score(seqs[i]), atol=1e-5)
    assert (np.diff(scores) <= 1e-6).all()
    assert len({tuple(s) for s in seqs}) == V
    greedy, _ = run_beam(1)
    assert scores[0] >= path_score(greedy[0]) - 1e-5
    best = max(itertools.product(range(V), repeat=T), key=path_score)
    assert scores[0] <= path_score(best) + 1e-5


VOCAB, EMB, HID, BATCH = 16, 8, 12, 3


def _step_program(fluid):
    """tok [b*k, 1] int64, h_prev and enc [b*k, HID] -> logits [b*k, VOCAB]
    and h_new = tanh(fc(emb(tok)) + fc(h_prev) + enc)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        tok = fluid.layers.data("tok", [-1, 1], dtype="int64", append_batch_size=False)
        h_prev = fluid.layers.data("h_prev", [-1, HID], append_batch_size=False)
        enc = fluid.layers.data("enc", [-1, HID], append_batch_size=False)
        emb = fluid.layers.embedding(tok, (VOCAB, EMB),
                                     param_attr=fluid.ParamAttr(name="emb_w"))
        emb = fluid.layers.reshape(emb, [-1, EMB])
        a = fluid.layers.fc(emb, HID, param_attr=fluid.ParamAttr(name="in_w"),
                            bias_attr=fluid.ParamAttr(name="in_b"))
        r = fluid.layers.fc(h_prev, HID, param_attr=fluid.ParamAttr(name="rec_w"),
                            bias_attr=False)
        h_new = fluid.layers.tanh(fluid.layers.elementwise_add(
            fluid.layers.elementwise_add(a, r), enc))
        logits = fluid.layers.fc(h_new, VOCAB, param_attr=fluid.ParamAttr(name="out_w"),
                                 bias_attr=fluid.ParamAttr(name="out_b"))
    return main, startup, logits, h_new


def _weights():
    rs = np.random.RandomState(7)
    return {"emb_w": rs.randn(VOCAB, EMB), "in_w": rs.randn(EMB, HID) * 0.5,
            "in_b": rs.randn(HID) * 0.1, "rec_w": rs.randn(HID, HID) * 0.5,
            "out_w": rs.randn(HID, VOCAB), "out_b": rs.randn(VOCAB) * 0.1}


@pytest.mark.parametrize("length_penalty", [0.0, 0.8])
def test_beam_decoder_matches_jax(length_penalty):
    jfluid = importlib.import_module("paddle_tpu")
    jdec = _jax_decoding()
    rs = np.random.RandomState(5)
    init = {"h_prev": rs.randn(BATCH, HID).astype(np.float32),
            "enc": (0.5 * rs.randn(BATCH, HID)).astype(np.float32)}
    weights = {n: w.astype(np.float32) for n, w in _weights().items()}
    results = []
    for fluid, decoder_cls in ((jfluid, jdec.BeamSearchDecoder), (tfluid, BeamSearchDecoder)):
        main, startup, logits, h_new = _step_program(fluid)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        io = importlib.import_module(fluid.__name__ + ".io")
        if fluid is tfluid:
            io.set_persistables_from_numpy(scope, weights, "cpu")
        else:
            for n, w in weights.items():
                scope.set(n, w)
        dec = decoder_cls(exe, main, token_feed="tok", state_feeds=["h_prev"],
                          logits_fetch=logits.name, state_fetches=[h_new.name],
                          constant_feeds=["enc"], beam_size=3, max_len=6, bos_id=1,
                          eos_id=0, length_penalty=length_penalty, scope=scope)
        results.append(dec(dict(init)))
    (jseqs, jscores), (tseqs, tscores) = results
    assert tseqs.shape == (BATCH, 3, 6) and tscores.shape == (BATCH, 3)
    np.testing.assert_array_equal(tseqs, jseqs)
    np.testing.assert_allclose(tscores, jscores, rtol=1e-5, atol=1e-5)
