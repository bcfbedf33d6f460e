"""The port's KV caches (paddle_tpu_torch/inference/kv_cache.py) and toy
decode model (decode_model.py) on the CPU.

- Admission, eviction, the deadline shed and the counters of RingKVCache
  and PagedKVCache: the same call sequence through both packages, with
  equal host-side state (lengths, page tables, free lists, active and
  finished sets) and equal counters.
- `decode_step` alone and the ring and paged batchers, **teacher-forced**
  against the JAX `ToyDecodeModel`: the same tokens fed to both each
  step, logits compared step by step within rtol 1e-5 / atol 1e-6 (the
  JAX package's decode gate), at the JAX toy's width (1 head of 4) and
  at two multi-head widths (4 heads of 8; 12 of 64, BERT-base's, where
  atol is 1e-5 of the largest value). Free-running token sequences are not
  compared: the JAX side's own rounding can fork them. The JAX batchers
  are driven through their jitted step (`_fn`) with copied host
  arrays: their own `step` hands `jnp.asarray(cache.lengths)` to an
  asynchronous dispatch and then increments `cache.lengths` in place,
  and on the CPU `jnp.asarray` can alias the numpy buffer, so a step
  still queued (the first one, behind its compile) reads the lengths of
  the next step (`_jax_batcher_step`).
- Bit-equality within the port only: paged against ring, a stream solo
  against the same stream beside others, release then reacquire.

torch runs on one intra-op thread here (autouse fixture). Every wait is
bounded. The `gpu` test (`python -m pytest -m gpu --noconftest
tests/test_torch_kv_cache.py` on the card) runs the wide toy's paged step
on the card against the CPU, and paged against ring bit for bit there.
"""

import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference.decode_model import ToyDecodeModel, make_toy_decode_weights
from paddle_tpu_torch.inference.kv_cache import (
    DecodeStepBatcher, PagedDecodeStepBatcher, PagedKVCache, RingKVCache)

SLOTS, MAX_LEN, HEADS, DIM = 3, 8, 1, 4
VOCAB = 11
TF_TOL = dict(rtol=1e-5, atol=1e-6)
# (heads, head_dim, vocab) of the teacher-forced comparisons with the JAX
# package: its own toy width, and multi-head widths (BERT-base's 12 x 64
# among them) where the head split and the 1/sqrt(head_dim) scaling show
GEOMS = [pytest.param((1, 4, 11), id="h1d4"), pytest.param((4, 8, 37), id="h4d8"),
         pytest.param((12, 64, 97), id="h12d64")]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_kv():
    from paddle_tpu.inference import decode_model, kv_cache

    return kv_cache, decode_model


def _model(seed=7, device="cpu"):
    return ToyDecodeModel(make_toy_decode_weights(seed=seed), device=device)


def _geom_weights(geom):
    heads, dim, vocab = geom
    return make_toy_decode_weights(seed=7, vocab=vocab, num_heads=heads, head_dim=dim)


def _assert_tf(actual, desired, geom, err_msg=""):
    """The decode gate, TF_TOL. At BERT-base's width the fp32 sums run
    over 768 products in two orders (MKL, XLA), about 1e-6 of the largest
    value apart (measured), so there atol is 1e-5 of the largest, the
    card's gate; a head-layout or scaling fault moves values by O(1)."""
    tol = dict(TF_TOL)
    if geom[0] * geom[1] > 32:
        tol["atol"] = 1e-5 * float(np.abs(desired).max())
    np.testing.assert_allclose(actual, desired, err_msg=err_msg, **tol)


def _host_state(cache):
    state = {"lengths": np.asarray(cache.lengths).tolist(),
             "active": dict(cache._active), "finished": list(cache._finished.items()),
             "counters": cache.counters.snapshot()}
    if hasattr(cache, "page_table"):
        state.update(page_table=np.asarray(cache.page_table).tolist(),
                     free_pages=sorted(cache._free_pages),
                     free_slots=sorted(cache._free_slots),
                     pages_of={k: list(v) for k, v in cache._pages_of.items()})
    else:
        state["free"] = sorted(cache._free)
    return state


# -- admission gate, both packages ----------------------------------------------


def _ring_sequence(cache):
    """The JAX test's admission / eviction script -> the slots and sheds
    it saw."""
    seen = [cache.acquire("seq-a"), cache.acquire("seq-b"), cache.acquire("seq-c")]
    cache.mark_finished(seen[0])
    seen.append(cache.seq_id(seen[0]))
    seen.append(cache.acquire("seq-d"))
    cache.release(seen[1])
    cache.release(seen[4])
    with pytest.raises(KeyError):
        cache.release(seen[1])
    with pytest.raises(KeyError):
        cache.mark_finished(seen[1])
    return seen


def test_ring_admission_eviction_and_counters_match_jax():
    jkv, _ = _jax_kv()
    jcache = jkv.RingKVCache(2, MAX_LEN, HEADS, DIM)
    tcache = RingKVCache(2, MAX_LEN, HEADS, DIM, device="cpu")
    assert _ring_sequence(tcache) == _ring_sequence(jcache) == [0, 1, None, "seq-a", 0]
    assert _host_state(tcache) == _host_state(jcache)
    c = tcache.counters.snapshot()
    assert c["kv_evictions"] == 1 and c["kv_admission_sheds"] == 1
    assert c["kv_slot_releases"] == 2 and c["kv_slots_inflight"] == 0


def _paged_sequence(cache):
    slots = [cache.acquire(f"s{i}", total_len=4) for i in range(4)]
    seen = list(slots) + [cache.free_pages(), cache.acquire("s4", total_len=4)]
    cache.mark_finished(slots[1])
    seen.append(cache.acquire("s5", total_len=4))
    cache.mark_finished(slots[0])
    cache.mark_finished(slots[2])
    seen.append(cache.acquire("s6", total_len=8))
    seen.append(_host_state(cache))
    for s in (slots[3], seen[6], seen[7]):
        cache.release(s)
    with pytest.raises(KeyError):
        cache.release(seen[7])
    seen.append(cache.free_pages())
    return seen


def test_paged_admission_eviction_and_counters_match_jax():
    jkv, _ = _jax_kv()
    jcache = jkv.PagedKVCache(4, 4, 2, HEADS, DIM, max_streams=8)
    tcache = PagedKVCache(4, 4, 2, HEADS, DIM, max_streams=8, device="cpu")
    tseen, jseen = _paged_sequence(tcache), _paged_sequence(jcache)
    assert tseen == jseen
    assert tseen[4] == 0 and tseen[5] is None and tseen[-1] == 4
    assert _host_state(tcache) == _host_state(jcache)
    c = tcache.counters.snapshot()
    assert c["kv_page_evictions"] == 3 and c["kv_evictions"] == 3
    assert c["kv_pages_in_use"] == 0 and c["kv_page_allocs"] == 7


@pytest.mark.parametrize("paged", [False, True])
def test_admission_window_waits_for_release_and_deadline_sheds(paged):
    """A waiter inside its budget gets the slot a release frees; a caller
    whose deadline cannot afford the window, or has passed, sheds at once."""
    if paged:
        cache = PagedKVCache(1, 4, 1, HEADS, DIM, max_streams=1, admission_window_s=30.0,
                             device="cpu")
        acquire = lambda name, **kw: cache.acquire(name, total_len=4, **kw)  # noqa: E731
    else:
        cache = RingKVCache(1, MAX_LEN, HEADS, DIM, admission_window_s=30.0, device="cpu")
        acquire = cache.acquire
    s0 = acquire("holder")
    t0 = time.monotonic()
    assert acquire("tight", deadline=t0 + 0.05) is None
    assert acquire("late", deadline=t0 - 1.0) is None
    assert time.monotonic() - t0 < 5.0
    assert cache.counters.snapshot()["kv_admission_sheds"] == 2
    got = {}
    t = threading.Thread(target=lambda: got.update(
        slot=acquire("patient", deadline=time.monotonic() + 60.0)), daemon=True)
    t.start()
    deadline = time.monotonic() + 20.0
    while not cache._cv._waiters and time.monotonic() < deadline:
        time.sleep(0.005)
    cache.release(s0)
    t.join(timeout=20)
    assert not t.is_alive() and got.get("slot") == s0


# -- teacher-forced against the JAX decode model --------------------------------


@pytest.mark.parametrize("geom", GEOMS)
def test_decode_step_matches_jax(geom):
    """One decode_step from the same cache state, lengths (one wrapped)
    and mask: logits and the written blocks within the decode gate."""
    _, jdm = _jax_kv()
    import jax.numpy as jnp

    heads, dim, vocab = geom
    weights = _geom_weights(geom)
    rs = np.random.RandomState(5)
    k = rs.randn(4, MAX_LEN, heads, dim).astype(np.float32)
    v = rs.randn(4, MAX_LEN, heads, dim).astype(np.float32)
    tokens = rs.randint(0, vocab, 4).astype(np.int32)
    lengths = np.array([0, 3, 7, 12], np.int32)
    mask = np.array([True, True, False, True])
    jl, jk, jv = jdm.ToyDecodeModel(weights).decode_step(
        jnp.asarray(tokens), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        jnp.asarray(mask))
    tl, tk, tv = ToyDecodeModel(weights, device="cpu").decode_step(
        torch.as_tensor(tokens.astype(np.int64)), torch.as_tensor(k.copy()),
        torch.as_tensor(v.copy()), torch.as_tensor(lengths.astype(np.int64)),
        torch.as_tensor(mask))
    _assert_tf(tl.numpy(), np.asarray(jl), geom)
    _assert_tf(tk.numpy(), np.asarray(jk), geom)
    _assert_tf(tv.numpy(), np.asarray(jv), geom)
    # the inactive slot's rows are untouched, bit for bit
    assert np.array_equal(tk.numpy()[2], k[2]) and np.array_equal(tv.numpy()[2], v[2])


def _jax_batcher_step(batcher, cache, tokens, paged):
    """The JAX DecodeStepBatcher / PagedDecodeStepBatcher step, with its
    data arguments copied (jnp.array) before the host mirror moves on."""
    import jax.numpy as jnp

    mask = cache.active_mask()
    table = [jnp.array(cache.page_table)] if paged else []
    out, cache.k, cache.v = batcher._fn(jnp.array(tokens), cache.k, cache.v, *table,
                                        jnp.array(cache.lengths), jnp.array(mask))
    out = np.array(out)
    cache.lengths[mask] += 1
    cache.counters.bump("kv_decode_steps")
    return out


def _staggered(cache, step_fn, toks, starts, total_lens, paged):
    """Drive `len(toks[0])` steps, stream i admitted at step starts[i]
    and fed toks[i] from there -> {stream: [logits a step]}."""
    slots, outs = {}, {i: [] for i in toks}
    S = cache.max_streams if paged else cache.num_slots
    for step in range(len(toks[0])):
        for i, at in starts.items():
            if at == step:
                slots[i] = (cache.acquire(f"s{i}", total_len=total_lens[i]) if paged
                            else cache.acquire(f"s{i}"))
        tokens = np.zeros((S,), np.int32)
        for i, slot in slots.items():
            tokens[slot] = toks[i][step - starts[i]]
        out = step_fn(tokens)
        for i, slot in slots.items():
            outs[i].append(np.array(out[slot]))
    return outs, slots


TOKS = {i: np.random.RandomState(11 + i).randint(0, VOCAB, 12).tolist() for i in range(3)}
STARTS = {0: 0, 1: 2, 2: 5}
TOTALS = {0: 12, 1: 10, 2: 7}


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("paged", [False, True])
def test_batched_decode_teacher_forced_matches_jax(paged, geom):
    """Three streams admitted at steps 0, 2, 5, 12 steps (the rings wrap
    at 8): the port's batcher against the JAX batcher on the same tokens,
    logits within the decode gate at every step."""
    jkv, jdm = _jax_kv()
    heads, dim, vocab = geom
    weights = _geom_weights(geom)
    jmodel = jdm.ToyDecodeModel(weights)
    tmodel = ToyDecodeModel(weights, device="cpu")
    toks = {i: np.random.RandomState(11 + i).randint(0, vocab, 12).tolist() for i in range(3)}
    if paged:
        jc = jkv.PagedKVCache(16, 4, MAX_LEN // 4, heads, dim, max_streams=SLOTS)
        tc = PagedKVCache(16, 4, MAX_LEN // 4, heads, dim, max_streams=SLOTS, device="cpu")
        jb, tb = jkv.PagedDecodeStepBatcher(jc, jmodel.decode_step), PagedDecodeStepBatcher(
            tc, tmodel.decode_step)
    else:
        jc = jkv.RingKVCache(SLOTS, MAX_LEN, heads, dim)
        tc = RingKVCache(SLOTS, MAX_LEN, heads, dim, device="cpu")
        jb, tb = jkv.DecodeStepBatcher(jc, jmodel.decode_step), DecodeStepBatcher(
            tc, tmodel.decode_step)
    jout, jslots = _staggered(jc, lambda t: _jax_batcher_step(jb, jc, t, paged), toks,
                              STARTS, TOTALS, paged)
    tout, tslots = _staggered(tc, tb.step, toks, STARTS, TOTALS, paged)
    assert tslots == jslots
    for i in toks:
        for step, (t, j) in enumerate(zip(tout[i], jout[i])):
            _assert_tf(t, j, geom, err_msg=f"stream {i} step {step}")
    assert np.array_equal(tc.lengths, jc.lengths)
    assert tc.counters.snapshot() == jc.counters.snapshot()


@pytest.mark.parametrize("geom", GEOMS)
def test_prefill_matches_jax(geom):
    _, jdm = _jax_kv()
    heads, dim, _ = geom
    weights = _geom_weights(geom)
    prompt = np.array([3, 1, 4, 1, 5, 9, 2], np.int32)
    jk, jv, jn, jlast = jdm.ToyDecodeModel(weights).prefill(prompt)
    tk, tv, tn, tlast = ToyDecodeModel(weights, device="cpu").prefill(prompt)
    assert (tn, tlast) == (jn, jlast) == (6, 2)
    assert tk.dtype == np.float32 and tk.shape == (6, heads, dim)
    _assert_tf(tk, np.asarray(jk), geom)
    _assert_tf(tv, np.asarray(jv), geom)


# -- bit-equality within the port -----------------------------------------------


def test_paged_decode_bitwise_equals_ring():
    model = _model()
    ring = RingKVCache(SLOTS, MAX_LEN, HEADS, DIM, device="cpu")
    paged = PagedKVCache(16, 4, MAX_LEN // 4, HEADS, DIM, max_streams=SLOTS, device="cpu")
    rout, _ = _staggered(ring, DecodeStepBatcher(ring, model.decode_step).step, TOKS, STARTS,
                         TOTALS, False)
    pout, _ = _staggered(paged, PagedDecodeStepBatcher(paged, model.decode_step).step, TOKS,
                         STARTS, TOTALS, True)
    for i in TOKS:
        for step, (r, p) in enumerate(zip(rout[i], pout[i])):
            assert r.tobytes() == p.tobytes(), f"stream {i} step {step}"
    assert list(paged.lengths) == list(ring.lengths)


def test_stream_solo_bitwise_equals_beside_others():
    """A stream decoded alone (in slot 0) equals, bit for bit, the same
    stream decoded in its slot beside two others admitted at other
    steps."""
    model = _model()
    cache = RingKVCache(SLOTS, MAX_LEN, HEADS, DIM, device="cpu")
    together, slots = _staggered(cache, DecodeStepBatcher(cache, model.decode_step).step, TOKS,
                                 STARTS, TOTALS, False)
    for i in TOKS:
        solo_cache = RingKVCache(SLOTS, MAX_LEN, HEADS, DIM, device="cpu")
        n = len(TOKS[i]) - STARTS[i]
        solo, _ = _staggered(solo_cache, DecodeStepBatcher(solo_cache, model.decode_step).step,
                             {0: TOKS[i][:n]}, {0: 0}, {0: TOTALS[i]}, False)
        assert len(solo[0]) == len(together[i])
        for a, b in zip(solo[0], together[i]):
            assert a.tobytes() == b.tobytes()


def test_paged_admit_prefill_rows_matches_sequential_decode():
    """admit() places chronological prefilled rows where sequential
    decode writes them."""
    model = _model()
    toks = np.random.RandomState(13).randint(0, VOCAB, 6).astype(np.int32)
    seq = PagedKVCache(8, 4, 2, HEADS, DIM, max_streams=2, device="cpu")
    seq_b = PagedDecodeStepBatcher(seq, model.decode_step)
    slot = seq.acquire("seq", total_len=8)
    for t in toks:
        m = np.zeros((2,), bool)
        m[slot] = True
        seq_b.step(np.array([t, 0], np.int32), mask=m)
    k_rows, v_rows, n, last = model.prefill(toks)
    adm = PagedKVCache(8, 4, 2, HEADS, DIM, max_streams=2, device="cpu")
    slot2 = adm.acquire("adm", total_len=8)
    adm.admit(slot2, k_rows, v_rows, n)
    m = np.zeros((2,), bool)
    m[slot2] = True
    PagedDecodeStepBatcher(adm, model.decode_step).step(np.array([last, 0], np.int32), mask=m)
    for a, b in zip(seq.gather(slot), adm.gather(slot2)):
        np.testing.assert_allclose(a, b, **TF_TOL)
    assert int(seq.lengths[slot]) == int(adm.lengths[slot2]) == 6


@pytest.mark.parametrize("paged", [False, True])
def test_release_then_reacquire_bitwise_isolation(paged):
    """A slot or page freed by one stream and handed to another starts
    zeroed, and the reborn stream decodes bit for bit as on a fresh
    cache."""
    model = _model()

    def fresh():
        if paged:
            c = PagedKVCache(2, 4, 1, HEADS, DIM, max_streams=2, device="cpu")
            return c, PagedDecodeStepBatcher(c, model.decode_step), \
                (lambda name: c.acquire(name, total_len=4))
        c = RingKVCache(2, 4, HEADS, DIM, device="cpu")
        return c, DecodeStepBatcher(c, model.decode_step), c.acquire

    cache, batcher, acquire = fresh()
    a = acquire("first")
    for t in np.random.RandomState(4).randint(0, VOCAB, 3):
        batcher.step(np.array([t, 0] if a == 0 else [0, t], np.int32))
    assert cache.k.abs().sum() > 0
    cache.release(a)
    a2 = acquire("second")
    assert a2 == a and int(cache.lengths[a2]) == 0
    k2, v2 = cache.gather(a2) if paged else (cache.k[a2].numpy(), cache.v[a2].numpy())
    assert not np.asarray(k2).any() and not np.asarray(v2).any()
    out = batcher.step(np.array([3, 3], np.int32))
    ref_cache, ref_b, ref_acquire = fresh()
    assert ref_acquire("ref") == a2
    ref = ref_b.step(np.array([3, 3], np.int32))
    assert out[a2].tobytes() == ref[a2].tobytes()


def test_ring_mark_finished_under_full_ring():
    model = _model()
    cache = RingKVCache(1, 4, HEADS, DIM, device="cpu")
    batcher = DecodeStepBatcher(cache, model.decode_step)
    a = cache.acquire("wrapped")
    for t in np.random.RandomState(6).randint(0, VOCAB, 6):
        batcher.step(np.array([t], np.int32))
    assert int(cache.lengths[a]) == 6 and int(cache.valid_counts()[a]) == 4
    cache.mark_finished(a)
    assert cache.seq_id(a) == "wrapped"
    b = cache.acquire("next")
    assert b == a and cache.counters.snapshot()["kv_evictions"] == 1
    assert int(cache.lengths[b]) == 0 and not cache.k[b].any()


def test_caches_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RingKVCache(1, 4, HEADS, DIM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(1, 4, 1, HEADS, DIM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ToyDecodeModel(make_toy_decode_weights())


# -- on the card ----------------------------------------------------------------


@pytest.mark.gpu
def test_cuda_paged_step_matches_cpu_and_ring():
    """The wide toy (BERT-base's attention width: 12 heads of 64, vocab
    30522) on the card: the paged batcher's logits within 1e-5 of the
    CPU's largest each step, and bit-equal to the ring batcher's on the
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_kv_cache.py` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    weights = make_toy_decode_weights(seed=7, vocab=30522, num_heads=12, head_dim=64)
    rs = np.random.RandomState(3)
    toks = {i: rs.randint(0, 30522, 12).tolist() for i in range(3)}
    outs = {}
    for dev in ("cuda", "cpu"):
        model = ToyDecodeModel(weights, device=dev)
        paged = PagedKVCache(16, 4, MAX_LEN // 4, 12, 64, max_streams=SLOTS, device=dev)
        outs[dev], _ = _staggered(paged, PagedDecodeStepBatcher(paged, model.decode_step).step,
                                  toks, STARTS, TOTALS, True)
        if dev == "cuda":
            ring = RingKVCache(SLOTS, MAX_LEN, 12, 64, device=dev)
            rout, _ = _staggered(ring, DecodeStepBatcher(ring, model.decode_step).step, toks,
                                 STARTS, TOTALS, False)
            for i in toks:
                for r, p in zip(rout[i], outs[dev][i]):
                    assert r.tobytes() == p.tobytes()
    # fp32 sums over 768 products and 64 keys in two orders (cuBLAS,
    # MKL): within 1e-5 of each step's largest logit
    for i in toks:
        for g, c in zip(outs["cuda"][i], outs["cpu"][i]):
            assert np.abs(g - c).max() <= 1e-5 * np.abs(c).max()
