"""Autoregressive decode model and the role-split decode service: the port
of `paddle_tpu/inference/decode_model.py`.

The /predict path serves feed-forward exports, with no KV state. This
module carries the *generative* path the prefill/decode split serves: a
one-layer attention decoder whose step is the contract the KV caches'
step functions keep, packaged so the three roles share one
implementation:

- ``ToyDecodeModel.prefill(tokens)``: the compute-bound half. Per-token
  K/V projections over the prompt, padded to power-of-two lengths so a
  few shapes cover every prompt. Prefill needs no attention and no
  cache (the K/V rows are per-token functions of the embedding), which
  keeps a prefill replica stateless and its handoff idempotent.
- ``ToyDecodeModel.decode_step``: the latency-bound half, the
  ``step_fn(tokens, k, v, lengths, active_mask)`` the batchers run; the
  same math in a unified replica and in a decode replica, so a split
  reply equals the unified one bit for bit.
- ``DecodeService``: a PagedKVCache, a PagedDecodeStepBatcher and a
  driver thread stepping every registered stream in one dispatch.
  ``generate`` (unified: local prefill, then decode) and ``decode``
  (split: admit a handoff, then decode) meet in the same driver.

The model holds its weights as tensors on its device. Its attention is
plain torch (einsum, softmax), as the JAX module's is plain jnp with no
Pallas kernel. Greedy sampling (argmax) keeps generation deterministic.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .kv_cache import PagedDecodeStepBatcher, PagedKVCache, resolve_device

__all__ = ["make_toy_decode_weights", "save_decode_weights",
           "load_decode_weights", "ToyDecodeModel", "DecodeService",
           "DecodeAdmissionError"]


# the decode thread finishes or fails every job it holds; a request waits at most
# this long for its job (a liveness bound, not synchronisation)
JOB_TIMEOUT_S = 600.0


class DecodeAdmissionError(Exception):
    """Cache admission shed (no slot / pages within the window): HTTP
    503 + Retry-After at the serving layer."""


def make_toy_decode_weights(seed=7, vocab=11, num_heads=1, head_dim=4):
    """One attention layer (embed -> QKV -> attend over the cache -> vocab
    logits) from numpy's RandomState: the JAX package's construction, so
    the same seed gives the same weights."""
    embed = num_heads * head_dim
    rng = np.random.RandomState(seed)

    def mat(*shape):
        return rng.uniform(-0.5, 0.5, shape).astype(np.float32)

    return {
        "E": mat(vocab, embed),
        "Wq": mat(embed, embed),
        "Wk": mat(embed, embed),
        "Wv": mat(embed, embed),
        "Wo": mat(embed, vocab),
        "num_heads": np.int32(num_heads),
        "head_dim": np.int32(head_dim),
    }


def save_decode_weights(path, weights):
    with open(path, "wb") as f:
        np.savez(f, **weights)
    return path


def load_decode_weights(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class ToyDecodeModel:
    """One-attention-layer greedy decoder over a KV cache, its weights on
    `device` (the card unless the caller asks for the CPU).

    `decode_step` is the cache-contract step function (slot axis [S, L,
    H, D], write at lengths % L gated on active_mask, -inf validity mask);
    it writes k / v in place. `prefill` computes the prompt's
    chronological K/V rows with no attention, padded to a power-of-two
    bucket.
    """

    def __init__(self, weights, device="cuda"):
        w = {k: np.asarray(v) for k, v in weights.items()}
        self.num_heads = int(w.pop("num_heads", 1))
        self.head_dim = int(w.pop("head_dim", w["E"].shape[1]))
        self.embed = self.num_heads * self.head_dim
        self.vocab = w["E"].shape[0]
        if w["E"].shape[1] != self.embed:
            raise ValueError(
                f"embed dim {w['E'].shape[1]} != "
                f"num_heads*head_dim {self.embed}")
        self.device = resolve_device(device)
        self.w = {n: torch.as_tensor(a).to(self.device) for n, a in w.items()}

    # -- decode half ------------------------------------------------------
    def decode_step(self, tokens, k, v, lengths, active_mask):
        w = self.w
        H, D = self.num_heads, self.head_dim
        S, L = k.shape[0], k.shape[1]
        x = w["E"][tokens]
        q = (x @ w["Wq"]).reshape(S, H, D)
        k_t = (x @ w["Wk"]).reshape(S, H, D)
        v_t = (x @ w["Wv"]).reshape(S, H, D)
        pos = lengths % L
        gate = active_mask[:, None, None]
        rows = torch.arange(S, device=k.device)
        # in place (the JAX step donates the blocks): one row a slot
        k.index_put_((rows, pos), torch.where(gate, k_t, k[rows, pos]))
        v.index_put_((rows, pos), torch.where(gate, v_t, v[rows, pos]))
        valid = torch.clamp(lengths + 1, max=L)
        scores = torch.einsum("shd,slhd->shl", q, k) / float(np.sqrt(D))
        col = torch.arange(L, device=k.device)[None, None, :]
        scores = scores.masked_fill(~(col < valid[:, None, None]), float("-inf"))
        attn = torch.exp(scores - scores.amax(-1, keepdim=True))
        attn = attn / attn.sum(-1, keepdim=True)
        ctx = torch.einsum("shl,slhd->shd", attn, v).reshape(S, self.embed)
        logits = ctx @ w["Wo"]
        return logits, k, v

    # -- prefill half -----------------------------------------------------
    @staticmethod
    def prefill_bucket(n):
        """Power-of-two padded length: a few shapes cover every prompt."""
        b = 1
        while b < n:
            b *= 2
        return b

    def prefill(self, tokens):
        """Prompt -> (k_rows, v_rows, length, last_token): host numpy K/V
        projections, in chronological order, of every prompt token but
        the last, which decode takes as its first step input (so the
        write path is that of a stream never prefilled). The handoff wire
        layout: rows [length, H, D]."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        if toks.size < 1:
            raise ValueError("prefill needs at least one prompt token")
        n = toks.size - 1  # rows for all but the last token
        if n == 0:
            hd = (0, self.num_heads, self.head_dim)
            return (np.zeros(hd, np.float32), np.zeros(hd, np.float32),
                    0, int(toks[-1]))
        bucket = self.prefill_bucket(n)
        padded = np.zeros((bucket,), np.int64)
        padded[:n] = toks[:-1]
        H, D, w = self.num_heads, self.head_dim, self.w
        with torch.no_grad():
            x = w["E"][torch.as_tensor(padded).to(self.device)]  # [bucket, embed]
            k = (x @ w["Wk"]).reshape(bucket, H, D)
            v = (x @ w["Wv"]).reshape(bucket, H, D)
            return (k[:n].cpu().numpy(), v[:n].cpu().numpy(), n, int(toks[-1]))


class _DecodeJob:
    __slots__ = ("slot", "next_token", "remaining", "tokens", "logits",
                 "done", "error")

    def __init__(self, slot, first_token, max_new):
        self.slot = slot
        self.next_token = int(first_token)
        self.remaining = int(max_new)
        self.tokens = []
        self.logits = []
        self.done = threading.Event()
        self.error = None


class DecodeService:
    """Continuous-batching greedy decode over a PagedKVCache on the
    model's device: its own, or with `cache=` one it shares with other
    models' services (`owns_cache` False).

    One daemon driver thread advances EVERY registered stream per
    dispatch through the paged step; requests block on their job's
    completion event. `generate` (unified) and `decode` (split, fed by a
    handoff) register jobs the same way: they differ only in where the
    K/V rows came from.
    """

    def __init__(self, model: ToyDecodeModel, *, num_pages=64,
                 page_len=16, pages_per_seq=4, max_streams=None,
                 admission_window_s=0.0, idle_sleep_s=0.002, cache=None):
        self.model = model
        if cache is not None:
            # N services (one a model) admit into ONE PagedKVCache. Safe
            # because the batcher's step holds cache._array_lock for its
            # whole gather -> step -> write-back cycle, each driver masks
            # only its own streams, and an unmasked row writes only the
            # scratch page (the value already there), never another
            # model's pages
            geometry = (int(cache.shape[2]), int(cache.shape[3]), cache.device)
            if geometry != (model.num_heads, model.head_dim, model.device):
                raise ValueError(
                    "shared KV cache geometry mismatch: cache is [H={}, D={}] "
                    "on {}, model needs [H={}, D={}] on {}".format(
                        *geometry, model.num_heads, model.head_dim, model.device))
            self.cache = cache
            self.owns_cache = False
        else:
            self.cache = PagedKVCache(
                num_pages, page_len, pages_per_seq,
                model.num_heads, model.head_dim,
                max_streams=max_streams,
                admission_window_s=admission_window_s,
                device=model.device)
            self.owns_cache = True
        self.batcher = PagedDecodeStepBatcher(self.cache, model.decode_step)
        self._jobs = {}  # slot -> _DecodeJob
        self._cv = threading.Condition()
        self._idle_sleep_s = float(idle_sleep_s)
        self._stop = False
        self._driver = threading.Thread(target=self._drive,
                                        name="decode-driver", daemon=True)
        self._driver.start()

    # -- entry points -----------------------------------------------------
    def generate(self, prompt, max_new, deadline=None, seq_id=None):
        """Unified path: local prefill, then the shared decode driver.
        Returns (tokens [max_new] int32, logits [max_new, vocab])."""
        k_rows, v_rows, length, last = self.model.prefill(prompt)
        return self.decode(k_rows, v_rows, length, last, max_new,
                           deadline=deadline, seq_id=seq_id)

    def decode(self, k_rows, v_rows, length, last_token, max_new,
               deadline=None, seq_id=None):
        """Split path: admit a (possibly remote) prefill's K/V rows, then
        decode. Admission shed raises DecodeAdmissionError."""
        max_new = int(max_new)
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        total = int(length) + max_new
        slot = self.cache.acquire(seq_id=seq_id, total_len=total,
                                  deadline=deadline)
        if slot is None:
            raise DecodeAdmissionError(
                "decode admission shed: no free KV pages within the "
                "window")
        try:
            self.cache.admit(slot, k_rows, v_rows, length)
        except Exception:
            self.cache.release(slot)
            raise
        job = _DecodeJob(slot, last_token, max_new)
        with self._cv:
            self._jobs[slot] = job
            self.cache.counters.gauge("kv_decode_streams",
                                      len(self._jobs))
            self._cv.notify_all()
        if not job.done.wait(JOB_TIMEOUT_S):
            raise TimeoutError(f"decode job on stream {slot} did not finish "
                               f"within {JOB_TIMEOUT_S} s")
        if job.error is not None:
            raise job.error
        return (np.asarray(job.tokens, np.int32),
                np.stack(job.logits).astype(np.float32))

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._driver.join(timeout=5.0)

    def free_pages(self):
        return self.cache.free_pages()

    # -- driver -----------------------------------------------------------
    def _drive(self):
        S = self.cache.max_streams
        while True:
            with self._cv:
                while not self._jobs and not self._stop:
                    self._cv.wait(self._idle_sleep_s * 50)
                if self._stop:
                    for job in self._jobs.values():
                        job.error = RuntimeError("decode service closed")
                        job.done.set()
                    self._jobs.clear()
                    return
                batch = dict(self._jobs)
            tokens = np.zeros((S,), np.int32)
            mask = np.zeros((S,), bool)
            for slot, job in batch.items():
                tokens[slot] = job.next_token
                mask[slot] = True
            try:
                with torch.no_grad():
                    out = self.batcher.step(tokens, mask)
            except Exception as e:  # fail the whole dispatch loudly
                with self._cv:
                    for slot, job in batch.items():
                        if self._jobs.pop(slot, None) is not None:
                            try:
                                self.cache.release(slot)
                            except KeyError:
                                pass
                            job.error = e
                            job.done.set()
                    self.cache.counters.gauge("kv_decode_streams",
                                              len(self._jobs))
                continue
            finished = []
            for slot, job in batch.items():
                row = np.asarray(out[slot])
                tok = int(row.argmax())  # greedy: deterministic
                job.logits.append(row)
                job.tokens.append(tok)
                job.next_token = tok
                job.remaining -= 1
                if job.remaining <= 0:
                    finished.append((slot, job))
            if finished:
                with self._cv:
                    for slot, job in finished:
                        self._jobs.pop(slot, None)
                        self.cache.release(slot)
                    self.cache.counters.gauge("kv_decode_streams",
                                              len(self._jobs))
                for _, job in finished:
                    job.done.set()
