"""Preallocated KV caches and decode-step batching for autoregressive
serving: the port of `paddle_tpu/inference/kv_cache.py`.

- **RingKVCache** preallocates the K/V blocks once, ``[num_slots,
  max_len, num_heads, head_dim]`` torch tensors on the cache's device, so
  every decode step has one shape for the server's lifetime. Each
  in-flight sequence owns a slot; its per-token writes land at ``length %
  max_len`` (a ring: a sequence longer than max_len keeps a sliding
  window). ``acquire`` takes a free slot now, evicts the
  least-recently-finished resident, waits at most ``admission_window_s``
  for a release, and sheds (returns None) at once when the caller's
  deadline cannot afford the window.

- **DecodeStepBatcher** runs ONE step function over the whole slot axis:
  lengths and the active mask ride as data, never as shapes, so sequences
  of different lengths share every step. Slots are independent rows of
  every batched op, so a slot decodes the same bits alone or next to
  strangers.

- **PagedKVCache** swaps fixed slots for pages: one pool ``[num_pages + 1,
  page_len, H, D]`` (the last page is the scratch page inactive rows write
  to) and a per-stream page table. A stream reserves all the pages its
  declared ``total_len`` needs at ``acquire``, so a half-decoded stream is
  never shed. **PagedDecodeStepBatcher** gathers each stream's pages
  through the table into the ``[S, max_len, H, D]`` view the ring's step
  function expects, runs it, and writes only the appended ring position
  back into the pool; its outputs equal the ring cache's bit for bit.

Where the JAX module donates the cache blocks to a jitted step
(``donate_argnums=(1, 2)``), the port writes in place: the step function
and the paged scatter use ``index_put_`` on the blocks or the pool, and no
copy of the pool is made per step. Admission, eviction, deadlines, the
scratch page and the counters are host logic, ported line for line.

Counters (an instance CounterSet rolled up globally, like the server's):
kv_slots_inflight (gauge), kv_slot_acquires, kv_slot_releases,
kv_evictions, kv_admission_sheds, kv_decode_steps; the paged cache adds
kv_pages_in_use / kv_decode_streams (gauges), kv_page_allocs and
kv_page_evictions.
"""

from __future__ import annotations

import math
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from .. import profiler
from ..place import CPUPlace, CUDAPlace

__all__ = ["RingKVCache", "DecodeStepBatcher", "PagedKVCache",
           "PagedDecodeStepBatcher", "resolve_device"]


def resolve_device(device) -> torch.device:
    """"cuda" / "cuda:i" / "cpu", a torch.device or a Place -> the torch
    device; a CUDA device with no card raises (nothing drops to the CPU
    unless the caller asked for it)."""
    if hasattr(device, "torch_device"):
        return device.torch_device()
    dev = torch.device(device)
    if dev.type == "cpu":
        return CPUPlace().torch_device()
    if dev.type == "cuda":
        return CUDAPlace(dev.index or 0).torch_device()
    raise ValueError(f"device must be cuda or cpu, got {device!r}")


def _dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype))


class RingKVCache:
    """Fixed-geometry slot-sharded K/V storage with gated admission.

    ``k`` / ``v`` live on the cache's device; the batcher's step writes
    them in place (and a caller using ``write`` does too). The cache
    object owns slot bookkeeping: lengths (host mirror), the free list,
    the active set and the finished-LRU eviction order.
    """

    def __init__(self, num_slots, max_len, num_heads, head_dim,
                 dtype="float32", admission_window_s=0.0, device="cuda"):
        if num_slots < 1 or max_len < 1:
            raise ValueError("num_slots and max_len must be >= 1")
        self.device = resolve_device(device)
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.shape = (self.num_slots, self.max_len,
                      int(num_heads), int(head_dim))
        self.k = torch.zeros(self.shape, dtype=_dtype(dtype), device=self.device)
        self.v = torch.zeros_like(self.k)
        self.lengths = np.zeros((self.num_slots,), np.int32)
        self.admission_window_s = float(admission_window_s)

        self._cv = threading.Condition()
        # serializes every write of k / v (acquire's slot zeroing,
        # write(), the batcher's step): an acquire racing a step must not
        # have its zeroing overwritten by the step's write-back
        self._array_lock = threading.Lock()
        self._free = list(range(self.num_slots - 1, -1, -1))
        self._active = {}  # slot -> seq_id
        self._finished = OrderedDict()  # slot -> seq_id, LRU-evictable
        self.counters = profiler.CounterSet()

    # -- admission gate ---------------------------------------------------
    def acquire(self, seq_id=None, deadline=None):
        """Claim a slot for a new sequence -> the slot index, or None
        (shed). A free slot now; else evict the least-recently-finished
        resident; else wait out the admission window for a release,
        unless the caller's deadline cannot afford the window, which
        sheds at once."""
        window = self.admission_window_s
        wait_until = time.monotonic() + window
        with self._cv:
            while True:
                slot = self._claim_locked()
                if slot is not None:
                    self._activate_locked(slot, seq_id)
                    break
                if deadline is not None and deadline < wait_until:
                    self.counters.bump("kv_admission_sheds")
                    return None
                left = wait_until - time.monotonic()
                if left <= 0:
                    self.counters.bump("kv_admission_sheds")
                    return None
                self._cv.wait(left)
        # zero the slot outside the admission condition but under the
        # array lock: the previous occupant's rows must never alias into
        # the new sequence's window
        with self._array_lock:
            self.k[slot].zero_()
            self.v[slot].zero_()
        return slot

    def _claim_locked(self):
        if self._free:
            return self._free.pop()
        if self._finished:
            slot, _ = self._finished.popitem(last=False)  # LRU
            self.counters.bump("kv_evictions")
            return slot
        return None

    def _activate_locked(self, slot, seq_id):
        self.lengths[slot] = 0
        self._active[slot] = seq_id
        self.counters.bump("kv_slot_acquires")
        self.counters.gauge("kv_slots_inflight", len(self._active))

    def mark_finished(self, slot):
        """Done decoding, but resident (readable) until released, or
        evicted when admission pressure needs the slot."""
        with self._cv:
            seq = self._active.pop(slot, None)
            if seq is None and slot not in self._finished:
                raise KeyError(f"slot {slot} is not active")
            if seq is not None:
                self._finished[slot] = seq
            self.counters.gauge("kv_slots_inflight", len(self._active))
            self._cv.notify_all()

    def release(self, slot):
        """Free the slot entirely (active or finished-resident)."""
        with self._cv:
            was_active = self._active.pop(slot, None) is not None
            was_finished = self._finished.pop(slot, None) is not None
            if not (was_active or was_finished):
                raise KeyError(f"slot {slot} is not in use")
            self._free.append(slot)
            self.counters.bump("kv_slot_releases")
            self.counters.gauge("kv_slots_inflight", len(self._active))
            self._cv.notify_all()

    # -- slot state -------------------------------------------------------
    def active_slots(self):
        with self._cv:
            return sorted(self._active)

    def active_mask(self):
        mask = np.zeros((self.num_slots,), bool)
        mask[self.active_slots()] = True
        return mask

    def seq_id(self, slot):
        with self._cv:
            return self._active.get(slot, self._finished.get(slot))

    def write(self, slot, k_t, v_t):
        """Host-driven single-token append at the ring position (the
        semantic reference for the batched step); advances the length."""
        with self._array_lock:
            pos = int(self.lengths[slot]) % self.max_len
            self.k[slot, pos] = torch.as_tensor(k_t, device=self.device)
            self.v[slot, pos] = torch.as_tensor(v_t, device=self.device)
            self.lengths[slot] += 1

    def valid_counts(self):
        """Per-slot count of ring positions holding real tokens,
        min(length, max_len): the attention mask derives from it."""
        return np.minimum(self.lengths, self.max_len)


def _step_inputs(tokens, lengths, mask, device):
    """The step's data arguments as tensors on the cache's device (copies:
    the host mirrors move on after the step)."""
    return (torch.tensor(np.asarray(tokens), dtype=torch.int64, device=device),
            torch.tensor(np.asarray(lengths), dtype=torch.int64, device=device),
            torch.tensor(np.asarray(mask, bool), device=device))


class DecodeStepBatcher:
    """One step function shared by every in-flight sequence.

    ``step_fn(tokens, k, v, lengths, active_mask) -> (out, k_new, v_new)``
    works on the FULL slot axis: tokens ``[S]``, the blocks ``[S, L, H,
    D]``, lengths ``[S]``, active_mask ``[S]`` bool, all tensors on the
    cache's device. It gates its cache writes on ``active_mask`` (an
    inactive slot keeps its rows bit for bit) and masks its attention by
    the valid positions ``lengths`` gives. It may write ``k`` / ``v`` in
    place and return them (the port's form of the JAX batcher's
    donation); the batcher stores what it returns and advances the host
    length mirror of the active slots.
    """

    def __init__(self, cache: RingKVCache, step_fn):
        self._cache = cache
        self._fn = step_fn

    def step(self, tokens):
        """Advance every ACTIVE slot one token. `tokens` is the full
        [num_slots] vector (inactive entries are ignored). Returns the
        step output as host numpy ([num_slots, ...])."""
        c = self._cache
        # the read -> step -> write-back cycle holds the array lock: a
        # concurrent acquire() zeroing a freshly claimed slot interleaves
        # between steps, never inside one
        with c._array_lock:
            mask = c.active_mask()
            toks, lens, active = _step_inputs(tokens, c.lengths, mask, c.device)
            out, k_new, v_new = self._fn(toks, c.k, c.v, lens, active)
            c.k, c.v = k_new, v_new
            c.lengths[mask] += 1
            out = out.cpu().numpy()
        c.counters.bump("kv_decode_steps")
        return out


class PagedKVCache:
    """Page-granular K/V storage: a pool ``[num_pages + 1, page_len, H,
    D]`` on the cache's device (the +1 page is the scratch page inactive
    streams write to) and a host page table ``[max_streams,
    pages_per_seq]``. A stream's logical window is the ring the
    RingKVCache keeps: position ``p = global_index % max_len`` lives at
    ``page_table[s, p // page_len][p % page_len]``, so gathering a
    stream's pages in table order gives the ``[max_len, H, D]`` block a
    ring cache would hold.

    ``acquire`` reserves the stream's FULL page need from its declared
    ``total_len``: under pressure it evicts least-recently-finished
    residents page by page, then waits out the admission window, and
    sheds at once when the caller's deadline cannot afford the window.
    """

    def __init__(self, num_pages, page_len, pages_per_seq, num_heads,
                 head_dim, dtype="float32", max_streams=None,
                 admission_window_s=0.0, device="cuda"):
        if num_pages < 1 or page_len < 1 or pages_per_seq < 1:
            raise ValueError(
                "num_pages, page_len and pages_per_seq must be >= 1")
        self.device = resolve_device(device)
        self.num_pages = int(num_pages)
        self.page_len = int(page_len)
        self.pages_per_seq = int(pages_per_seq)
        self.max_len = self.page_len * self.pages_per_seq
        self.max_streams = int(max_streams or num_pages)
        self.scratch_page = self.num_pages  # never allocated
        self.shape = (self.num_pages + 1, self.page_len,
                      int(num_heads), int(head_dim))
        self.k = torch.zeros(self.shape, dtype=_dtype(dtype), device=self.device)
        self.v = torch.zeros_like(self.k)
        # host mirrors, mutated under _array_lock like the ring's
        self.page_table = np.full((self.max_streams, self.pages_per_seq),
                                  self.scratch_page, np.int32)
        self.lengths = np.zeros((self.max_streams,), np.int32)
        self.admission_window_s = float(admission_window_s)

        self._cv = threading.Condition()
        self._array_lock = threading.Lock()
        self._free_pages = list(range(self.num_pages - 1, -1, -1))
        self._free_slots = list(range(self.max_streams - 1, -1, -1))
        self._active = {}  # stream slot -> seq_id
        self._finished = OrderedDict()  # slot -> seq_id, LRU-evictable
        self._pages_of = {}  # slot -> [page ids], reserved at acquire
        self.counters = profiler.CounterSet()

    # -- geometry ---------------------------------------------------------
    def pages_needed(self, total_len):
        """Pages a stream of final length `total_len` reserves: its
        sliding window is min(total_len, max_len) positions."""
        window = min(max(int(total_len), 1), self.max_len)
        return int(math.ceil(window / self.page_len))

    def free_pages(self):
        with self._cv:
            return len(self._free_pages)

    # -- admission gate ---------------------------------------------------
    def acquire(self, seq_id=None, total_len=1, deadline=None):
        """Claim a stream slot plus its full page reservation -> the slot
        index, or None (shed). The ring's order of preference, at page
        granularity."""
        need = self.pages_needed(total_len)
        window = self.admission_window_s
        wait_until = time.monotonic() + window
        with self._cv:
            while True:
                slot = self._claim_locked(need)
                if slot is not None:
                    self._activate_locked(slot, seq_id)
                    pages = self._pages_of[slot]
                    break
                if deadline is not None and deadline < wait_until:
                    self.counters.bump("kv_admission_sheds")
                    return None
                left = wait_until - time.monotonic()
                if left <= 0:
                    self.counters.bump("kv_admission_sheds")
                    return None
                self._cv.wait(left)
        # zero the reserved pages outside the admission condition but
        # under the array lock (the ring's stale-rows contract)
        with self._array_lock:
            idx = torch.tensor(pages, dtype=torch.int64, device=self.device)
            self.k.index_fill_(0, idx, 0)
            self.v.index_fill_(0, idx, 0)
        return slot

    def _claim_locked(self, need):
        if not self._free_slots:
            # a finished resident also frees its STREAM slot on eviction
            if not self._finished:
                return None
        while len(self._free_pages) < need and self._finished:
            fslot, _ = self._finished.popitem(last=False)  # LRU
            freed = self._release_pages_locked(fslot)
            self._free_slots.append(fslot)
            self.counters.bump("kv_evictions")
            self.counters.bump("kv_page_evictions", freed)
        if not self._free_slots or len(self._free_pages) < need:
            return None
        slot = self._free_slots.pop()
        pages = [self._free_pages.pop() for _ in range(need)]
        self._pages_of[slot] = pages
        self.page_table[slot, :] = self.scratch_page
        self.page_table[slot, :need] = pages
        self.counters.bump("kv_page_allocs", need)
        self._note_pages_locked()
        return slot

    def _release_pages_locked(self, slot):
        pages = self._pages_of.pop(slot, [])
        self._free_pages.extend(pages)
        self.page_table[slot, :] = self.scratch_page
        self._note_pages_locked()
        return len(pages)

    def _note_pages_locked(self):
        self.counters.gauge("kv_pages_in_use",
                            self.num_pages - len(self._free_pages))

    def _activate_locked(self, slot, seq_id):
        self.lengths[slot] = 0
        self._active[slot] = seq_id
        self.counters.bump("kv_slot_acquires")
        self.counters.gauge("kv_slots_inflight", len(self._active))

    def admit(self, slot, k_rows, v_rows, length):
        """Land a prefilled K/V history in the stream's reserved pages:
        `k_rows` / `v_rows` are the projections of the prompt's first
        `length` tokens in chronological order ([length, H, D], the
        handoff wire layout); rows beyond the sliding window are dropped
        and the kept rows land at their ring positions (global index %
        max_len), where sequential decode writes would have put them."""
        k_rows = np.asarray(k_rows)
        v_rows = np.asarray(v_rows)
        length = int(length)
        if k_rows.shape[0] != length or v_rows.shape[0] != length:
            raise ValueError(
                f"admit: got {k_rows.shape[0]} K rows / "
                f"{v_rows.shape[0]} V rows for length {length}")
        window = min(length, self.max_len)
        with self._array_lock:
            if window:
                g = np.arange(length - window, length)
                pos = g % self.max_len
                pages = self.page_table[slot][pos // self.page_len]
                if int(pages.max(initial=-1)) >= self.scratch_page:
                    raise RuntimeError(
                        f"admit: stream {slot} reserved too few pages "
                        f"for length {length} (acquire with a larger "
                        "total_len)")
                offs = pos % self.page_len
                idx = (torch.tensor(pages, dtype=torch.int64, device=self.device),
                       torch.tensor(offs, dtype=torch.int64, device=self.device))
                self.k.index_put_(idx, torch.as_tensor(
                    k_rows[length - window:], dtype=self.k.dtype).to(self.device))
                self.v.index_put_(idx, torch.as_tensor(
                    v_rows[length - window:], dtype=self.v.dtype).to(self.device))
            self.lengths[slot] = length

    def mark_finished(self, slot):
        """Done decoding but resident (readable) until released, or
        evicted page by page when admission pressure needs the pool."""
        with self._cv:
            if slot in self._active:
                self._finished[slot] = self._active.pop(slot)
            elif slot not in self._finished:
                raise KeyError(f"stream {slot} is not active")
            self.counters.gauge("kv_slots_inflight", len(self._active))
            self._cv.notify_all()

    def release(self, slot):
        """Free the stream's slot and every reserved page."""
        with self._cv:
            if slot in self._active:
                del self._active[slot]
            elif slot in self._finished:
                del self._finished[slot]
            else:
                raise KeyError(f"stream {slot} is not in use")
            self._release_pages_locked(slot)
            self._free_slots.append(slot)
            self.counters.bump("kv_slot_releases")
            self.counters.gauge("kv_slots_inflight", len(self._active))
            self._cv.notify_all()

    # -- slot state (ring-compatible surface) -----------------------------
    def active_slots(self):
        with self._cv:
            return sorted(self._active)

    def active_mask(self):
        mask = np.zeros((self.max_streams,), bool)
        mask[self.active_slots()] = True
        return mask

    def seq_id(self, slot):
        with self._cv:
            return self._active.get(slot, self._finished.get(slot))

    def write(self, slot, k_t, v_t):
        """Host-driven single-token append through the page table (the
        semantic reference for the batched path)."""
        with self._array_lock:
            pos = int(self.lengths[slot]) % self.max_len
            page = int(self.page_table[slot, pos // self.page_len])
            if page >= self.scratch_page:
                raise RuntimeError(
                    f"write: stream {slot} has no page reserved for "
                    f"position {pos} (acquire with a larger total_len)")
            off = pos % self.page_len
            self.k[page, off] = torch.as_tensor(k_t, device=self.device)
            self.v[page, off] = torch.as_tensor(v_t, device=self.device)
            self.lengths[slot] += 1

    def gather(self, slot):
        """This stream's logical ``[max_len, H, D]`` K/V view as host
        numpy: the block a ring cache of the same geometry would hold.
        Unreserved positions read the scratch page (masked by
        valid_counts in any attention over them)."""
        with self._array_lock:
            table = torch.as_tensor(self.page_table[slot].astype(np.int64),
                                    device=self.device)
            k = self.k[table].reshape(self.max_len, *self.shape[2:])
            v = self.v[table].reshape(self.max_len, *self.shape[2:])
            return k.cpu().numpy(), v.cpu().numpy()

    def valid_counts(self):
        return np.minimum(self.lengths, self.max_len)


class PagedDecodeStepBatcher:
    """The ring batcher's contract on a PagedKVCache: one step advances
    every masked stream a token. ``step_fn`` is the DecodeStepBatcher's,
    unchanged: the pool is gathered through the page table into the
    ``[S, max_len, H, D]`` view the step expects, and after the step only
    the appended ring position of each row is written back into the pool
    in place. Page tables, lengths and the mask ride as data.

    ``step(tokens, mask=None)`` takes an explicit mask, so a decode
    driver steps exactly the streams it registered; a stream admitted
    between the mask's snapshot and the dispatch joins the NEXT step (its
    pages are untouched: unmasked rows write to the scratch page)."""

    def __init__(self, cache: PagedKVCache, step_fn):
        self._cache = cache
        self._fn = step_fn

    def _paged_step(self, tokens, table, lengths, active):
        c = self._cache
        S, max_len, page_len = c.max_streams, c.max_len, c.page_len
        hd = c.shape[2:]
        flat = table.reshape(-1)
        kg = c.k.index_select(0, flat).reshape((S, max_len) + hd)
        vg = c.v.index_select(0, flat).reshape((S, max_len) + hd)
        out, k_new, v_new = self._fn(tokens, kg, vg, lengths, active)
        rows = torch.arange(S, device=c.device)
        pos = lengths % max_len
        # inactive rows all write to the scratch page, so (scratch, off)
        # repeats among the indices; index_put_ keeps an arbitrary one of
        # repeated writes, which is harmless only because each of them
        # writes the value the pool already holds there (the gate picks
        # the pool's own row), read before the write. Active rows hold
        # distinct reserved pages and never repeat.
        page = torch.where(active, table[rows, pos // page_len],
                           torch.full_like(pos, c.scratch_page))
        off = pos % page_len
        gate = active.reshape((S,) + (1,) * len(hd))
        c.k.index_put_((page, off), torch.where(gate, k_new[rows, pos], c.k[page, off]))
        c.v.index_put_((page, off), torch.where(gate, v_new[rows, pos], c.v[page, off]))
        return out

    def step(self, tokens, mask=None):
        """Advance the masked streams one token (default: every active
        stream). Returns the step output as host numpy ([max_streams,
        ...])."""
        c = self._cache
        with c._array_lock:
            m = (c.active_mask() if mask is None
                 else np.asarray(mask, bool))
            toks, lens, active = _step_inputs(tokens, c.lengths, m, c.device)
            table = torch.tensor(c.page_table, dtype=torch.int64, device=c.device)
            out = self._paged_step(toks, table, lens, active)
            c.lengths[m] += 1
            out = out.cpu().numpy()
        c.counters.bump("kv_decode_steps")
        return out
