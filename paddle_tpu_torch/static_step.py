"""The static step of `Executor.run_repeated`: N training steps of one feed
as one step, recorded once and replayed N times.

The JAX executor runs the N steps as a `lax.scan` in one dispatch
(paddle_tpu/executor.py:1026-1141 there). Its counterpart on the card is a
CUDA graph: the step's ops, the autograd graphs of its forward ops,
`__auto_grad__`, the optimizer and loss-scaling ops and a mesh plan's
collectives captured once on tensors that stay put, then replayed N times
with one host sync at the end. A `StaticStep` holds those tensors:

- the state: a tensor of its own for every persistable the step reads or
  writes (under ZeRO-1 the rank's rows). A call copies the scope's values
  in where the scope holds other tensors, and the scope ends up holding
  these, so a later `run()` reads them and rebinds its own;
- the feed, copied in once a call and constant over its steps, as in JAX;
- the seed table (ops/registry.py `SeedSlots`): the step's random draws
  read their words there, so replay i draws step i's dropout and attention
  masks. The words of all N steps follow on the host from
  fold_in(key(random_seed or 42), counter + i), the run keys of N `run()`
  calls, and go to the device in one copy; each replay's row is copied
  into the table on the device before it.

The first call records. One step runs in discovery mode (on the card on
a side stream, its outputs dropped): it registers the seed slots and
loads the kernels, cuBLAS and the allocator. Then, on the card, one step
is captured after gc.collect(), so that no autograd graph of an earlier
run lives into the capture; the captured step ends by copying every new
persistable into its state tensor. A replay is then the table's row, the
graph, and each fetch copied into its row of the stacked result. On the
CPU the same step re-runs its lowering with the slot tensors at each step
instead of replaying a graph. On a CUDA device a capture that fails
raises, naming its cause: nothing walks the N steps instead.

The step draws nothing from a torch.Generator: an op that would raises,
naming itself (ops/tensor_ops.py `_op_generator`).
"""

from __future__ import annotations

import gc
import time

import torch

from .ops.registry import LoweringContext, SeedSlots, int32_words
from .scope import full_value

__all__ = ["StaticStep"]


class StaticStep:
    """One post-pass Program's step over static tensors (module docstring).
    `read`: the persistables the block reads before writing them;
    `lower`: executor._lower_step; `written`: the persistables it writes."""

    def __init__(self, program, device, feed, fetch_names, plan, training, read, written,
                 lower):
        self.program = program
        self.block = program.global_block()
        self.device = torch.device(device)
        self.feed_names = sorted(feed)
        self.fetch_names = list(fetch_names)
        self.plan = plan
        self.training = training
        self.read = sorted(read)
        self.written = list(written)
        self._lower = lower
        self.state = {}  # name -> its static tensor
        self.feed = {}
        self.slots = None
        self.graph = None
        self.fetch_out = None
        self.recomputed, self.deferred = [], []
        # what the recording measured on the card: the capture's wall ms
        # and the bytes the capture reserved (the graph's memory pool)
        self.capture_ms = self.pool_bytes = None

    # -- the tensors that stay put --------------------------------------
    def load(self, scope, feed):
        """Copy the scope's state and `feed` (tensors on the device) into
        the static tensors, made at the first call."""
        if self.state and self.device.type == "cuda":
            # a snapshot's copy off the card may still be reading them
            from .resilience.snapshot import wait_for_copies

            wait_for_copies(self.device)
        with torch.no_grad():
            for n in sorted(set(self.read) | set(self.written)):
                if not scope.has(n) or scope.get(n) is None:
                    continue  # written by the step, not there yet
                val = scope.get(n)
                val = self.plan.local_state(n, val) if self.plan is not None else full_value(val)
                if not isinstance(val, torch.Tensor) or val.device != self.device:
                    from .executor import as_tensor

                    val = as_tensor(val, self.block.var(n).dtype, self.device)
                buf = self.state.get(n)
                if buf is None:
                    self.state[n] = val.detach().clone()
                elif val is not buf and (val.data_ptr() != buf.data_ptr()
                                         or val.shape != buf.shape):
                    buf.copy_(val)
            for n, t in feed.items():
                if n in self.feed:
                    self.feed[n].copy_(t)
                else:
                    self.feed[n] = t.detach().clone()

    def bind(self, scope):
        """The scope holds the static state tensors."""
        for n, t in self.state.items():
            scope.set(n, self.plan.wrap_state(n, t) if self.plan is not None else t)

    # -- one step -----------------------------------------------------------
    def _body(self):
        """One lowering of the step on the static tensors -> (new state by
        name, fetches)."""
        ctx = LoweringContext(self.program, device=self.device)
        ctx.seed_slots = self.slots
        if self.plan is not None:
            self.plan.bind(ctx)
        for n in self.read:
            ctx.values[n] = self.state[n]
        ctx.values.update(self.feed)
        fetches = self._lower(ctx, self.program, self.block, self.feed_names,
                              self.fetch_names, self.plan, self.training)
        if self.plan is not None:
            fetches = [self.plan.fetch(n, f) for n, f in zip(self.fetch_names, fetches)]
        self.recomputed, self.deferred = sorted(ctx.recomputed), sorted(ctx.deferred)
        return {n: ctx.values[n].detach() for n in self.written}, fetches

    def _write_state(self, new_state):
        """Each new persistable into its static tensor; one that is another
        name's static tensor is cloned first, before that one changes."""
        owner = {t.data_ptr(): n for n, t in self.state.items() if t.numel()}
        src = {n: t.clone() if t.numel() and owner.get(t.data_ptr(), n) != n else t
               for n, t in new_state.items()}
        with torch.no_grad():
            for n, t in src.items():
                self.state[n].copy_(t)

    # -- recording ----------------------------------------------------------
    def record(self, discover_key):
        """The discovery step (the seed slots, the lazy library state), then
        on the card the capture of one step."""
        self.slots = SeedSlots(self.device, discover_key)
        cuda = self.device.type == "cuda"
        if cuda:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                new_state, fetches = self._body()
            torch.cuda.current_stream(self.device).wait_stream(side)
        else:
            new_state, fetches = self._body()
        for n, t in new_state.items():
            buf = self.state.get(n)
            if buf is None:
                self.state[n] = torch.zeros_like(t)
            elif buf.shape != t.shape or buf.dtype != t.dtype:
                raise RuntimeError(
                    f"run_repeated: the step writes persistable {n!r} as {t.dtype} "
                    f"{tuple(t.shape)} over {buf.dtype} {tuple(buf.shape)}; a static step "
                    "needs the state's layout to stay: run this Program with Executor.run")
        del new_state, fetches
        self.slots.freeze()
        if not cuda:
            return
        # no autograd graph of an earlier run may live into the capture: its
        # AccumulateGrad nodes would make the capture stream wait on the
        # stream they were made on, which invalidates the capture
        gc.collect()
        torch.cuda.synchronize(self.device)
        # torch.cuda.graph empties the allocator's cache first: so does this,
        # so that what the capture reserves is the graph's pool
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                new_state, fetches = self._body()
                self._write_state(new_state)
        except Exception as e:
            notes = "; ".join(getattr(e, "__notes__", None) or ())
            raise RuntimeError(
                "run_repeated: the CUDA graph capture of the step failed: "
                f"{type(e).__name__}: {e}{f' ({notes})' if notes else ''}. The step does "
                "something a graph cannot hold (a host sync, a host-to-device copy, "
                "a launch that stream capture refuses)") from e
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        del new_state
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved0
        self.graph, self.fetch_out = graph, fetches

    # -- the N steps ----------------------------------------------------------
    def run(self, run_keys):
        """One step per run key -> the fetches stacked [N, ...], on the
        device, not waited for."""
        n = len(run_keys)
        rows = [int32_words(self.slots.words(k)) or [0] for k in run_keys]
        table = torch.tensor(rows, dtype=torch.int32)
        if self.device.type == "cuda":
            table = table.pin_memory().to(self.device, non_blocking=True)
        stacked = None
        for i in range(n):
            self.slots.table.copy_(table[i])
            if self.graph is not None:
                self.graph.replay()
                fetches = self.fetch_out
            else:
                new_state, fetches = self._body()
                self._write_state(new_state)
            if stacked is None:
                stacked = [torch.empty((n,) + tuple(f.shape), dtype=f.dtype, device=f.device)
                           for f in fetches]
            with torch.no_grad():
                for s, f in zip(stacked, fetches):
                    s[i].copy_(f)
        return stacked
