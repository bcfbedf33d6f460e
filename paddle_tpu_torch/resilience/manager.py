"""CheckpointManager: cadence, discovery and restore-or-initialize, the
port's copy of `paddle_tpu/resilience/manager.py`.

Discovery (`latest_step`) skips corrupt or uncommitted snapshots and
restores the newest one that validates, so a torn save costs at most one
interval and never a mixed state. Two restore surfaces:

- static graph: `restore_or_initialize(executor, program, startup)` runs
  the startup program, then overwrites every persistable the snapshot
  carries (parameters, optimizer accumulators, BN statistics), rewinds the
  executor's seed counter (the dropout keys of the next steps) and every
  tracked DataLoader's cursor (the batches of the next steps). A restored
  value takes its var's IR dtype on the executor's device, as `io.load_vars`
  does: a JAX snapshot's int32 counter lands as int64.
- dygraph: `restore_or_initialize_dygraph(layer, optimizer)` restores
  `Layer.state_dict()` and `Optimizer.state_dict()` by name.

`attach(program)` wires auto-checkpointing into `Executor.run`: each run of
that program counts one step, and steps on the `should_save` cadence
snapshot asynchronously (AsyncSnapshotEngine).

Mesh-elastic restore: under a mesh (`restore(mesh=...)`, or the current
one) each var whose manifest records a spec is re-placed on that mesh
from it (`_place_elastic`): a ZeRO-1 moment written on 2 ranks lands as a
DTensor of this rank's rows on a mesh of any batch size that divides it,
and whole on the 1x1x1 mesh; a var whose recorded axis no longer divides
its dim degrades to replicated with a warning, as
`parallel.mesh.sharding_with_degrade` reports it.
"""

from __future__ import annotations

import logging
import shutil
import time

import numpy as np

from .snapshot import (
    AsyncSnapshotEngine,
    SnapshotError,
    _host,
    list_snapshots,
    load_snapshot,
    read_manifest,
    snapshot_dir,
    validate_snapshot,
    write_snapshot,
)

__all__ = ["CheckpointManager"]

_log = logging.getLogger(__name__)

_DY_PARAM = "param:"
_DY_OPT = "opt:"


def _persistable_state(program, scope):
    """name -> value for every persistable of `program` with a value in
    `scope` (declared but never initialized vars are skipped at save, so
    they are never demanded at restore)."""
    state = {}
    for v in program.list_vars():
        if not getattr(v, "persistable", False) or getattr(v, "is_data", False):
            continue
        if scope.has(v.name) and scope.get(v.name) is not None:
            state[v.name] = scope.get(v.name)
    return state


class CheckpointManager:
    def __init__(self, root, save_interval=1, keep=3, async_save=True):
        self.root = str(root)
        self.save_interval = int(save_interval)
        self.keep = int(keep)
        self._engine = (
            AsyncSnapshotEngine(self.root, keep=keep) if async_save else None)
        self._auto_step = 0  # attach() cadence counter
        self._autosave_suspended = False  # NanGuard holds this on a streak
        self._readers = {}  # name -> tracked DataLoader

    @property
    def engine(self):
        """The AsyncSnapshotEngine (None with async_save=False)."""
        return self._engine

    # -- data-pipeline cursor --------------------------------------------
    def track_reader(self, loader, name="reader0"):
        """Register a DataLoader whose cursor (epoch, batch, shuffle seed)
        rides in every snapshot manifest's `extra` beside `seed_counter`
        and is rewound by restore, so a resumed run fetches exactly the
        batches the uninterrupted run would have. Returns self."""
        if not hasattr(loader, "state_dict"):
            raise TypeError(
                f"track_reader needs a DataLoader with state_dict(), got "
                f"{type(loader).__name__}")
        self._readers[str(name)] = loader
        return self

    def _reader_cursors(self):
        return {n: dict(r.state_dict()) for n, r in self._readers.items()}

    def _rewind_readers(self, manifest):
        cursors = manifest.get("extra", {}).get("reader_cursors") or {}
        for name, cursor in cursors.items():
            loader = self._readers.get(name)
            if loader is not None:
                loader.set_state_dict(cursor)

    # -- cadence ---------------------------------------------------------
    def should_save(self, step: int) -> bool:
        return step >= 0 and step % self.save_interval == 0

    # -- save ------------------------------------------------------------
    def save(self, step, state=None, program=None, scope=None,
             executor=None, extra=None, blocking=False):
        """Snapshot `state` (or `program`'s persistables from `scope`).
        Async by default; `blocking=True` commits before returning (the
        preemption handler's final save) -> the committed path, or None
        when queued. `executor` records its seed counter in the manifest."""
        if state is None:
            if program is None:
                raise ValueError("save() needs state= or program=")
            if scope is None:
                from ..scope import global_scope

                scope = global_scope()
            state = _persistable_state(program, scope)
        if not state:
            raise ValueError(
                "nothing to snapshot: no persistable has a settled value "
                "(run the startup program first)")
        extra = dict(extra or {})
        if executor is not None:
            extra["seed_counter"] = int(executor._seed_counter)
        if self._readers and "reader_cursors" not in extra:
            # taken here on the training thread: the loader has yielded
            # exactly the batches the steps so far consumed
            extra["reader_cursors"] = self._reader_cursors()
        if self._engine is not None and not blocking:
            self._engine.submit(int(step), state, extra=extra)
            return None
        return write_snapshot(self.root, int(step), state, extra=extra,
                              keep=self.keep)

    def drain(self):
        """Wait for in-flight async saves (no-op in sync mode)."""
        if self._engine is not None:
            self._engine.drain()

    def close(self):
        if self._engine is not None:
            self._engine.close()

    # -- discovery -------------------------------------------------------
    def all_steps(self):
        """Committed snapshot steps, newest first (validity not checked)."""
        return [s for s, _ in list_snapshots(self.root)]

    def latest_step(self, deep=False):
        """Newest step whose snapshot validates (manifest and file size;
        `deep=True` adds every crc32), or None."""
        for step, path in list_snapshots(self.root):
            try:
                validate_snapshot(path, deep=deep)
            except SnapshotError:
                continue
            return step
        return None

    def _iter_valid(self, names=None, step=None, kind=None):
        """(step, arrays, manifest) newest first, skipping snapshots that
        fail their crc32 at read time. `step` / `kind` filter on the
        manifest before the payload is read."""
        for got_step, path in list_snapshots(self.root):
            if step is not None and got_step != step:
                continue
            if kind is not None:
                m = read_manifest(path)
                if m is None or m.get("extra", {}).get("kind") != kind:
                    continue
            try:
                arrays, manifest = load_snapshot(path, names=names)
            except SnapshotError:
                continue
            yield got_step, arrays, manifest

    # -- snapshot-vs-program validation ----------------------------------
    @staticmethod
    def _mismatches(program, chosen):
        """Shape and dtype conflicts between restored arrays and the
        program's declarations, as offender strings. Only concrete declared
        shapes take part (-1 / None is a batch dim). Dtypes compare as the
        JAX package narrows them on the device (int64 -> int32, float64 ->
        float32), so a snapshot of either package passes, and a bfloat16
        var takes the float32 a snapshot widens it to."""
        from ..framework import convert_dtype

        offenders = []
        block = program.global_block()
        for name in sorted(chosen):
            v = block._find_var_recursive(name)
            if v is None:
                continue
            arr = np.asarray(chosen[name])
            shape = getattr(v, "shape", None)
            if (shape is not None
                    and all(d is not None and int(d) >= 0 for d in shape)
                    and tuple(int(d) for d in shape) != tuple(arr.shape)):
                offenders.append(
                    f"{name}: snapshot shape {tuple(arr.shape)} != program "
                    f"shape {tuple(int(d) for d in shape)}")
                continue
            want = convert_dtype(v.dtype) if v.dtype is not None else None
            narrow = {"int64": "int32", "float64": "float32", "bfloat16": "float32"}
            got = narrow.get(str(arr.dtype), str(arr.dtype))
            if want is not None and got != narrow.get(want, want):
                offenders.append(
                    f"{name}: snapshot dtype {arr.dtype} != program dtype "
                    f"{want}")
        return offenders

    @staticmethod
    def _placed(chosen, program, executor):
        """Each restored array as a tensor of its var's IR dtype on the
        executor's device (the array itself when there is no executor)."""
        if executor is None:
            return dict(chosen)
        from ..executor import as_tensor

        block = program.global_block() if program is not None else None
        out = {}
        for name, arr in chosen.items():
            v = block._find_var_recursive(name) if block is not None else None
            out[name] = as_tensor(arr, v.dtype if v is not None else None, executor.device)
        return out

    @staticmethod
    def _place(chosen, program, scope, executor):
        """`_placed` into `scope`."""
        for name, value in CheckpointManager._placed(chosen, program, executor).items():
            scope.set(name, value)

    @staticmethod
    def _place_elastic(chosen, manifest, mesh, scope, program=None, executor=None):
        """Re-place restored arrays under `mesh` from each var's RECORDED
        PartitionSpec. The spec is mesh-shape-agnostic (P('batch') means
        "shard dim 0 over however many ranks the batch axis has NOW"), so
        one manifest restores onto any mesh: a sharded var lands as a
        DTensor of this rank's rows. A dim whose recorded axis no longer
        divides it degrades to replicated with a warning, never a crash
        and never a wrong shard; a var without a spec, or a mesh without a
        process group, restores whole. Counters: `restore_place_ms`, and
        the gauges `restore_resharded_vars` / `restore_degraded_vars`."""
        from .. import profiler
        from ..parallel.mesh import sharding_with_degrade, spec_from_manifest

        var_meta = manifest.get("vars", {})
        src_mesh = manifest.get("mesh")
        dst_mesh = {a: int(s) for a, s in mesh.shape.items()}
        whole, sharded = {}, {}
        degraded = recorded = 0
        for name, arr in chosen.items():
            spec_entry = var_meta.get(name, {}).get("spec")
            if not spec_entry:
                whole[name] = arr
                continue
            recorded += 1
            shape = tuple(np.asarray(arr).shape)
            placements, fell = sharding_with_degrade(
                mesh, spec_from_manifest(spec_entry), shape)
            if fell:
                degraded += 1
                detail = "; ".join(
                    f"dim{d} (size {sz}) not divisible by axis group "
                    f"{list(axes)} (extent {grp})" for d, axes, sz, grp in fell)
                _log.warning(
                    "mesh-elastic restore: %s recorded spec %s does not fit mesh %s "
                    "— degrading to replicated (%s)", name, spec_entry, dst_mesh, detail)
            if mesh.device_mesh is None or all(p.is_replicate() for p in placements):
                whole[name] = arr
            else:
                sharded[name] = (arr, placements)
        if src_mesh and src_mesh != dst_mesh:
            _log.info(
                "mesh-elastic restore: snapshot written on mesh %s re-placed onto "
                "mesh %s (%d sharded var(s), %d degraded to replicated)",
                src_mesh, dst_mesh, recorded, degraded)
        CheckpointManager._place(whole, program, scope, executor)
        if sharded:
            import torch
            from torch.distributed.tensor import DTensor

            t0 = time.perf_counter()
            staged = CheckpointManager._placed({n: a for n, (a, _) in sharded.items()},
                                               program, executor)
            for name, (_, placements) in sharded.items():
                t = staged[name]
                if not isinstance(t, torch.Tensor):  # no executor: a host array
                    t = torch.from_numpy(np.ascontiguousarray(t))
                for ax, pl in zip(mesh.axis_names, placements):
                    if pl.is_shard():
                        n = mesh.shape[ax]
                        rows = t.shape[pl.dim] // n
                        t = t.narrow(pl.dim, mesh.local_rank(ax) * rows, rows)
                scope.set(name, DTensor.from_local(t.contiguous(), mesh.device_mesh,
                                                   placements, run_check=False))
            profiler.bump_counter("restore_place_ms",
                                  int((time.perf_counter() - t0) * 1000))
        # "resharded": the manifest recorded a mesh and it differs; every
        # var with a recorded spec counts, degraded or not
        profiler.set_counter(
            "restore_resharded_vars",
            recorded if (src_mesh and src_mesh != dst_mesh) else 0)
        profiler.set_counter("restore_degraded_vars", degraded)

    # -- restore: static graph -------------------------------------------
    def restore(self, program=None, scope=None, executor=None, step=None,
                require_finite=False, strict=False, mesh=None):
        """Restore the newest valid snapshot (or exactly `step`) into
        `scope`. With `program`, only its persistables restore: snapshot
        vars the program does not declare are ignored, program
        persistables the snapshot lacks keep their current values
        (`strict=True` makes both errors, listing the offenders). A shape
        or dtype mismatch always raises, listing every offender, before a
        value lands in `scope`. `require_finite=True` skips, and deletes,
        snapshots whose float state holds a NaN or Inf (the NanGuard
        rollback: the cadence may have saved a poisoned step). `mesh=` is
        the target mesh (default: the current one); under a mesh each var
        with a recorded spec is re-placed from it (`_place_elastic`).
        Returns the restored step, or None."""
        if scope is None:
            from ..scope import global_scope

            scope = global_scope()
        if strict and program is None:
            raise ValueError("restore(strict=True) requires program=")
        wanted = None
        if program is not None:
            wanted = {
                v.name for v in program.list_vars()
                if getattr(v, "persistable", False)
                and not getattr(v, "is_data", False)
            }
        for got_step, arrays, manifest in self._iter_valid(step=step):
            chosen = {name: arr for name, arr in arrays.items()
                      if wanted is None or name in wanted}
            if not chosen:
                continue  # a snapshot of an unrelated program
            if program is not None:
                offenders = self._mismatches(program, chosen)
                if strict:
                    offenders += [
                        f"{n}: in snapshot but not a program persistable"
                        for n in sorted(set(arrays) - wanted)
                    ] + [
                        f"{n}: program persistable missing from snapshot"
                        for n in sorted(wanted - set(arrays))
                    ]
                if offenders:
                    raise SnapshotError(
                        f"snapshot step {got_step} does not match the "
                        f"program ({len(offenders)} offender(s)); nothing "
                        "was restored:\n  " + "\n  ".join(offenders))
            if require_finite and any(
                    np.issubdtype(a.dtype, np.floating) and not np.isfinite(a).all()
                    for a in chosen.values()):
                # never let a poisoned snapshot become a later resume point
                shutil.rmtree(snapshot_dir(self.root, got_step), ignore_errors=True)
                continue
            from ..parallel.mesh import current_mesh

            target = mesh if mesh is not None else current_mesh()
            if target is not None:
                self._place_elastic(chosen, manifest, target, scope, program, executor)
            else:
                self._place(chosen, program, scope, executor)
            if executor is not None:
                sc = manifest.get("extra", {}).get("seed_counter")
                if sc is not None:
                    executor._seed_counter = int(sc)
            self._rewind_readers(manifest)
            from .. import profiler

            profiler.set_counter("resume_step", int(got_step))
            self._auto_step = int(got_step) + 1
            return got_step
        return None

    def restore_or_initialize(self, executor, program, startup_program=None,
                              scope=None, require_finite=True, mesh=None):
        """Run `startup_program` (every declared persistable gets a value),
        then overwrite from the newest valid, finite snapshot. Returns the
        restored step, or -1 after a fresh initialize. `mesh=` passes the
        target mesh through to `restore`."""
        if startup_program is not None:
            executor.run(startup_program, scope=scope)
        step = self.restore(program=program, scope=scope, executor=executor,
                            require_finite=require_finite, mesh=mesh)
        return -1 if step is None else step

    # -- restore: dygraph -------------------------------------------------
    def save_dygraph(self, step, layer_state, opt_state=None, extra=None,
                     blocking=False):
        """Snapshot a dygraph `Layer.state_dict()` (and an
        `Optimizer.state_dict()`) namespaced in one snapshot, so parameters
        and optimizer state commit together. The values are pulled to the
        host here: the JIT bridge updates its buffers in place."""
        state = {_DY_PARAM + k: _host(v) for k, v in layer_state.items()}
        for k, v in (opt_state or {}).items():
            state[_DY_OPT + k] = _host(v)
        extra = dict(extra or {})
        extra["kind"] = "dygraph"
        if self._engine is not None and not blocking:
            self._engine.submit(int(step), state, extra=extra)
            return None
        return write_snapshot(self.root, int(step), state, extra=extra,
                              keep=self.keep)

    def restore_or_initialize_dygraph(self, layer, optimizer=None):
        """Restore the newest valid dygraph snapshot into `layer` (and
        `optimizer`) -> its step, or -1 (the layer keeps its constructor's
        initialization)."""
        for step, arrays, _ in self._iter_valid(kind="dygraph"):
            params = {k[len(_DY_PARAM):]: v for k, v in arrays.items()
                      if k.startswith(_DY_PARAM)}
            opt_state = {k[len(_DY_OPT):]: v for k, v in arrays.items()
                         if k.startswith(_DY_OPT)}
            layer.set_dict(params)
            if optimizer is not None and opt_state:
                optimizer.set_state_dict(opt_state)
            from .. import profiler

            profiler.set_counter("resume_step", int(step))
            self._auto_step = int(step) + 1
            return step
        return -1

    # -- executor wiring ---------------------------------------------------
    def attach(self, program):
        """Auto-checkpoint this program: every `Executor.run` of it counts
        one step and snapshots on the should_save cadence. Returns self."""
        program._ckpt_manager = self
        return self

    def detach(self, program):
        if getattr(program, "_ckpt_manager", None) is self:
            program._ckpt_manager = None

    def suspend_autosave(self):
        """Stop cadence saves without detaching (NanGuard holds this during
        a non-finite streak)."""
        self._autosave_suspended = True

    def resume_autosave(self):
        self._autosave_suspended = False

    def _on_executor_step(self, program, scope, executor, steps=1):
        """Called by `Executor.run` after the state write-back. `steps` > 1
        is one dispatch that advanced several steps: the counter advances
        by all of them and one snapshot of the final state lands if a
        cadence boundary was crossed."""
        first = self._auto_step
        self._auto_step += int(steps)
        if self._autosave_suspended:
            return self._auto_step - 1
        hits = [s for s in range(first, self._auto_step) if self.should_save(s)]
        if hits:
            self.save(hits[-1] if steps == 1 else self._auto_step - 1,
                      program=program, scope=scope, executor=executor)
        return self._auto_step - 1
