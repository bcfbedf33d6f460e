"""save/load persistables and the inference export, in the JAX package's
on-disk formats: by default one `.npy` per var in the directory, plus
`__model__.json` for the pruned program; with `filename=` (and the
export's `params_filename=`) one `np.savez` blob at `dirname/filename`,
`.npz` appended when it is missing. Either package reads what the other
wrote.

Every file is published through `resilience.snapshot.atomic_write_*`
(temp file + os.replace; fsync only with PADDLE_TPU_CKPT_FSYNC=1), and
`save_inference_model` writes the params first and `__model__.json` last,
so a reader that finds the model file finds its params too. `load_vars`
raises on missing tensors unless `allow_missing=True`. numpy has no
bfloat16, so saving a bfloat16 value raises rather than widening it."""

from __future__ import annotations

import io as _bytesio
import json
import os

import numpy as np
import torch

from ..executor import as_tensor
from ..framework import Parameter, Program, Variable, default_main_program
from ..resilience.snapshot import atomic_write_array, atomic_write_bytes
from ..scope import global_scope, to_numpy

__all__ = [
    "save_vars",
    "save_params",
    "save_persistables",
    "load_vars",
    "load_params",
    "load_persistables",
    "save_inference_model",
    "load_inference_model",
    "set_persistables_from_numpy",
]


def _is_persistable(v):
    return v.persistable and not v.is_data


def _is_parameter(v):
    return isinstance(v, Parameter)


def _var_file(dirname, name):
    return os.path.join(dirname, name.replace("/", "__") + ".npy")


def _blob_path(dirname, filename):
    path = os.path.join(dirname, filename)
    return path if path.endswith(".npz") else path + ".npz"


def _host_array(name, value):
    if isinstance(value, torch.Tensor) and value.dtype == torch.bfloat16:
        raise TypeError(
            f"save_vars: {name!r} is bfloat16, which numpy cannot hold; "
            "cast it to float32 in the program before saving")
    return to_numpy(value)


def save_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None):
    """The current scope's values of `vars` (or of the program's vars that
    `predicate` takes, persistables by default): one atomically written
    `.npy` each, or with `filename` one `.npz` blob."""
    program = main_program or default_main_program()
    if vars is None:
        vars = [v for v in program.list_vars() if (predicate or _is_persistable)(v)]
    os.makedirs(dirname, exist_ok=True)
    scope = global_scope()
    blob = {}
    for v in vars:
        name = v.name if isinstance(v, Variable) else v
        if not scope.has(name) or scope.get(name) is None:
            continue
        arr = _host_array(name, scope.get(name))
        if filename:
            blob[name] = arr
        else:
            atomic_write_array(_var_file(dirname, name), arr)
    if filename:
        buf = _bytesio.BytesIO()
        np.savez(buf, **blob)
        atomic_write_bytes(_blob_path(dirname, filename), buf.getvalue())


def save_params(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program, predicate=_is_parameter,
                     filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program, predicate=_is_persistable,
                     filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None, allow_missing=False):
    """Load into the current scope, as tensors of each var's IR dtype on
    the executor's device (the JAX package writes int64 vars as int32),
    or as numpy arrays when `executor` is None. `filename` reads one `.npz`
    blob."""
    program = main_program or default_main_program()
    if vars is None:
        vars = [v for v in program.list_vars() if (predicate or _is_persistable)(v)]
    block = program.global_block()
    scope = global_scope()

    def put(v, name, arr):
        if executor is None:
            scope.set(name, arr)
            return
        var = v if isinstance(v, Variable) else block._find_var_recursive(name)
        scope.set(name, as_tensor(arr, var.dtype if var is not None else None,
                                  executor.device))

    missing = []
    if filename:
        with np.load(_blob_path(dirname, filename)) as blob:
            for v in vars:
                name = v.name if isinstance(v, Variable) else v
                if name in blob.files:
                    put(v, name, blob[name])
                else:
                    missing.append(name)
    else:
        for v in vars:
            name = v.name if isinstance(v, Variable) else v
            path = _var_file(dirname, name)
            if os.path.exists(path):
                put(v, name, np.load(path))
            else:
                missing.append(name)
    if missing and not allow_missing:
        raise RuntimeError(
            f"load_vars: {len(missing)} var(s) missing from checkpoint "
            f"dir {dirname!r}: {sorted(missing)[:16]}"
            f"{' ...' if len(missing) > 16 else ''} — the checkpoint is "
            "torn or from a different program; pass allow_missing=True "
            "to restore partially"
        )


def load_params(executor, dirname, main_program=None, filename=None,
                allow_missing=False):
    return load_vars(executor, dirname, main_program, predicate=_is_parameter,
                     filename=filename, allow_missing=allow_missing)


def load_persistables(executor, dirname, main_program=None, filename=None,
                      allow_missing=False):
    return load_vars(executor, dirname, main_program, predicate=_is_persistable,
                     filename=filename, allow_missing=allow_missing)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None):
    """Prune to the inference subgraph and persist it: params first (one
    `.npz` with `params_filename`), `__model__.json` last."""
    program = main_program or default_main_program()
    targets = target_vars if isinstance(target_vars, (list, tuple)) else [target_vars]
    pruned = program.clone(for_test=True)._prune([t.name for t in targets])
    os.makedirs(dirname, exist_ok=True)
    save_persistables(executor, dirname, pruned, filename=params_filename)
    meta = {
        "program": pruned.to_dict(),
        "feed_names": list(feeded_var_names),
        "fetch_names": [t.name for t in targets],
    }
    atomic_write_bytes(os.path.join(dirname, model_filename or "__model__.json"),
                        json.dumps(meta).encode("utf-8"))
    return [t.name for t in targets]


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """-> (program, feed_names, fetch_vars)."""
    with open(os.path.join(dirname, model_filename or "__model__.json")) as f:
        meta = json.load(f)
    program = Program.from_dict(meta["program"])
    load_persistables(executor, dirname, program, filename=params_filename)
    block = program.global_block()
    fetch_vars = [block.var(n) for n in meta["fetch_names"]]
    return program, meta["feed_names"], fetch_vars


def set_persistables_from_numpy(scope, arrays: dict, device):
    """Put numpy arrays (e.g. the JAX package's persistables, fetched from
    its scope) into `scope` by name, as tensors on `device`. Dtypes are
    kept: ids stay int64, floats keep their width."""
    device = torch.device(device)
    for name, arr in arrays.items():
        scope.set(name, torch.from_numpy(np.array(arr, copy=True)).to(device))
