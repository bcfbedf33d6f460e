"""save_dygraph / load_dygraph (paddle_tpu/dygraph/checkpoint.py; reference
dygraph/checkpoint.py, with learning.py's `.pdparams` / `.pdopt` split).
One .npz per state dict, `<path>.pdparams.npz` for a layer's state and
`<path>.pdopt.npz` for an optimizer's, the JAX package's archives: either
package reads what the other wrote. Each is published through the port's
atomic write (io/__init__.py), so a crash never leaves a truncated
archive."""

from __future__ import annotations

import io as _io
import os

import numpy as np

from ..io import _atomic_write_bytes

__all__ = ["save_dygraph", "load_dygraph", "save_persistables", "load_persistables"]


def _npz_bytes(arrays: dict) -> bytes:
    buf = _io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
    return buf.getvalue()


def _is_opt_state(state_dict) -> bool:
    # Optimizer.state_dict() carries the '@step' counter and
    # '<param>#<slot>' keys
    return "@step" in state_dict or any("#" in k for k in state_dict)


def save_dygraph(state_dict, model_path, optimizer=None):
    """A `Layer.state_dict()` -> `<path>.pdparams.npz`, an
    `Optimizer.state_dict()` (told apart by its '@step' / '#slot' keys)
    -> `<path>.pdopt.npz`; `optimizer=` (an Optimizer or its state dict)
    saves both in one call."""
    d = os.path.dirname(model_path)
    if d:
        os.makedirs(d, exist_ok=True)
    if hasattr(state_dict, "state_dict"):
        state_dict = state_dict.state_dict()
    if _is_opt_state(state_dict):
        _atomic_write_bytes(model_path + ".pdopt.npz", _npz_bytes(state_dict))
        return
    _atomic_write_bytes(model_path + ".pdparams.npz", _npz_bytes(state_dict))
    if optimizer is not None:
        opt_state = (optimizer.state_dict() if hasattr(optimizer, "state_dict")
                     else dict(optimizer))
        _atomic_write_bytes(model_path + ".pdopt.npz", _npz_bytes(opt_state))


def load_dygraph(model_path):
    """(param_dict | None, optimizer_dict | None), each side from its
    archive where it exists; raises only when neither does. Feed the
    optimizer dict to `Optimizer.set_state_dict`."""
    params = None
    path = model_path + ".pdparams.npz"
    if os.path.exists(path):
        with np.load(path) as z:
            params = {k: z[k] for k in z.files}
    opt = None
    opt_path = model_path + ".pdopt.npz"
    if os.path.exists(opt_path):
        with np.load(opt_path) as z:
            opt = {k: z[k] for k in z.files}
    if params is None and opt is None:
        raise FileNotFoundError(path)
    return params, opt


def save_persistables(model_dict, dirname="save_dir", optimizers=None):
    """reference dygraph/checkpoint.py:27: a layer's state dict (and the
    optimizers' state) under `dirname`/persistables."""
    base = os.path.join(dirname, "persistables")
    save_dygraph(model_dict, base)
    if optimizers is None:
        return
    opts = optimizers if isinstance(optimizers, (list, tuple)) else [optimizers]
    merged = {}
    for i, opt in enumerate(opts):
        state = opt.state_dict() if hasattr(opt, "state_dict") else dict(opt)
        prefix = f"{i}/" if len(opts) > 1 else ""
        for k, v in state.items():
            merged[prefix + k] = v
    if merged:
        _atomic_write_bytes(base + ".pdopt.npz", _npz_bytes(merged))


def load_persistables(dirname="save_dir"):
    """reference dygraph/checkpoint.py:80: the restored name -> ndarray
    dict (the optimizers' side: `load_dygraph(dirname/persistables)[1]`)."""
    params, _ = load_dygraph(os.path.join(dirname, "persistables"))
    return params
