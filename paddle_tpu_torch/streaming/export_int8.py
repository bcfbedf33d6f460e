"""The int8 export's tolerance error, alone: the port of
`paddle_tpu/streaming/export_int8.py:ExportToleranceError`.

The model registry's deploy verify (`inference/registry.py`) and the
server's `/admin/deploy` (409) raise and catch it: a candidate version
whose probe outputs drift past the tolerance is refused with the error the
int8 export gives a drifted bundle. The rest of this module (weight
quantisation, the int8 export and its self-verify) is ROADMAP Queue 1 item
10."""

from __future__ import annotations

__all__ = ["ExportToleranceError"]


class ExportToleranceError(RuntimeError):
    """The candidate drifted past `tolerance` from the reference on the
    probe batch: max |new - old| / (max |old| + 1e-12) > tolerance."""
