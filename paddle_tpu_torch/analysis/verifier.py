"""The verifier's finding record (the port's copy of `Finding` in
`paddle_tpu/analysis/verifier.py`); the IR verifier itself is ROADMAP
Queue 1 item 11."""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["Finding"]


class Finding(NamedTuple):
    code: str
    message: str
    block_idx: int | None = None
    op_idx: int | None = None
    op_type: str | None = None
    var: str | None = None
    callsite: str | None = None

    def __str__(self):
        loc = ""
        if self.op_idx is not None:
            loc = f" block {self.block_idx} op #{self.op_idx}"
            if self.op_type:
                loc += f" {self.op_type!r}"
        var = f" (var {self.var!r})" if self.var else ""
        site = f" [created at {self.callsite}]" if self.callsite else ""
        return f"[{self.code}]{loc}: {self.message}{var}{site}"
