"""Device places. A Place names the torch device a program runs on:
`CPUPlace()` is `torch.device("cpu")` and `CUDAPlace(i)` is
`torch.device("cuda", i)`. Asking a CUDAPlace for its device with no card
present raises — nothing drops to the CPU unless the caller asked for it."""

from __future__ import annotations

import torch

__all__ = ["CPUPlace", "CUDAPlace", "CUDAPinnedPlace"]


class Place:
    def __init__(self, device_id: int = 0):
        self.device_id = device_id

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"


class CPUPlace(Place):
    def __init__(self):
        super().__init__(0)

    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPinnedPlace(CPUPlace):
    """Host memory that stages copies to the card: the CPU device."""


class CUDAPlace(Place):
    def torch_device(self) -> torch.device:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{self!r}: no CUDA device is available; pass CPUPlace() "
                "(or --device cpu / AnalysisConfig.disable_gpu()) to run on "
                "the CPU")
        if self.device_id >= torch.cuda.device_count():
            raise RuntimeError(
                f"{self!r}: only {torch.cuda.device_count()} CUDA device(s)")
        return torch.device("cuda", self.device_id)

