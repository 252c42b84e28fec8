"""Device resolution: the port runs on the card unless told otherwise.

`resolve(None)` means CUDA and raises when it is absent — a check that
silently fell back to the CPU would report CPU times under a GPU
label. Callers that want the plain CPU versions pass `device="cpu"`.
"""

from __future__ import annotations

import torch


class CudaUnavailable(RuntimeError):
    """The default device (CUDA) was asked for on a host without it."""


class KernelError(RuntimeError):
    """A kernel launch on the card failed (the wrapper's launcher
    returned a CUDA error)."""


def resolve(device=None) -> torch.device:
    """`device` (None = "cuda") as a torch.device; raises
    CudaUnavailable for a CUDA device when CUDA is not present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise CudaUnavailable(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def describe(device=None) -> dict:
    """Name and compute capability of the resolved device."""
    dev = resolve(device)
    if dev.type == "cpu":
        return {"type": "cpu", "name": "cpu", "capability": None}
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    major, minor = torch.cuda.get_device_capability(idx)
    return {"type": "cuda", "index": idx,
            "name": torch.cuda.get_device_name(idx),
            "capability": f"{major}.{minor}"}
