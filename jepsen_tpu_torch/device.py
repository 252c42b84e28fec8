"""Device resolution: the port runs on the card unless told otherwise.

`resolve(None)` means CUDA and raises when it is absent — a check that
silently fell back to the CPU would report CPU times under a GPU
label. Callers that want the plain CPU versions pass `device="cpu"`.

`devices(spec)` is the device list of the multi-device engines (the
port's counterpart of `jax.devices()` in the JAX package's mesh paths):
every CUDA card by default, or the entries given, which may repeat a
device — `["cuda:0"] * 2` deals over one card as over two, and
`["cpu"] * 3` runs the same deal on the plain versions.
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


def devices(spec=None) -> list:
    """The device list a multi-device engine deals over: None means
    every CUDA device, cuda:0 .. cuda:{count-1} (CudaUnavailable without
    CUDA); a list or tuple is resolved entry by entry (repeats allowed,
    "cuda" taken as the current device). Mixing the CPU and CUDA raises
    ValueError, as does an empty list."""
    if spec is None:
        resolve(None)
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if isinstance(spec, (str, torch.device)) or not isinstance(
            spec, (list, tuple)):
        raise ValueError(f"devices takes a list of devices, got {spec!r}")
    out = []
    for d in spec:
        dev = resolve(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    if not out:
        raise ValueError("an empty device list")
    if len({d.type for d in out}) > 1:
        raise ValueError(f"devices mixes the CPU and CUDA: {out}")
    return out


def mesh(device=None) -> list | None:
    """The device list a mesh route deals over, or None: `devices()`
    when the caller asked for the default device (None) and it lists two
    or more; an explicit device, a host without CUDA and one card all
    give None (the single-device path)."""
    if device is not None:
        return None
    try:
        devs = devices()
    except CudaUnavailable:
        return None
    return devs if len(devs) >= 2 else None


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
