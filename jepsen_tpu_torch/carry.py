"""Carry the reference package's data into the port.

A linearizability checker has no weights; what crosses between the JAX
package and this one is data: histories (as `Op.to_dict()` dicts) and
the kernel's packed input buffer (the `_layout` row format, which both
packages share). The tests use both so that the two packages compute on
byte-identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve
from .history import Op
from .independent import KVTuple


def history_from_dicts(op_dicts) -> list[Op]:
    """Ops from `Op.to_dict()`-shaped dicts. Cas payloads a JSON round
    trip turned into lists work as they are (the models unpack either);
    a keyed value from the other package's KVTuple becomes this
    package's KVTuple."""
    out = []
    for d in op_dicts:
        o = Op.from_dict(dict(d))
        v = o.value
        if (isinstance(v, tuple) and getattr(v, "_fields", None)
                == KVTuple._fields and not isinstance(v, KVTuple)):
            # the other package's KVTuple: same fields, this package's type
            o = o.with_(value=KVTuple(*v))
        out.append(o)
    return out


def packed_from_numpy(buf: np.ndarray, msteps, device=None):
    """(packed, msteps) kernel inputs from a packed int32 buffer of
    shape (rows, width) as `_layout` writes it, and a step budget (an
    int for every lane, or one value per lane), on `device`."""
    dev = resolve(device)
    buf = np.ascontiguousarray(buf, dtype=np.int32)
    if buf.ndim != 2:
        raise ValueError(f"packed buffer must be 2-D, got {buf.shape}")
    width = buf.shape[1]
    ms = np.asarray(msteps, dtype=np.int64).reshape(-1)
    if ms.size == 1:
        ms = np.full(width, int(ms[0]), np.int64)
    if ms.size != width:
        raise ValueError(f"{ms.size} step budgets for {width} lanes")
    if ms.min(initial=0) < 0 or ms.max(initial=0) >= 2**31:
        raise ValueError("step budgets must fit int32")
    packed = torch.from_numpy(buf.copy()).to(dev)
    return packed, torch.from_numpy(ms.astype(np.int32)).to(dev)
