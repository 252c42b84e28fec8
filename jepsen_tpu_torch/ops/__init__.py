"""Analysis kernels of the port.

wgl_host — Wing-Gong-Lowe linearizability search on the host (the
           semantics oracle, and the engine for lanes the kernel
           cannot take).
wgl_vec  — the same search for a batch of lanes, one lane per CUDA
           thread (csrc/wgl_vec.cu), with a plain PyTorch version for
           CPU tensors.
wgl_search — the probed-memo search for lanes of any length and a
           vector model state, one lane per CUDA warp
           (csrc/wgl_search.cu, K2's counterpart), with a plain PyTorch
           version; also the lane encodings wgl_row shares.
wgl_row  — that search for lanes of up to 4064 entries, one lane per
           CUDA warp (csrc/wgl_row.cu), with a plain PyTorch version.
linear   — just-in-time linearization over configurations
           (knossos.linear), the entrant that races the WGL search
           under "competition".
pcomp    — P-compositional decomposition of a history into micro-lanes
           (the unordered queue by value, multi-register by key).
"""

#: the smallest shape bucket the search pads a history to
MIN_PAD = 32


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (minimum 2)."""
    return 1 << max(1, int(max(2, x) - 1).bit_length())


def pad_size(n: int, min_pad: int = MIN_PAD) -> int:
    """The shape-bucketing rule: pad to a power of two, floor
    `min_pad`."""
    return max(min_pad, next_pow2(n))
