"""jepsen_tpu_torch: the Jepsen linearizability checker on PyTorch and CUDA.

A port of `jepsen_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100.
This first slice covers the per-key linearizability check users run
through `independent.checker(linearizable(model))`:

    independent.IndependentChecker.check
      -> checker.linearizable.Linearizable.check_batch
        -> ops.wgl_vec.analysis_batch      (encode + bit-pack the lanes)
          -> ops.wgl_vec.search            (the hand-written CUDA kernel,
                                            ops/csrc/wgl_vec.cu)

The package imports torch and numpy only — never jax and nothing of
`jepsen_tpu`; what it needs from there it keeps as its own copy.
Public entry points take `device=None`, which means "cuda" and raises
when CUDA is absent; pass `device="cpu"` to run the plain PyTorch
versions of the kernels (the tests do).
"""

from .device import describe, resolve

__all__ = ["describe", "resolve"]
