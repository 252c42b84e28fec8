"""jepsen_tpu_torch: the Jepsen linearizability checker on PyTorch and CUDA.

A port of `jepsen_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100.
Its main path is the per-key linearizability check users run through
`independent.checker(linearizable(model))`:

    independent.IndependentChecker.check
      -> checker.linearizable.Linearizable.check_batch
        -> ops.pcomp.split                 (under "auto", where the model
                                            decomposes: micro-lanes)
        -> per lane, chosen before any launch:
           ops.wgl_vec.analysis_batch      (csrc/wgl_vec.cu, <= 1024
                                            entries)
           ops.wgl_row.analysis_batch      (csrc/wgl_row.cu, scalar
                                            models, <= 4064 entries)
           ops.wgl_search.analysis_batch   (csrc/wgl_search.cu, any
                                            length, vector state)
           ops.wgl_host.analysis           (no int32 encoding)

and, under the algorithms "linear" and "competition", per history:

    ops.linear.analysis                    (knossos.linear, on the host)
    raced against ops.wgl_search.analysis  (K2's counterpart, where the
                                            model encodes; else native or
                                            the host search)

Beside it: the transactional cycle checker (`checker.cycle`, closures in
ops/csrc/closure.cu); the fuzz loop (`fuzz.loop.FuzzLoop`: one launch of
ops/csrc/sim.cu a round, then the scoring closures); and the store
(`store`: the JAX package's on-disk layout, the analysis journal that
lets a killed analysis resume, and each check's artifacts — per-key
results.edn and history.txt, linear.svg, timeline-cycle.html).

The package imports torch and numpy only — never jax and nothing of
`jepsen_tpu`; what it needs from there it keeps as its own copy.
Public entry points take `device=None`, which means "cuda" and raises
when CUDA is absent; pass `device="cpu"` to run the plain PyTorch
versions of the kernels (the tests do).
"""

from .device import describe, resolve

__all__ = ["describe", "resolve"]
