"""m3_tpu_torch — the PyTorch/CUDA port of m3_tpu.

The JAX package ``m3_tpu`` stays the reference; this package re-implements
its device paths with PyTorch for the plumbing and hand-written CUDA
kernels (``csrc/``) for the hot loops, and is held against the reference
on the same inputs by the ``tests/test_torch_*.py`` files.

Rules this package keeps:

- it imports ``torch`` and numpy, never ``jax`` and nothing of ``m3_tpu``
  (host-only modules it needs are copied in with their imports rewritten);
- entry points run on the CUDA device unless the caller passes
  ``device="cpu"`` or CPU tensors; without CUDA the default raises;
- every kernel wrapper has two branches: a CUDA tensor launches the
  kernel (or raises), a CPU tensor runs the plain PyTorch version that
  sits beside it.

Layout mirrors the reference so each module's counterpart is easy to find:
    ops/        kernels' wrappers + plain versions, host oracles
    models/     end-to-end pipelines (read path: decode + downsample;
                query path: decode -> merge -> rate/reduce -> group-by)
    utils/      time units, bit IO
    csrc/       CUDA C++ sources, built by ops/_build.py at first use
"""

__version__ = "0.1.0"
