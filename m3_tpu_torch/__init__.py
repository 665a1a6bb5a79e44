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
    ops/        kernels' wrappers + plain versions, host oracles, the
                batched encoder
    models/     end-to-end pipelines (read path: decode + downsample;
                query path: decode -> merge -> rate/reduce -> group-by)
    aggregator/ the write side's rollups: ElemPool (device slot state)
                and Aggregator
    storage/    the storage node: database, shards (the seal's batched
                encode), filesets, the tag index, AggregateTiles
    cache/      the read caches (decoded blocks, postings, fileset readers)
    metrics/    host-only metrics model (policies, pipelines, rules)
    attribution/, observe/
                host-only per-tenant accounting and the task ledger
    utils/      time units, bit IO, hashing, the native (g++) loader,
                logging/metrics, tracing, fault points
    csrc/       CUDA C++ sources, built by ops/_build.py at first use
"""

__version__ = "0.1.0"
