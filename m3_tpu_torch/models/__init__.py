"""End-to-end pipelines ("models").

The flagship pipeline is the read path: compressed series batch ->
batched M3TSZ decode -> windowed downsample -> aggregate emission.  In
the reference this is the coordinator fan-out read
(ref: src/query/ts/m3db/encoded_step_iterator_generic.go:120
nextParallel + consolidators/step_consolidator.go).  The query path
(``query_pipeline``) serves PromQL fan-out reads from the same blocks:
decode -> per-series merge -> rate/reduce -> group-by.
"""

from m3_tpu_torch.models.read_pipeline import decode_downsample  # noqa: F401
