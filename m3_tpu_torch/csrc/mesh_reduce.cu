// Ordered cross-shard reduce of a mesh collective on Hopper (MK1).
//
// Replaces the reduction inside jax.lax.psum / pmin / pmax / psum_scatter of
// the reference's series-sharded paths: m3_tpu/parallel/mesh.py:72-88
// consolidate_windows, m3_tpu/models/query_pipeline.py:814-868
// _grouped_reduce_sharded (and the fleet psum of device_rate_sharded and
// absent's presence psum), read_pipeline.py:102-104 and
// ingest_pipeline.py:74-78.  The reference's collectives run over ICI between
// TPU chips; in the port each shard's partial lands in one row of a
// [n_shards, N] stack (across processes through an NCCL all_gather) and this
// kernel reduces the stack over its shard axis.
//
// Order: one thread per output element walks the shards in ascending order,
// so every rank, whatever NCCL's own order would be, gets the same bits, and
// one rank holding 8 shards gives the bits of 2 ranks holding 4 each.  The
// folds are XLA:CPU's all-reduce, probed on its 8-device virtual mesh: a
// sum starts from 0.0 (so -0.0 shards sum to +0.0, NaN propagates); min
// starts from +inf and takes a shard's value only when it is strictly below
// (NaN is skipped, an all-NaN column gives +inf, of -0.0 and +0.0 the earlier
// shard's wins); max likewise from -inf.  The i64 form sums integers exactly
// (the ingest's sealed-bytes accounting).
//
// An optional owned range [lo, hi) of the N axis reduces only that range (a
// shard's chunk of a psum_scatter).
//
// Adjacent threads read adjacent addresses of each shard's row, so every
// load is coalesced.  What bounds it on an H100: bytes (the stack read once,
// the result written once); the stacks of the mesh paths are small (8 x 60
// for the read path's fleet, 8 x 35,500 for a group-by), so in practice one
// launch's latency bounds it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Op : int { kSum = 0, kMin = 1, kMax = 2 };
enum Dtype : int { kF64 = 0, kI64 = 1 };
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) reduce_f64(const double* __restrict__ p,
                                                        long long n_shards, long long N,
                                                        long long lo, long long n_out, int op,
                                                        double* __restrict__ out) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_out) return;
  const double* col = p + lo + j;
  double acc = op == kSum ? 0.0 : op == kMin ? INFINITY : -INFINITY;
  for (long long k = 0; k < n_shards; ++k) {
    const double v = col[k * N];
    if (op == kSum) {
      acc = __dadd_rn(acc, v);
    } else if (op == kMin) {
      if (v < acc) acc = v;
    } else if (v > acc) {
      acc = v;
    }
  }
  out[j] = acc;
}

__global__ void __launch_bounds__(kThreads) reduce_i64(const long long* __restrict__ p,
                                                        long long n_shards, long long N,
                                                        long long lo, long long n_out, int op,
                                                        long long* __restrict__ out) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_out) return;
  const long long* col = p + lo + j;
  long long acc = op == kSum ? 0 : op == kMin ? INT64_MAX : INT64_MIN;
  for (long long k = 0; k < n_shards; ++k) {
    const long long v = col[k * N];
    if (op == kSum) {
      acc += v;
    } else if (op == kMin) {
      if (v < acc) acc = v;
    } else if (v > acc) {
      acc = v;
    }
  }
  out[j] = acc;
}

}  // namespace

extern "C" {

// partials [n_shards, N] (f64 or i64 by `dtype`, contiguous) -> out [hi - lo]:
// `op` of each column over the shards in ascending shard order, for the
// columns lo..hi-1.  Launches on `stream` and returns cudaGetLastError().
int m3_mesh_reduce(const void* partials, int dtype, long long n_shards, long long N,
                   long long lo, long long hi, int op, void* out, void* stream) {
  if (op < kSum || op > kMax || (dtype != kF64 && dtype != kI64) || n_shards < 1 || N < 0 ||
      lo < 0 || hi < lo || hi > N)
    return (int)cudaErrorInvalidValue;
  const long long n_out = hi - lo;
  if (n_out == 0) return (int)cudaSuccess;
  const long long blocks = (n_out + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (dtype == kF64)
    reduce_f64<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const double*)partials, n_shards, N, lo, n_out, op, (double*)out);
  else
    reduce_i64<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const long long*)partials, n_shards, N, lo, n_out, op, (long long*)out);
  return (int)cudaGetLastError();
}

const char* m3_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
