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
// Order: each output element folds the shards in ascending order, so every
// rank, whatever NCCL's own order would be, gets the same bits, and one rank
// holding 8 shards gives the bits of 2 ranks holding 4 each.  The folds are
// XLA:CPU's all-reduce, probed on its 8-device virtual mesh: a sum starts
// from 0.0 (so -0.0 shards sum to +0.0, NaN propagates); min starts from +inf
// and takes a shard's value only when it is strictly below (NaN is skipped,
// an all-NaN column gives +inf, of -0.0 and +0.0 the earlier shard's wins);
// max likewise from -inf.  The i64 form sums integers exactly (the ingest's
// sealed-bytes accounting).
//
// One launch reduces up to kMaxStacks stacks of one shape and dtype, each
// with its own op (the sharded group-by's counts and its sums, mins or
// maxes): a descriptor per stack (its first row, row stride, op and output)
// passed by value, blockIdx.y picking the stack.  A stack's rows need only
// be contiguous themselves, so stacks may be views into one gathered tensor.
// An owned range [lo, hi) of the N axis (a shard's chunk of a psum_scatter)
// is the stack's pointer moved to lo.
//
// One thread a column of one stack.  The mesh paths' stacks are small (8 x
// 60 for the read path's fleet, 8 x 35,500 f64 for a group-by: 2.3 MB, 0.7
// us at 3.35 TB/s), so a launch's latency bounds it: two columns a thread
// with 16-byte loads, the shards' loads issued ahead of the folds and a grid
// capped by the SM count were no faster on an H100 (tools/mk1_split.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Op : int { kSum = 0, kMin = 1, kMax = 2 };
enum Dtype : int { kF64 = 0, kI64 = 1 };
constexpr int kThreads = 256;
constexpr int kMaxStacks = 8;  // stacks of one launch

struct Stack {
  const void* p;     // row 0 at column lo
  void* out;         // [n_out]
  long long stride;  // elements between rows
  int op;
};

struct Batch {
  Stack s[kMaxStacks];
};

template <typename T> __device__ __forceinline__ T start(int op);
template <> __device__ __forceinline__ double start<double>(int op) {
  return op == kSum ? 0.0 : op == kMin ? INFINITY : -INFINITY;
}
template <> __device__ __forceinline__ long long start<long long>(int op) {
  return op == kSum ? 0 : op == kMin ? INT64_MAX : INT64_MIN;
}

__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ long long add(long long a, long long b) { return a + b; }

template <typename T> __device__ __forceinline__ T fold(int op, T acc, T v) {
  if (op == kSum) return add(acc, v);
  if (op == kMin) return v < acc ? v : acc;
  return v > acc ? v : acc;
}

// One thread a column of one stack, the shards in ascending order.
template <typename T>
__global__ void __launch_bounds__(kThreads) reduce_kernel(Batch batch, long long n_shards,
                                                          long long n_out) {
  const Stack st = batch.s[blockIdx.y];
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n_out) return;
  const T* col = (const T*)st.p + j;
  T acc = start<T>(st.op);
  for (long long k = 0; k < n_shards; ++k) acc = fold(st.op, acc, col[k * st.stride]);
  ((T*)st.out)[j] = acc;
}

// desc i64[n_stacks, 4]: (row 0 pointer, row stride in elements, op, out).
int launch(const long long* desc, int n_stacks, int dtype, long long n_shards, long long n_out,
           void* stream) {
  if (n_stacks < 1 || n_stacks > kMaxStacks || (dtype != kF64 && dtype != kI64) ||
      n_shards < 1 || n_out < 0)
    return (int)cudaErrorInvalidValue;
  Batch batch{};
  for (int i = 0; i < n_stacks; ++i) {
    const long long* d = desc + 4 * i;
    Stack& st = batch.s[i];
    st.p = (const void*)(intptr_t)d[0];
    st.stride = d[1];
    st.op = (int)d[2];
    st.out = (void*)(intptr_t)d[3];
    if (st.op < kSum || st.op > kMax || st.p == nullptr || st.out == nullptr ||
        (n_shards > 1 && st.stride < n_out))
      return (int)cudaErrorInvalidValue;
  }
  if (n_out == 0) return (int)cudaSuccess;
  const long long blocks = (n_out + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)n_stacks);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF64)
    reduce_kernel<double><<<grid, kThreads, 0, s>>>(batch, n_shards, n_out);
  else
    reduce_kernel<long long><<<grid, kThreads, 0, s>>>(batch, n_shards, n_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// desc i64[n_stacks, 4] on the host, each stack's (row 0 pointer, row
// stride in elements, op, out pointer): n_stacks <= 8 stacks [n_shards,
// n_out] of one dtype (f64 or i64 by `dtype`, each row contiguous) -> each
// stack's out [n_out], `op` of each column over the shards in ascending
// shard order, in one launch on `stream`.  Returns cudaGetLastError().
int m3_mesh_reduce(const long long* desc, int n_stacks, int dtype, long long n_shards,
                   long long n_out, void* stream) {
  if (desc == nullptr) return (int)cudaErrorInvalidValue;
  return launch(desc, n_stacks, dtype, n_shards, n_out, stream);
}

const char* m3_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
