// Order statistics of each group's lanes, per step, on Hopper (QK6, QK7).
//
// Replaces:
//   QK6  m3_tpu/models/query_pipeline.py:871 _grouped_quantile: the
//        phi-quantile of each group's present cells per step (linear
//        interpolation at h = phi * (n_present - 1); no present cell: NaN);
//   QK7  m3_tpu/ops/lane_topk.py:33 masked_topk: topk/bottomk per (group,
//        step): keep the k best lanes, NaN the rest, and report per lane
//        whether it was kept at any step and its position at the last step.
//
// The reference sorts the whole [L, S] matrix per step by (group, key) in
// one lax.sort (stable: equal keys keep lane order; -0.0 equals +0.0 and
// NaN keys sort last) and finds each group's run from segment counts.
// Here the host hands in a stable CSR of each group's lanes (ascending
// lane order) and one block owns one (group, step) at a time, taking them
// in turn: it loads the group's cells of that step, builds (order key,
// member position) pairs and sorts them ascending with a bitonic network.
// Member positions are distinct and ascend with the lane, so the order is
// total and the same as the reference's stable one.  A group whose padded
// size P is at most p_smem pairs (the caller's shared-memory limit,
// ops/query_grouped.py:SELECT_SMEM_MAX_P) sorts in dynamic shared memory; a
// larger one sorts in the block's slice of a global scratch buffer, so
// groups have no size limit (the 50,000-lane topk of the serving shape
// takes that path).
//
// Keys: quantile sorts v with NaN -> +inf; topk sorts -v with NaN -> -inf
// before the negation (so NaN lanes come last, still selectable once the
// real values run out); bottomk sorts v with NaN -> +inf.  The order key
// maps -0.0 to +0.0, as the reference's comparator compares them.
//
// QK6 then reads the keys at positions floor(h) and ceil(h) and
// interpolates in the reference's order of operations (the file is built
// with --fmad=false).  QK7 writes every member's cell of the step (kept or
// NaN), sets present[lane] = 1 for kept lanes (every writer stores the same
// 1, so the result does not depend on the order), and at the last step
// writes each member's rank: its position if kept, else 2^62.
//
// What bounds it on an H100: operations for large groups (the network's
// P log2(P)^2 / 4 compare-exchanges per (group, step)), bytes for small
// ones (each cell read once, gathered by lane; QK7 writes each cell once).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr long long kNoRank = 1LL << 62;

enum Mode : int { kQuantile = 0, kTopk = 1, kBottomk = 2 };

// Unsigned key whose order is the float order with -0.0 == +0.0 and every
// NaN after +inf (the padding key ~0 is above all of them).
__device__ __forceinline__ unsigned long long order_key(double v) {
  if (isnan(v)) v = NAN;
  if (v == 0.0) v = 0.0;
  const unsigned long long b = (unsigned long long)__double_as_longlong(v);
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}

__device__ __forceinline__ double sort_value(double v, int mode) {
  if (mode == kQuantile) return isnan(v) ? INFINITY : v;
  if (mode == kTopk) return -(isnan(v) ? -INFINITY : v);
  return isnan(v) ? INFINITY : v;
}

// Ascending bitonic sort of P (key, pos) pairs, P a power of two; every
// thread of the block calls it.
__device__ void bitonic_sort(unsigned long long* keys, int* pos, int P) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < P; i += nt) {
        const int p = i ^ j;
        if (p > i) {
          const unsigned long long ki = keys[i], kp = keys[p];
          const int ci = pos[i], cp = pos[p];
          const bool gt = ki > kp || (ki == kp && ci > cp);
          if (gt == ((i & k) == 0)) {
            keys[i] = kp;
            keys[p] = ki;
            pos[i] = cp;
            pos[p] = ci;
          }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void select_kernel(const double* __restrict__ x, long long S,
                              const long long* __restrict__ members,
                              const long long* __restrict__ offsets, long long n_groups, int mode,
                              double phi, long long k, int p_smem, long long p_scratch,
                              unsigned long long* __restrict__ scratch_keys,
                              int* __restrict__ scratch_pos, double* __restrict__ out,
                              int* __restrict__ present, long long* __restrict__ rank) {
  extern __shared__ unsigned long long smem[];
  __shared__ int n_present;
  const int tid = threadIdx.x, nt = blockDim.x;
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  for (long long item = blockIdx.x; item < n_groups * S; item += gridDim.x) {
    const long long g = item / S, s = item % S;
    const long long off = offsets[g];
    const int size = (int)(offsets[g + 1] - off);
    if (size == 0) {
      if (mode == kQuantile && tid == 0) out[g * S + s] = nan;
      continue;  // block-uniform: no thread reaches a barrier below
    }
    int P = 1;
    while (P < size) P <<= 1;
    unsigned long long* keys;
    int* pos;
    if (P <= p_smem) {
      keys = smem;
      pos = (int*)(smem + P);
    } else {
      keys = scratch_keys + (long long)blockIdx.x * p_scratch;
      pos = scratch_pos + (long long)blockIdx.x * p_scratch;
    }
    if (tid == 0) n_present = 0;
    __syncthreads();
    int mine = 0;
    for (int i = tid; i < P; i += nt) {
      if (i < size) {
        const double v = x[members[off + i] * S + s];
        mine += !isnan(v);
        keys[i] = order_key(sort_value(v, mode));
      } else {
        keys[i] = ~0ull;
      }
      pos[i] = i;
    }
    if (mine) atomicAdd(&n_present, mine);
    __syncthreads();
    bitonic_sort(keys, pos, P);
    if (mode == kQuantile) {
      if (tid == 0) {
        const double np = (double)n_present;
        double q = nan;
        if (np > 0.0) {
          const double h = phi * (np - 1.0 > 0.0 ? np - 1.0 : 0.0);
          const double lo = floor(h);
          const double frac = h - lo;
          // the sorted keys, as the reference interpolates them (a NaN
          // lane tied with a real +inf reads as +inf)
          const double v_lo = sort_value(x[members[off + pos[(long long)lo]] * S + s], mode);
          const double v_hi = sort_value(x[members[off + pos[(long long)ceil(h)]] * S + s], mode);
          q = v_lo + (v_hi - v_lo) * frac;
        }
        out[g * S + s] = q;
      }
    } else {
      for (int i = tid; i < size; i += nt) {
        const long long lane = members[off + pos[i]];
        const bool kept = i < k;
        out[lane * S + s] = kept ? x[lane * S + s] : nan;
        if (kept) present[lane] = 1;
        if (s == S - 1) rank[lane] = kept ? (long long)i : kNoRank;
      }
    }
    __syncthreads();  // the pairs are rewritten by the next item
  }
}

}  // namespace

extern "C" {

// x f64[L, S]; members i64[offsets[G]] (lane ids, ascending within a group),
// offsets i64[G + 1].  mode 0 (quantile at phi, 0 <= phi <= 1): out f64[G, S].
// mode 1/2 (topk/bottomk of k >= 1; every lane in exactly one group): out
// f64[L, S], present i32[L] (zeroed by the caller), rank i64[L].
// p_smem is the largest padded group size that sorts in shared memory (0 if
// none); p_scratch the largest padded size above it (0 if none), with
// scratch keys u64[grid, p_scratch] and positions i32[grid, p_scratch].
// Launches on `stream` and returns cudaGetLastError() (a p_smem above the
// device's shared-memory opt-in fails at cudaFuncSetAttribute).
int m3_query_select(const double* x, long long S, const long long* members,
                    const long long* offsets, long long n_groups, int mode, double phi,
                    long long k, int p_smem, long long p_scratch,
                    unsigned long long* scratch_keys, int* scratch_pos, int grid, int threads,
                    double* out, int* present, long long* rank, void* stream) {
  if (mode < kQuantile || mode > kBottomk || p_smem < 0 || grid < 1 ||
      (p_scratch > 0 && (p_scratch <= p_smem || scratch_keys == nullptr || scratch_pos == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n_groups <= 0 || S <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)p_smem * (sizeof(unsigned long long) + sizeof(int));
  // 4,096 pairs are 48 KB, which with the static counter is over the
  // default limit: opt in to the dynamic size every launch asks for
  cudaError_t rc = cudaFuncSetAttribute(select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  select_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      x, S, members, offsets, n_groups, mode, phi, k, p_smem, p_scratch, scratch_keys, scratch_pos,
      out, present, rank);
  return (int)cudaGetLastError();
}

const char* m3_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
