// Per-lane merge of decoded (series, block) grids on Hopper (QK1), and the
// subquery's packing of its inner grid (QK12, subq_pack_kernel below).
//
// Replaces, from m3_tpu/models/query_pipeline.py:
//   _tier_cut (:154)      the cross-namespace stitch: tier rank r keeps only
//                         samples older than the earliest sample any finer
//                         tier holds for the same slot;
//   _merge_device (:46)   rank-in-slot scatter of every valid cell into the
//                         packed [n_lanes, n_cap] batch, cells past n_cap
//                         dropped, INT64_MAX / NaN fill, per-lane counts of
//                         every valid cell (dropped ones included);
//   _decode_merge (:175)  the lane half of its error contract: the per-lane
//                         "unsorted" flag, diff(times) < 0 over the whole
//                         padded row (int64 wrap-around, as XLA subtracts).
//
// The JAX program ranks cells with a global cumsum over all M*T cells and
// scatters them.  Here one block owns one output lane: rows of a slot are
// contiguous and slots ascend (the engine's emission order, which the
// reference's indices_are_sorted segment ops assume too), so the block finds
// its rows with a binary search over `slots` and compacts them in row order
// with a block-wide ballot/popc prefix per chunk of cells.  Valid cells need
// not form a prefix of a row: the tier cut and backward timestamps leave
// gaps.  Every output cell is written once, coalesced; no atomics.
//
// What bounds it on an H100: bytes.  It reads each decoded cell's time,
// value and flag once (17 B) and writes 16 B per output cell (the fill
// included); the tier cut, when there are several tiers, reads times and
// flags once more per tier.  Integers and copies only: the result equals the
// plain version and the JAX program bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTiers = 16;
constexpr long long kInt64Max = 0x7fffffffffffffffLL;

__device__ __forceinline__ long long lower_bound(const long long* __restrict__ a, long long n,
                                                 long long key) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Exclusive prefix of one 0/1 flag per thread over the block; *total gets
// the block's sum.  Every thread of the block must call it.
__device__ __forceinline__ int block_scan(bool flag, int* warp_counts, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  const int within = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, sum = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_counts[w];
    before += w < warp ? c : 0;
    sum += c;
  }
  __syncthreads();  // warp_counts is reused by the next call
  *total = sum;
  return before + within;
}

// Minimum over the block; every thread gets it.
__device__ __forceinline__ long long block_min(long long v, long long* warp_mins) {
  for (int o = 16; o > 0; o >>= 1) {
    const long long u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u < v ? u : v;
  }
  if ((threadIdx.x & 31) == 0) warp_mins[threadIdx.x >> 5] = v;
  __syncthreads();
  long long m = warp_mins[0];
  for (int w = 1; w < kWarps; ++w) m = warp_mins[w] < m ? warp_mins[w] : m;
  __syncthreads();
  return m;
}

__global__ void __launch_bounds__(kThreads) lane_merge_kernel(
    const long long* __restrict__ ts, const double* __restrict__ vs, const bool* __restrict__ valid,
    const long long* __restrict__ slots, const long long* __restrict__ tiers, long long M, int T,
    int n_cap, int n_tiers, long long* out_t, double* out_v, long long* __restrict__ counts,
    bool* __restrict__ unsorted) {
  __shared__ int warp_counts[kWarps];
  __shared__ long long warp_mins[kWarps];
  __shared__ long long cut_before[kMaxTiers];
  const long long lane = blockIdx.x;
  const long long r0 = lower_bound(slots, M, lane);
  const long long r1 = lower_bound(slots, M, lane + 1);

  // Tier cut: the cut a tier's rows see is the minimum kept time of all
  // finer tiers (n_tiers == 0: no cut).
  long long cut = kInt64Max;
  for (int t = 0; t < n_tiers; ++t) {
    long long mn = kInt64Max;
    for (long long r = r0; r < r1; ++r) {
      if (tiers[r] != t) continue;
      for (int i = threadIdx.x; i < T; i += kThreads) {
        const long long x = ts[r * T + i];
        if (valid[r * T + i] && x < cut && x < mn) mn = x;
      }
    }
    mn = block_min(mn, warp_mins);
    if (threadIdx.x == 0) cut_before[t] = cut;
    cut = mn < cut ? mn : cut;
  }
  __syncthreads();

  long long* lt = out_t + lane * n_cap;
  double* lv = out_v + lane * n_cap;
  long long kept = 0;  // valid cells of this lane so far, the same in every thread
  for (long long r = r0; r < r1; ++r) {
    const long long tier = n_tiers > 0 ? tiers[r] : -1;
    const bool cut_row = tier >= 0 && tier < n_tiers;
    const long long row_cut = cut_row ? cut_before[tier] : 0;
    for (int base = 0; base < T; base += kThreads) {
      const int i = base + threadIdx.x;
      bool ok = false;
      long long x = 0;
      if (i < T) {
        x = ts[r * T + i];
        ok = valid[r * T + i] && (!cut_row || x < row_cut);
      }
      int total;
      const long long rank = kept + block_scan(ok, warp_counts, &total);
      if (ok && rank < n_cap) {
        lt[rank] = x;
        lv[rank] = vs[r * T + i];
      }
      kept += total;
    }
  }
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  for (long long i = kept + threadIdx.x; i < n_cap; i += kThreads) {
    lt[i] = kInt64Max;
    lv[i] = nan;
  }
  __syncthreads();  // the lane's row, written above, is visible to the whole block

  bool bad = false;
  for (long long i = threadIdx.x; i + 1 < n_cap; i += kThreads) {
    const long long d = (long long)((unsigned long long)lt[i + 1] - (unsigned long long)lt[i]);
    bad = bad || d < 0;
  }
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    counts[lane] = kept;
    unsorted[lane] = bad;
  }
}

// QK12.  Replaces the row sort of the subquery node,
// m3_tpu/models/query_pipeline.py:1604-1618: the reference keys each cell
// of the child's [rows, S] matrix by its inner step time where the step is
// real (sub_valid) and the cell is not NaN, INT64_MAX otherwise, and sorts
// each row stably by that key with the values riding along (NaN where
// dropped).  The planner's inner grid ascends (np.arange of the subquery
// step, padded with its last time, the padding invalid; the wrapper checks
// this on the host), so the sort is a stable compaction: the surviving
// cells left-justified in step order, then (INT64_MAX, NaN).  One warp owns
// a row at a time and walks it in chunks of 32 cells: a ballot of the
// survivors, each survivor's slot from the popcount of the lanes below it.
//
// What bounds it on an H100: bytes (each cell read once, a time and a value
// written per cell); copies only, so it equals the sort bit for bit.
__global__ void __launch_bounds__(kThreads) subq_pack_kernel(
    const double* __restrict__ cv, const long long* __restrict__ sub_times,
    const bool* __restrict__ sub_valid, long long rows, int S, long long* __restrict__ t_out,
    double* __restrict__ v_out) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  const long long n_warps = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); row < rows;
       row += n_warps) {
    const double* x = cv + row * S;
    long long* t = t_out + row * S;
    double* v = v_out + row * S;
    int kept = 0;
    for (int base = 0; base < S; base += 32) {
      const int c = base + lane;
      double xc = nan;
      bool keep = false;
      if (c < S) {
        xc = x[c];
        keep = sub_valid[c] && !isnan(xc);
      }
      const unsigned mask = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        const int slot = kept + __popc(mask & below);
        t[slot] = sub_times[c];
        v[slot] = xc;
      }
      kept += __popc(mask);
    }
    for (int c = kept + lane; c < S; c += 32) {
      t[c] = kInt64Max;
      v[c] = nan;
    }
  }
}

}  // namespace

extern "C" {

// ts i64[M, T], vs f64[M, T], valid bool[M, T], slots i64[M] (ascending),
// tiers i64[M] or null -> out_t i64[n_lanes, n_cap], out_v f64[n_lanes, n_cap],
// counts i64[n_lanes], unsorted bool[n_lanes].  n_tiers == 0 skips the cut.
// Launches on `stream` and returns cudaGetLastError().
int m3_query_merge(const long long* ts, const double* vs, const bool* valid,
                   const long long* slots, const long long* tiers, long long M, int T,
                   long long n_lanes, int n_cap, int n_tiers, long long* out_t, double* out_v,
                   long long* counts, bool* unsorted, void* stream) {
  if (n_tiers < 0 || n_tiers > kMaxTiers || (n_tiers > 0 && tiers == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_lanes <= 0) return (int)cudaSuccess;
  lane_merge_kernel<<<(unsigned)n_lanes, kThreads, 0, (cudaStream_t)stream>>>(
      ts, vs, valid, slots, tiers, M, T, n_cap, n_tiers, out_t, out_v, counts, unsorted);
  return (int)cudaGetLastError();
}

// QK12: cv f64[rows, S], sub_times i64[S] (ascending where sub_valid),
// sub_valid bool[S] -> t_out i64[rows, S], v_out f64[rows, S] on a grid of
// `grid` blocks.  Launches on `stream` and returns cudaGetLastError().
int m3_subq_pack(const double* cv, const long long* sub_times, const bool* sub_valid,
                 long long rows, int S, long long* t_out, double* v_out, int grid, void* stream) {
  if (S < 0 || grid < 1) return (int)cudaErrorInvalidValue;
  if (rows <= 0 || S == 0) return (int)cudaSuccess;
  subq_pack_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      cv, sub_times, sub_valid, rows, S, t_out, v_out);
  return (int)cudaGetLastError();
}

const char* m3_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
