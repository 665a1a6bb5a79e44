// Group-by reduction of a served [L, S] matrix on Hopper (QK4).
//
// Replaces, from m3_tpu/models/query_pipeline.py:
//   _grouped_reduce (:915) without quantile: sum, avg, count, min, max,
//       group, stddev, stdvar of each group's lanes, per step (NaN cells
//       absent, a group-step with no present cell NaN, stddev/stdvar in the
//       reference's two passes: the mean, then sum((x - mean)^2));
//   the fleet sum jnp.nansum(rate, axis=0) of device_rate_pipeline (:806):
//       the one-group case, with 0.0 in place of NaN;
//   _graphite_grouped_reduce (:1216) but for count_series, median and
//       percentile: graphite's numpy NaN-reductions, the ops above (stddev
//       the population one) with multiply (the product of the present
//       cells), range (max - min) and the single-group diff (2 * row0 -
//       sum, NaN cells as 0.0) and last (the cell of the highest lane
//       present).  The caller picks what a group-step with no present cell
//       gives: 0.0 for graphite's sum and count, 1.0 for its product.
//
// The JAX program uses segment_sum/segment_min, which are scatters with a
// combiner.  Here there are no floating-point atomics, so the result is the
// same on every run: the host hands in a stable CSR of each group's lanes
// (ascending lane order), and one block owns one (group, tile of 32 steps).
// Its warps stride over the group's lanes, lane w of a warp on step w of
// the tile (a coalesced 256-byte row segment per load); each warp folds its
// lanes in ascending order, and the warps' partials are combined in warp
// order.  The host launches the groups of more than 32 lanes with 32 warps
// a block, and the others apart with as many warps as the largest of them
// has lanes (rounded up to a power of two: one warp for one-lane groups),
// so a group of at most 32 lanes is folded strictly in lane order and a
// larger one always in the same 32 chains, whatever the other groups are.
// min/max exclude NaN with +-inf fill and order -0.0 below +0.0, as XLA's
// min/max do.  The grid is one-dimensional (group-major), so it takes more
// than 65,535 groups.
//
// What bounds it on an H100: bytes (each cell of the [L, S] input read once,
// twice for stddev/stdvar; one f64 written per (group, step)).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;      // steps per block
constexpr int kMaxWarps = 32;  // warps per block at most

enum Agg : int { kSum = 0, kAvg = 1, kCount = 2, kMin = 3, kMax = 4, kGroup = 5, kStddev = 6,
                 kStdvar = 7, kMultiply = 8, kRange = 9, kDiff = 10, kLast = 11 };

__device__ __forceinline__ double min_ieee(double a, double b) {  // non-NaN operands
  if (a < b) return a;
  if (b < a) return b;
  return signbit(a) ? a : b;
}
__device__ __forceinline__ double max_ieee(double a, double b) {
  if (a > b) return a;
  if (b > a) return b;
  return signbit(a) ? b : a;
}

// What a fold carries besides the sum and the count: (a, b) is (min, max)
// for min/max/range, (product, unused) for multiply and (the last present
// cell, its lane) for last.
struct Pair {
  double a, b;
};

__device__ __forceinline__ Pair pair_init(int agg) {
  if (agg == kMultiply) return {1.0, 0.0};
  if (agg == kLast) return {__longlong_as_double(0x7ff8000000000000LL), -1.0};
  return {INFINITY, -INFINITY};
}

// Folds q (a cell, or a later warp's partial) into p.
__device__ __forceinline__ Pair pair_fold(int agg, Pair p, Pair q) {
  if (agg == kMultiply) return {p.a * q.a, 0.0};
  if (agg == kLast) return q.b > p.b ? q : p;
  return {min_ieee(p.a, q.a), max_ieee(p.b, q.b)};
}

__global__ void __launch_bounds__(kTile * kMaxWarps) grouped_kernel(
    const double* __restrict__ x, long long S, const long long* __restrict__ members,
    const long long* __restrict__ offsets, const long long* __restrict__ group_ids,
    long long n_tiles, int agg, double empty_value, double* __restrict__ out) {
  extern __shared__ double part[];  // four [warps][kTile] arrays
  __shared__ double mean_of[kTile];
  const int warps = blockDim.x >> 5;
  double* part_s = part;
  double* part_n = part + warps * kTile;
  double* part_a = part + 2 * warps * kTile;
  double* part_b = part + 3 * warps * kTile;
  const int col = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long g = group_ids != nullptr ? group_ids[blockIdx.x / n_tiles]
                                           : blockIdx.x / n_tiles;
  const long long s = (blockIdx.x % n_tiles) * kTile + col;
  const bool live = s < S;
  const long long lo = offsets[g], hi = offsets[g + 1];

  double sum = 0.0, cnt = 0.0;
  Pair p = pair_init(agg);
  if (live) {
#pragma unroll 4
    for (long long k = lo + warp; k < hi; k += warps) {
      const long long lane = members != nullptr ? members[k] : k;
      const double v = x[lane * S + s];
      const bool m = !isnan(v);
      sum += m ? v : 0.0;
      cnt += m ? 1.0 : 0.0;
      if (m) p = pair_fold(agg, p, {v, agg == kLast ? (double)lane : v});
    }
  }
  const int at = warp * kTile + col;
  part_s[at] = sum;
  part_n[at] = cnt;
  part_a[at] = p.a;
  part_b[at] = p.b;
  __syncthreads();
  // the total of each step, combined in warp order (0.0 + p0 + p1 + ...)
  sum = 0.0;
  cnt = 0.0;
  p = pair_init(agg);
  for (int w = 0; w < warps; ++w) {
    const int i = w * kTile + col;
    sum += part_s[i];
    cnt += part_n[i];
    p = pair_fold(agg, p, {part_a[i], part_b[i]});
  }
  const double denom = cnt > 1.0 ? cnt : 1.0;
  double var = 0.0;
  if (agg == kStddev || agg == kStdvar) {
    if (warp == 0) mean_of[col] = sum / denom;
    __syncthreads();
    const double mean = mean_of[col];
    double ss = 0.0;
    if (live) {
#pragma unroll 4
      for (long long k = lo + warp; k < hi; k += warps) {
        const long long lane = members != nullptr ? members[k] : k;
        const double v = x[lane * S + s];
        const double d = isnan(v) ? 0.0 : v - mean;
        ss += d * d;
      }
    }
    part_s[at] = ss;
    __syncthreads();
    ss = 0.0;
    for (int w = 0; w < warps; ++w) ss += part_s[w * kTile + col];
    var = ss / denom;
  }
  if (warp != 0 || !live) return;
  double r;
  switch (agg) {
    case kSum: r = sum; break;
    case kAvg: r = sum / denom; break;
    case kCount: r = cnt; break;
    case kMin: r = p.a; break;
    case kMax: r = p.b; break;
    case kGroup: r = 1.0; break;
    case kStddev: r = sqrt(var); break;
    case kStdvar: r = var; break;
    case kMultiply: r = p.a; break;
    case kRange: r = p.b - p.a; break;
    case kDiff: {
      const double v0 = x[s];  // lane 0 at this step, the minuend
      r = 2.0 * (isnan(v0) ? 0.0 : v0) - sum;
      break;
    }
    default: r = p.a; break;  // kLast
  }
  out[g * S + s] = cnt == 0.0 ? empty_value : r;
}

}  // namespace

extern "C" {

// x f64[L, S]; members i64[offsets[G]] (lane ids, ascending within a group)
// or null for lanes 0..offsets[G]-1; offsets i64[G + 1] -> out f64[G, S].
// A group-step with no present cell gets `empty_value`.  The launch covers
// the n_groups groups listed in group_ids (null: groups 0..n_groups-1),
// with `warps` (1, 2, 4, ..., 32) warps a block.  Launches on `stream` and
// returns cudaGetLastError().
int m3_query_grouped(const double* x, long long S, const long long* members,
                     const long long* offsets, const long long* group_ids, int n_groups,
                     int agg, double empty_value, int warps, double* out, void* stream) {
  if (agg < kSum || agg > kLast || n_groups < 0 || warps < 1 || warps > kMaxWarps ||
      (warps & (warps - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (n_groups == 0 || S <= 0) return (int)cudaSuccess;
  const long long n_tiles = (S + kTile - 1) / kTile;
  if (n_tiles * n_groups > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * (size_t)warps * kTile * sizeof(double);
  grouped_kernel<<<(unsigned)(n_tiles * n_groups), warps * 32, smem, (cudaStream_t)stream>>>(
      x, S, members, offsets, group_ids, n_tiles, agg, empty_value, out);
  return (int)cudaGetLastError();
}

const char* m3_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
