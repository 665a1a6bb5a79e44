// Group-by reduction of a served [L, S] matrix on Hopper (QK4).
//
// Replaces, from m3_tpu/models/query_pipeline.py:
//   _grouped_reduce (:915) without quantile: sum, avg, count, min, max,
//       group, stddev, stdvar of each group's lanes, per step (NaN cells
//       absent, a group-step with no present cell NaN, stddev/stdvar in the
//       reference's two passes: the mean, then sum((x - mean)^2));
//   the fleet sum jnp.nansum(rate, axis=0) of device_rate_pipeline (:806):
//       the one-group case, with 0.0 in place of NaN.
//
// The JAX program uses segment_sum/segment_min, which are scatters with a
// combiner.  Here there are no floating-point atomics, so the result is the
// same on every run: the host hands in a stable CSR of each group's lanes
// (ascending lane order), and one block owns one (group, tile of 32 steps).
// Its 32 warps stride over the group's lanes, lane w of a warp on step w of
// the tile (a coalesced 256-byte row segment per load); each warp sums its
// lanes in ascending order, and the warps' partials are combined in warp
// order.  A group of at most 32 lanes is summed strictly in lane order.
// min/max exclude NaN with +-inf fill and order -0.0 below +0.0, as XLA's
// min/max do.
//
// What bounds it on an H100: bytes (each cell of the [L, S] input read once,
// twice for stddev/stdvar; one f64 written per (group, step)).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;    // steps per block
constexpr int kWarps = 32;   // warps per block
constexpr int kThreads = kTile * kWarps;

enum Agg : int { kSum = 0, kAvg = 1, kCount = 2, kMin = 3, kMax = 4, kGroup = 5, kStddev = 6,
                 kStdvar = 7 };

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

__global__ void __launch_bounds__(kThreads) grouped_kernel(
    const double* __restrict__ x, long long S, const long long* __restrict__ members,
    const long long* __restrict__ offsets, int agg, double empty_value, double* __restrict__ out) {
  __shared__ double part_s[kWarps][kTile];
  __shared__ double part_n[kWarps][kTile];
  __shared__ double part_lo[kWarps][kTile];
  __shared__ double part_hi[kWarps][kTile];
  __shared__ double mean_of[kTile];
  const int col = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long g = blockIdx.y;
  const long long s = (long long)blockIdx.x * kTile + col;
  const bool live = s < S;
  const long long lo = offsets[g], hi = offsets[g + 1];

  double sum = 0.0, cnt = 0.0, vmin = INFINITY, vmax = -INFINITY;
  if (live) {
    for (long long k = lo + warp; k < hi; k += kWarps) {
      const long long lane = members != nullptr ? members[k] : k;
      const double v = x[lane * S + s];
      const bool m = !isnan(v);
      sum += m ? v : 0.0;
      cnt += m ? 1.0 : 0.0;
      if (m) {
        vmin = min_ieee(vmin, v);
        vmax = max_ieee(vmax, v);
      }
    }
  }
  part_s[warp][col] = sum;
  part_n[warp][col] = cnt;
  part_lo[warp][col] = vmin;
  part_hi[warp][col] = vmax;
  __syncthreads();
  // the total of each step, combined in warp order (0.0 + p0 + p1 + ...)
  sum = 0.0;
  cnt = 0.0;
  vmin = INFINITY;
  vmax = -INFINITY;
  for (int w = 0; w < kWarps; ++w) {
    sum += part_s[w][col];
    cnt += part_n[w][col];
    vmin = min_ieee(vmin, part_lo[w][col]);
    vmax = max_ieee(vmax, part_hi[w][col]);
  }
  const double denom = cnt > 1.0 ? cnt : 1.0;
  double var = 0.0;
  if (agg == kStddev || agg == kStdvar) {
    if (warp == 0) mean_of[col] = sum / denom;
    __syncthreads();
    const double mean = mean_of[col];
    double ss = 0.0;
    if (live) {
      for (long long k = lo + warp; k < hi; k += kWarps) {
        const long long lane = members != nullptr ? members[k] : k;
        const double v = x[lane * S + s];
        const double d = isnan(v) ? 0.0 : v - mean;
        ss += d * d;
      }
    }
    part_s[warp][col] = ss;
    __syncthreads();
    ss = 0.0;
    for (int w = 0; w < kWarps; ++w) ss += part_s[w][col];
    var = ss / denom;
  }
  if (warp != 0 || !live) return;
  double r;
  switch (agg) {
    case kSum: r = sum; break;
    case kAvg: r = sum / denom; break;
    case kCount: r = cnt; break;
    case kMin: r = vmin; break;
    case kMax: r = vmax; break;
    case kGroup: r = 1.0; break;
    case kStddev: r = sqrt(var); break;
    default: r = var; break;
  }
  out[g * S + s] = cnt == 0.0 ? empty_value : r;
}

}  // namespace

extern "C" {

// x f64[L, S]; members i64[offsets[G]] (lane ids, ascending within a group)
// or null for lanes 0..offsets[G]-1; offsets i64[G + 1] -> out f64[G, S].
// A group-step with no present cell gets `empty_value`.  Launches on
// `stream` and returns cudaGetLastError().
int m3_query_grouped(const double* x, long long S, const long long* members,
                     const long long* offsets, int n_groups, int agg, double empty_value,
                     double* out, void* stream) {
  if (agg < kSum || agg > kStdvar || n_groups < 0 || n_groups > 65535)
    return (int)cudaErrorInvalidValue;
  if (n_groups == 0 || S <= 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((S + kTile - 1) / kTile), (unsigned)n_groups);
  grouped_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, S, members, offsets, agg,
                                                              empty_value, out);
  return (int)cudaGetLastError();
}

const char* m3_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
