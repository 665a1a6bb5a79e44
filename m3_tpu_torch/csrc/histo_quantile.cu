// histogram_quantile's bucket interpolation on Hopper (QK8).
//
// Replaces m3_tpu/ops/histo_quantile.py:30 bucket_quantile, together with
// the row gather in front of it (m3_tpu/models/query_pipeline.py:1587,
// counts = cv[rows_idx]): for every (group, step), the phi-quantile of the
// group's cumulative bucket counts (upstream bucketQuantile):
//   c_b    = running max over b of nan_to_num(cv[rows_idx[g, b], s])
//            (NaN -> 0, +-Inf -> +-DBL_MAX, as jnp.nan_to_num maps them);
//   rank   = phi * c_{B-1};  idx = #{b : c_b < rank}, clipped to [0, B-1];
//   value  = lo_ub + (hi_ub - lo_ub) * clip(frac, 0, 1) with
//            frac = (rank - lo_c) / max(hi_c - lo_c, 1e-12);
//   then the first-bucket rule (idx == 0 and hi_ub <= 0 -> hi_ub), the
//   +Inf-cap rule (hi_ub == +Inf -> caps[g]), NaN where c_{B-1} is not
//   above 0, and phi < 0 -> -Inf, phi > 1 -> +Inf, NaN phi -> NaN.
// max/min/clip are jnp's: NaN propagates, -0.0 orders below +0.0.  The file
// is built with --fmad=false, so no product is contracted into an FMA.
//
// One thread per (group, step), threads along the steps so a warp reads a
// 256-byte run of each gathered row.  The bucket axis is walked three
// times (the total, the index, the two counts at idx - 1 and idx), so no
// per-thread array is needed whatever the number of buckets; the rows come
// from L1/L2 after the first walk.
//
// What bounds it on an H100: bytes (each gathered cell read once from
// device memory, one f64 written per (group, step)).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ double nan_value() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// jnp.maximum / jnp.minimum: NaN propagates, -0.0 orders below +0.0.
__device__ __forceinline__ double maxn(double a, double b) {
  if (isnan(a) || isnan(b)) return nan_value();
  if (a > b) return a;
  if (b > a) return b;
  return signbit(a) ? b : a;
}
__device__ __forceinline__ double minn(double a, double b) {
  if (isnan(a) || isnan(b)) return nan_value();
  if (a < b) return a;
  if (b < a) return b;
  return signbit(a) ? a : b;
}

__device__ __forceinline__ double nan_to_num(double v) {
  if (isnan(v)) return 0.0;
  if (isinf(v)) return v > 0 ? DBL_MAX : -DBL_MAX;
  return v;
}

__global__ void __launch_bounds__(kThreads) histo_quantile_kernel(
    const double* __restrict__ cv, long long S, const long long* __restrict__ rows_idx,
    const double* __restrict__ ubs, const double* __restrict__ caps, long long G, int B,
    double phi, double* __restrict__ out) {
  const long long s = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long g = blockIdx.y;
  if (s >= S || g >= G) return;
  const long long* rows = rows_idx + g * B;
  const double* ub = ubs + g * B;
  double c = 0.0;
  for (int b = 0; b < B; ++b) {
    const double x = nan_to_num(cv[rows[b] * S + s]);
    c = b == 0 ? x : maxn(c, x);
  }
  const double total = c;
  const double rank = phi * total;
  int idx = 0;
  for (int b = 0; b < B; ++b) {
    const double x = nan_to_num(cv[rows[b] * S + s]);
    c = b == 0 ? x : maxn(c, x);
    idx += c < rank;
  }
  idx = idx < B - 1 ? idx : B - 1;
  double lo_c = 0.0, hi_c = 0.0;
  for (int b = 0; b <= idx; ++b) {
    const double x = nan_to_num(cv[rows[b] * S + s]);
    c = b == 0 ? x : maxn(c, x);
    if (b == idx - 1) lo_c = c;
  }
  hi_c = c;
  const double hi_ub = ub[idx];
  const double lo_ub = idx > 0 ? ub[idx - 1] : 0.0;
  const double frac = (rank - lo_c) / maxn(hi_c - lo_c, 1e-12);
  double val = lo_ub + (hi_ub - lo_ub) * minn(1.0, maxn(0.0, frac));
  if (idx == 0 && hi_ub <= 0.0) val = hi_ub;
  if (isinf(hi_ub) && hi_ub > 0.0) val = caps[g];
  if (!(total > 0.0)) val = nan_value();
  if (phi < 0.0) val = -INFINITY;
  else if (phi > 1.0) val = INFINITY;
  if (isnan(phi)) val = nan_value();
  out[g * S + s] = val;
}

}  // namespace

extern "C" {

// cv f64[R, S]; rows_idx i64[G, B] (rows of cv); ubs f64[G, B]; caps f64[G]
// -> out f64[G, S].  Launches on `stream` and returns cudaGetLastError().
int m3_histo_quantile(const double* cv, long long S, const long long* rows_idx,
                      const double* ubs, const double* caps, long long G, int B, double phi,
                      double* out, void* stream) {
  if (B < 1 || G > 65535) return (int)cudaErrorInvalidValue;
  if (G <= 0 || S <= 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((S + kThreads - 1) / kThreads), (unsigned)G);
  histo_quantile_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(cv, S, rows_idx, ubs, caps,
                                                                     G, B, phi, out);
  return (int)cudaGetLastError();
}

const char* m3_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
