// Graphite's per-series transforms along each lane on Hopper (GK3).
//
// Replaces the non-elementwise families of
// m3_tpu/models/query_pipeline.py:1289 _graphite_call (the elementwise and
// shift families are plain-torch glue in ops/graphite.py):
//   integral            running NaN-as-0.0 sum over every column (the
//                       padding columns carry the last sum);
//   integralByInterval  the same, restarting every k steps, over the real
//                       steps;
//   keepLastValue       a NaN cell takes the last present value while the
//                       gap to it is at most `limit` (+inf: no limit);
//   summarize           sum/avg/max/min/count/range/multiply over buckets
//                       of k real steps, repeated across each bucket;
//   offsetToZero,       each lane's nanmin (and nanmax), then x - min, or
//   minMax              (x - min) / (max - min) with non-finite results 0.0;
//   moving{Average,Sum,Max,Min}
//                       over the w cells up to each column, the cells before
//                       the first absent (lax.reduce_window with w - 1
//                       leading pads).
// Every fn reads the columns past real_S as NaN, as the reference first
// normalizes them.
//
// The reference computes the scans with jnp.cumsum and the windows with
// lax.reduce_window, which XLA:CPU evaluates from a 0.0 (or +-inf) start
// in column order; here one thread owns one lane and walks its columns in
// that order, so each sum is the in-order one, the same as the plain
// version's (ops/graphite.py:row_transform_plain).  min/max order -0.0
// below +0.0, as XLA's do.  The moving windows re-read their w cells per
// column (no running difference, which would round differently).
//
// What bounds it on an H100: bytes (each cell read once and written once;
// the moving windows re-read w cells from L1).  A thread per lane makes
// every warp access touch 32 rows; the rows' cache lines stay in L1 while
// the warp walks them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // lanes per block

enum Fn : int { kIntegral = 0, kIntegralByInterval = 1, kKeepLastValue = 2, kSummarize = 3,
                kOffsetToZero = 4, kMinMax = 5, kMovingAverage = 6, kMovingSum = 7,
                kMovingMax = 8, kMovingMin = 9 };
enum Func : int { kSum = 0, kAvg = 1, kMax = 2, kMin = 3, kCount = 4, kRange = 5,
                  kMultiply = 6 };

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

// The reductions of a run of cells, in order.
struct Acc {
  double sum = 0.0, cnt = 0.0, prod = 1.0, lo = INFINITY, hi = -INFINITY;
  __device__ __forceinline__ void add(double v) {
    if (isnan(v)) return;
    sum += v;
    cnt += 1.0;
    prod *= v;
    lo = min_ieee(lo, v);
    hi = max_ieee(hi, v);
  }
};

__global__ void __launch_bounds__(kThreads) graphite_row_kernel(
    const double* __restrict__ x, long long L, long long S, int real_S, int fn, long long k,
    int func, double limit, double* __restrict__ out) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= L) return;
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  const double* row = x + r * S;
  double* o = out + r * S;
  auto at = [&](long long c) { return c < real_S ? row[c] : nan; };
  switch (fn) {
    case kIntegral: {
      double acc = 0.0;
      for (long long c = 0; c < S; ++c) {
        const double v = at(c);
        acc += isnan(v) ? 0.0 : v;
        o[c] = acc;
      }
      return;
    }
    case kIntegralByInterval: {
      double acc = 0.0;
      for (long long c = 0; c < S; ++c) {
        if (c >= real_S) {
          o[c] = nan;
          continue;
        }
        if (c % k == 0) acc = 0.0;
        const double v = row[c];
        acc += isnan(v) ? 0.0 : v;
        o[c] = acc;
      }
      return;
    }
    case kKeepLastValue: {
      double last_v = nan;
      long long last_c = -1;
      for (long long c = 0; c < S; ++c) {
        const double v = at(c);
        if (!isnan(v)) {
          last_v = v;
          last_c = c;
          o[c] = v;
        } else {
          o[c] = (last_c >= 0 && (double)(c - last_c) <= limit) ? last_v : nan;
        }
      }
      return;
    }
    case kSummarize: {
      for (long long b0 = 0; b0 < real_S; b0 += k) {
        const long long b1 = b0 + k < real_S ? b0 + k : real_S;
        Acc a;
        for (long long c = b0; c < b1; ++c) a.add(row[c]);
        const bool empty = a.cnt == 0.0;
        double val;
        switch (func) {
          case kSum: val = a.sum; break;
          case kAvg: val = empty ? nan : a.sum / (a.cnt > 1.0 ? a.cnt : 1.0); break;
          case kMax: val = empty ? nan : a.hi; break;
          case kMin: val = empty ? nan : a.lo; break;
          case kCount: val = a.cnt; break;
          case kRange: val = empty ? nan : a.hi - a.lo; break;
          default: val = a.prod; break;  // kMultiply
        }
        for (long long c = b0; c < b1; ++c) o[c] = val;
      }
      for (long long c = real_S; c < S; ++c) o[c] = nan;
      return;
    }
    case kOffsetToZero:
    case kMinMax: {
      Acc a;
      for (long long c = 0; c < real_S && c < S; ++c) a.add(row[c]);
      const double lo = a.cnt == 0.0 ? nan : a.lo, hi = a.cnt == 0.0 ? nan : a.hi;
      const double rng = hi - lo;
      const double den = rng == 0.0 ? nan : rng;
      for (long long c = 0; c < S; ++c) {
        if (fn == kOffsetToZero) {
          o[c] = at(c) - lo;
        } else {
          const double v = (at(c) - lo) / den;
          o[c] = isfinite(v) ? v : 0.0;
        }
      }
      return;
    }
    default: {  // the moving windows, width k
      for (long long c = 0; c < S; ++c) {
        Acc a;
        for (long long j = c - k + 1 > 0 ? c - k + 1 : 0; j <= c; ++j) a.add(at(j));
        const bool empty = a.cnt == 0.0;
        double val;
        switch (fn) {
          case kMovingSum: val = a.sum; break;
          case kMovingAverage: val = empty ? nan : a.sum / (a.cnt > 1.0 ? a.cnt : 1.0); break;
          case kMovingMax: val = empty ? nan : a.hi; break;
          default: val = empty ? nan : a.lo; break;  // kMovingMin
        }
        o[c] = val;
      }
      return;
    }
  }
}

}  // namespace

extern "C" {

// x f64[L, S] -> out f64[L, S]: `fn` along each lane, the columns at and
// past real_S read as NaN.  k >= 1: the bucket size (integralByInterval,
// summarize) or window width (moving*); func: summarize's reducer; limit:
// keepLastValue's gap limit.  Launches on `stream` and returns
// cudaGetLastError().
int m3_graphite_row(const double* x, long long L, long long S, int real_S, int fn, long long k,
                    int func, double limit, double* out, void* stream) {
  if (fn < kIntegral || fn > kMovingMin || func < kSum || func > kMultiply || k < 1 ||
      real_S < 0 || real_S > S)
    return (int)cudaErrorInvalidValue;
  if (L <= 0 || S <= 0) return (int)cudaSuccess;
  const long long blocks = (L + kThreads - 1) / kThreads;
  graphite_row_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, L, S, real_S, fn, k, func, limit, out);
  return (int)cudaGetLastError();
}

const char* m3_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
