// Windowed PromQL temporal functions over merged lanes on Hopper.
//
// Replaces, from m3_tpu/models/query_pipeline.py:
//   QK2  _window_bounds_device (:85), _rate_device (:98) and
//        _instant_device (:683): rate / increase / delta and irate / idelta;
//   QK3  the prefix-sum half of _reduce_device (:474): sum_over_time,
//        avg_over_time, count_over_time, present_over_time, last_over_time;
//        _changes_device (:415): changes / resets; _linreg_device (:437):
//        deriv / predict_linear.
// Both are one launch of temporal_kernel, with an op code.
//   QK5  _minmax_device (:205): min_over_time / max_over_time, one launch
//        of minmax_kernel (below).
//   QK9  _stdvar_device (:344): stddev_over_time / stdvar_over_time, one
//        launch of stdvar_kernel (below).
//   QK10 _holt_winters_device (:540): holt_winters, one launch of
//        holt_winters_kernel (below).
//
// Each block takes lanes in turn (lane = blockIdx.x, += gridDim.x).  For
// each lane it first builds the lane's prefix sums in its own slice of a
// global scratch buffer [gridDim.x, N + 1], so a lane may be of any length
// (the grid is a few blocks per SM, so the scratch stays in L2 at the
// serving shapes): for a counter rate the reset corrections
// where(v[j+1] < v[j], v[j], 0), for the reducers the NaN-masked values and
// the present counts, for changes/resets the pair flags (curr != prev,
// curr < prev; a NaN on either side is no event), for deriv/predict_linear
// the five moment sums of the least-squares fit (the present count and
// four f64 rows: v, t, t*v, t*t, with t in seconds from steps[0] - range
// and +-Inf samples as +-DBL_MAX, as jnp.nan_to_num has them), scanned
// tile by tile in a fixed order (so the bits do not change from run to
// run).  Then one thread per step does the two
// searchsorted(side="right") bisections over the lane's times, with the
// reference's fixed number of levels ceil(log2(N + 1)) so that an unsorted
// (error) lane gets the same bounds as in JAX, and evaluates the function.
// The reducers keep the prefix-difference form csum[right] - csum[left] of
// the reference, not a direct window sum, so cancellation on large counters
// is the reference's.
//
// f64 arithmetic keeps the reference's order of operations as XLA compiles
// it; the build uses --fmad=false so nothing is contracted into an FMA.
// Time differences are int64 (wrapping, as XLA's) before their conversion
// to f64.  The reference's "/ 1e9" is compiled by XLA as "* 1e-9" (a
// division by a constant becomes a multiplication by its reciprocal), and
// so it is written here.
//
// What bounds it on an H100: bytes.  Each lane's times and values are read
// once from device memory (16 B per sample; the bisections hit L1), and one
// f64 is written per (lane, step); the prefix sums go to and from L2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

enum Op : int {
  kRate = 0,     // rate / increase / delta (is_counter, is_rate)
  kInstant = 1,  // irate / idelta (is_rate)
  kSum = 2,
  kAvg = 3,
  kCount = 4,
  kPresent = 5,
  kLast = 6,
  kChanges = 7,
  kResets = 8,
  kDeriv = 9,    // the slope of the fit
  kPredict = 10, // predict_linear: intercept + slope * horizon
};

// What the j-th term of a prefix scan is.
enum Kind : int {
  kResetCorr,  // pair (j, j+1) of a counter: the value lost at a reset
  kMasked,     // the value where present (and the present count)
  kChangeFlag, // pair (j, j+1): curr != prev, neither NaN
  kResetFlag,  // pair (j, j+1): curr < prev, neither NaN
  kLinV,       // the fit's sums: nan_to_num(v) (and the present count),
  kLinT,       //   t, t * v and t * t where present
  kLinTV,
  kLinTT,
};

// Rows of f64 prefix sums one lane needs for an op.
__device__ __forceinline__ int prefix_rows(int op) {
  return (op == kDeriv || op == kPredict) ? 4 : 1;
}

__device__ __forceinline__ double nan_value() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

__device__ __forceinline__ long long wsub(long long a, long long b) {
  return (long long)((unsigned long long)a - (unsigned long long)b);
}

__device__ __forceinline__ long long clampi(long long x, long long lo, long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// jnp.minimum: NaN propagates, -0.0 orders below +0.0.
__device__ __forceinline__ double min_ieee(double a, double b) {
  if (isnan(a) || isnan(b)) return nan_value();
  if (a < b) return a;
  if (b < a) return b;
  return signbit(a) ? a : b;
}

// jnp.searchsorted(t, q, side="right") as JAX computes it: a fixed number
// of bisection levels, returning `high`.
__device__ __forceinline__ long long search_right(const long long* t, long long n, int levels,
                                                  long long q) {
  long long low = 0, high = n;
  for (int k = 0; k < levels; ++k) {
    const long long mid = (long long)(((unsigned long long)low + (unsigned long long)high) >> 1);
    if (q < t[mid]) high = mid; else low = mid;
  }
  return high;
}

struct Term {
  double s;
  int c;
};

// The fit's time axis: seconds from `origin` (INT64_MAX padding at the
// origin), the reference's (t - origin) / 1e9 as XLA compiles it.
__device__ __forceinline__ double tsec_of(long long t, long long origin) {
  return (double)wsub(t == INT64_MAX ? origin : t, origin) * 1e-9;
}

// jnp.nan_to_num: NaN -> 0, +-Inf -> +-DBL_MAX.
__device__ __forceinline__ double nan_to_num(double x) {
  if (isnan(x)) return 0.0;
  if (isinf(x)) return x > 0.0 ? 1.7976931348623157e308 : -1.7976931348623157e308;
  return x;
}

// The j-th term of a lane's prefix sums.
__device__ __forceinline__ Term term(const long long* t, const double* v, long long j, int kind,
                                     long long origin) {
  if (kind == kResetCorr) {
    const double prev = v[j], curr = v[j + 1];
    return {curr < prev ? prev : 0.0, 0};
  }
  if (kind == kChangeFlag || kind == kResetFlag) {
    const double prev = v[j], curr = v[j + 1];
    const bool event = kind == kResetFlag ? curr < prev : curr != prev;
    return {0.0, (event && !isnan(prev) && !isnan(curr)) ? 1 : 0};
  }
  const double x = v[j];
  const bool present = !isnan(x);
  if (kind == kMasked) return {present ? x : 0.0, present ? 1 : 0};
  if (!present) return {0.0, 0};
  if (kind == kLinV) return {nan_to_num(x), 1};
  const double ts = tsec_of(t[j], origin);
  if (kind == kLinT) return {ts, 0};
  if (kind == kLinTV) return {ts * nan_to_num(x), 0};
  return {ts * ts, 0};
}

// P[k] = sum of terms j < k, C likewise (C may be null), for k in
// [0, n_terms].  The terms are scanned in tiles of kThreads consecutive
// ones, thread t taking term base + t, so loads and stores are coalesced: a
// shuffle scan within each warp, the warp totals added in warp order, and
// the running total of the tiles before (the same bits in every thread)
// added first.
__device__ void block_prefix(const long long* t, const double* v, long long n_terms, int kind,
                             long long origin, double* P, int* C) {
  __shared__ double warp_s[kWarps];
  __shared__ int warp_c[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double carry_s = 0.0;
  int carry_c = 0;
  for (long long base = 0; base < n_terms; base += kThreads) {
    const long long j = base + threadIdx.x;
    const Term x = j < n_terms ? term(t, v, j, kind, origin) : Term{0.0, 0};
    double incl_s = x.s;
    int incl_c = x.c;
    for (int o = 1; o < 32; o <<= 1) {
      const double ys = __shfl_up_sync(0xffffffffu, incl_s, o);
      const int yc = __shfl_up_sync(0xffffffffu, incl_c, o);
      if (lane >= o) {
        incl_s += ys;
        incl_c += yc;
      }
    }
    if (lane == 31) {
      warp_s[warp] = incl_s;
      warp_c[warp] = incl_c;
    }
    __syncthreads();
    double run_s = carry_s;
    int run_c = carry_c;
    for (int w = 0; w < warp; ++w) {
      run_s += warp_s[w];
      run_c += warp_c[w];
    }
    const double excl_s = __shfl_up_sync(0xffffffffu, incl_s, 1);
    const int excl_c = __shfl_up_sync(0xffffffffu, incl_c, 1);
    if (j < n_terms) {
      P[j] = lane > 0 ? run_s + excl_s : run_s;
      if (C != nullptr) C[j] = lane > 0 ? run_c + excl_c : run_c;
    }
    for (int w = 0; w < kWarps; ++w) {
      carry_s += warp_s[w];
      carry_c += warp_c[w];
    }
    __syncthreads();  // warp_s is rewritten by the next tile
  }
  if (threadIdx.x == 0) {
    P[n_terms] = carry_s;
    if (C != nullptr) C[n_terms] = carry_c;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) temporal_kernel(
    const long long* __restrict__ times, const double* __restrict__ values,
    const long long* __restrict__ steps, long long L, long long N, int S, int levels,
    long long range_nanos, int op, int is_counter, int is_rate, double horizon,
    double* __restrict__ out, long long* __restrict__ left_out, long long* __restrict__ right_out,
    double* prefix, int* prefix_counts) {
  double* P = prefix + blockIdx.x * prefix_rows(op) * (N + 1);
  int* C = prefix_counts + blockIdx.x * (N + 1);
  const bool counter_prefix = op == kRate && is_counter && N > 1;
  const bool reduce_prefix = op == kSum || op == kAvg || op == kCount || op == kPresent;
  const bool linreg = op == kDeriv || op == kPredict;
  const long long origin = wsub(steps[0], range_nanos);
  const double nan = nan_value();
  for (long long lane = blockIdx.x; lane < L; lane += gridDim.x) {
    const long long* t = times + lane * N;
    const double* v = values + lane * N;
    if (counter_prefix) block_prefix(t, v, N - 1, kResetCorr, origin, P, C);
    if (reduce_prefix) block_prefix(t, v, N, kMasked, origin, P, C);
    if (op == kChanges || op == kResets)
      block_prefix(t, v, N - 1, op == kResets ? kResetFlag : kChangeFlag, origin, P, C);
    if (linreg) {
      block_prefix(t, v, N, kLinV, origin, P, C);
      block_prefix(t, v, N, kLinT, origin, P + (N + 1), nullptr);
      block_prefix(t, v, N, kLinTV, origin, P + 2 * (N + 1), nullptr);
      block_prefix(t, v, N, kLinTT, origin, P + 3 * (N + 1), nullptr);
    }

    for (int s = threadIdx.x; s < S; s += kThreads) {
      const long long step = steps[s];
      const long long start_excl = wsub(wsub(step, range_nanos), 1);
      const long long left = search_right(t, N, levels, start_excl);
      const long long right = search_right(t, N, levels, step);
      if (left_out != nullptr) {
        left_out[lane * S + s] = left;
        right_out[lane * S + s] = right;
      }
      const bool has2 = right - left >= 2;
      double r;
      if (op == kRate) {
        const long long i_first = clampi(left, 0, N - 1), i_last = clampi(right - 1, 0, N - 1);
        const long long t_first = t[i_first], t_last = t[i_last];
        const double v_first = v[i_first], v_last = v[i_last];
        double corr = 0.0;
        if (counter_prefix) corr = has2 ? P[i_last] - P[i_first] : 0.0;
        const double result = v_last - v_first + corr;
        const double sampled = (double)wsub(t_last, t_first);
        const double n_samples = (double)(right - left);
        const double nm1 = n_samples - 1.0;
        const double avg_dur = has2 ? sampled / (nm1 > 1.0 ? nm1 : 1.0) : 0.0;
        double dur_start = (double)wsub(t_first, start_excl);
        const double dur_end = (double)wsub(step, t_last);
        const double threshold = avg_dur * 1.1;
        if (is_counter) {
          const double dur_to_zero = (result > 0.0 && v_first >= 0.0)
                                         ? sampled * v_first / (result > 0.0 ? result : 1.0)
                                         : INFINITY;
          dur_start = min_ieee(dur_start, dur_to_zero);
        }
        const double extrap_start = dur_start < threshold ? dur_start : avg_dur / 2.0;
        const double extrap_end = dur_end < threshold ? dur_end : avg_dur / 2.0;
        const double interval = sampled + extrap_start + extrap_end;
        double o = result * (interval / (sampled > 1.0 ? sampled : 1.0));
        if (is_rate) o = o / ((double)range_nanos * 1e-9);
        r = (has2 && sampled > 0.0) ? o : nan;
      } else if (op == kInstant) {
        const long long i_last = clampi(right - 1, 0, N - 1), i_prev = clampi(right - 2, 0, N - 1);
        const double v_last = v[i_last];
        double dv = v_last - v[i_prev];
        if (is_rate) dv = dv < 0.0 ? v_last : dv;
        const double dt = (double)wsub(t[i_last], t[i_prev]) * 1e-9;
        const double o = is_rate ? dv / (dt > 1e-9 ? dt : 1e-9) : dv;
        r = has2 ? o : nan;
      } else if (op == kLast) {
        r = right == left ? nan : v[clampi(right - 1, 0, N - 1)];
      } else if (op == kChanges || op == kResets) {
        const int events = C[clampi(right - 1, 0, N - 1)] - C[clampi(left, 0, N - 1)];
        r = right > left ? (double)events : nan;
      } else if (linreg) {
        // the closed form of the reference, recentred on the step time
        const double* P1 = P + (N + 1);
        const double* P2 = P + 2 * (N + 1);
        const double* P3 = P + 3 * (N + 1);
        const double n = (double)C[right] - (double)C[left];
        const double sv = P[right] - P[left];
        const double st = P1[right] - P1[left];
        const double stv = P2[right] - P2[left];
        const double stt = P3[right] - P3[left];
        const double step_sec = (double)wsub(step, origin) * 1e-9;
        const double st_ = st - n * step_sec;
        const double stv_ = stv - step_sec * sv;
        const double stt_ = stt - 2.0 * step_sec * st + n * step_sec * step_sec;
        const double denom = n * stt_ - st_ * st_;
        const double slope = (n * stv_ - st_ * sv) / denom;
        const double nn = n > 1.0 ? n : 1.0;
        const double intercept = sv / nn - slope * (st_ / nn);
        const bool valid = n >= 2.0 && fabs(denom) > 1e-30;
        r = !valid ? nan : (op == kDeriv ? slope : intercept + slope * horizon);
      } else {
        const double sum = P[right] - P[left];
        const double n = (double)C[right] - (double)C[left];
        double o;
        if (op == kSum) o = sum;
        else if (op == kAvg) o = sum / (n > 1.0 ? n : 1.0);
        else if (op == kCount) o = n;
        else o = n > 0.0 ? 1.0 : nan;
        r = right == left ? nan : o;
      }
      out[lane * S + s] = r;
    }
    __syncthreads();  // every step has read P and C before the next lane rewrites them
  }
}

// max as XLA computes it on non-NaN operands: -0.0 orders below +0.0, so
// the result does not depend on the order the window is scanned in.
__device__ __forceinline__ double max_ieee(double a, double b) {
  if (a > b) return a;
  if (b > a) return b;
  return signbit(a) ? b : a;
}

// QK5.  The reference answers a window from a two-level range-max
// structure (32-sample block prefix/suffix cummax and a doubling table over
// the block maxima), because a TPU program cannot loop over a window of
// its own length.  Here each thread owns one (lane, step): the same two
// bisections as temporal_kernel, then a direct scan of [left, right).  The
// max of a set is the same whatever structure computes it, with the one
// exception of signed zeros, and max_ieee makes those order-free too.
// min runs, as in the reference, as -max(-v): NaN samples are absent, a
// window with no present sample is NaN, +-Inf are values.  Lanes are taken
// by blocks in turn, so the window loads of neighbouring steps share L1.
//
// What bounds it on an H100: bytes (each lane's times and values read
// once, one f64 written per (lane, step)); a window of w samples costs w
// loads from L1.
__global__ void __launch_bounds__(kThreads) minmax_kernel(
    const long long* __restrict__ times, const double* __restrict__ values,
    const long long* __restrict__ steps, long long L, long long N, int S, int levels,
    long long range_nanos, int is_max, double* __restrict__ out) {
  const double nan = nan_value();
  for (long long lane = blockIdx.x; lane < L; lane += gridDim.x) {
    const long long* t = times + lane * N;
    const double* v = values + lane * N;
    for (int s = threadIdx.x; s < S; s += kThreads) {
      const long long step = steps[s];
      const long long left = search_right(t, N, levels, wsub(wsub(step, range_nanos), 1));
      const long long right = search_right(t, N, levels, step);
      double acc = -INFINITY;
      long long n = 0;
      for (long long j = left; j < right; ++j) {
        const double x = v[j];
        if (isnan(x)) continue;
        acc = max_ieee(acc, is_max ? x : -x);
        ++n;
      }
      out[lane * S + s] = n > 0 ? (is_max ? acc : -acc) : nan;
    }
  }
}

// QK9.  The reference merges Welford (n, mean, M2) summaries (Chan's
// method) over the same 32-sample block structure as _minmax_device,
// because a TPU program cannot loop over a window of its own length.  Here
// each thread owns one (lane, step): the two bisections, then a direct
// two-pass over [left, right): the mean of the present samples, then the
// sum of their squared deviations, both in sample order.  The two-pass
// form keeps the 1e9-offset counters the Chan merges exist for (no E[x^2]
// term).  The host contract: population variance M2 / max(n, 1); NaN
// samples are absent; an empty window is NaN, one of only NaN samples 0.0;
// stddev = sqrt(max(var, 0)).
//
// What bounds it on an H100: bytes, as QK5; a window of w samples costs 2w
// loads from L1.
__global__ void __launch_bounds__(kThreads) stdvar_kernel(
    const long long* __restrict__ times, const double* __restrict__ values,
    const long long* __restrict__ steps, long long L, long long N, int S, int levels,
    long long range_nanos, int is_stddev, double* __restrict__ out) {
  const double nan = nan_value();
  for (long long lane = blockIdx.x; lane < L; lane += gridDim.x) {
    const long long* t = times + lane * N;
    const double* v = values + lane * N;
    for (int s = threadIdx.x; s < S; s += kThreads) {
      const long long step = steps[s];
      const long long left = search_right(t, N, levels, wsub(wsub(step, range_nanos), 1));
      const long long right = search_right(t, N, levels, step);
      double sum = 0.0, n = 0.0;
      for (long long j = left; j < right; ++j) {
        const double x = v[j];
        if (isnan(x)) continue;
        sum = sum + x;
        n = n + 1.0;
      }
      const double nn = n > 1.0 ? n : 1.0;
      const double mean = sum / nn;
      double m2 = 0.0;
      for (long long j = left; j < right; ++j) {
        const double x = v[j];
        if (isnan(x)) continue;
        const double d = x - mean;
        m2 = m2 + d * d;
      }
      double var = m2 / nn;
      if (is_stddev) var = sqrt(var < 0.0 ? 0.0 : var);
      out[lane * S + s] = right > left ? var : nan;
    }
  }
}

// QK10.  The reference composes per-sample affine maps of the (level,
// trend) state over the 32-sample block structure (a TPU program cannot
// run a recurrence over a window of its own length) and runs the
// recurrence directly only inside one block.  Here each thread owns one
// (lane, step) and runs the recurrence of the host loop over the
// window's present samples: level = the first, trend = second - first,
// then from the second on level' = sf*x + (1-sf)*(level+trend), trend' =
// tf*(level'-level) + (1-tf)*trend.  Fewer than 2 present samples: NaN.
// sf and tf are kernel arguments.
//
// What bounds it on an H100: bytes (each lane read once, one f64 written
// per (lane, step)); a window of w samples is w loads from L1 and ~10 FP64
// operations per present sample.
__global__ void __launch_bounds__(kThreads) holt_winters_kernel(
    const long long* __restrict__ times, const double* __restrict__ values,
    const long long* __restrict__ steps, long long L, long long N, int S, int levels,
    long long range_nanos, double sf, double tf, double* __restrict__ out) {
  const double nan = nan_value();
  const double sf1 = 1.0 - sf, tf1 = 1.0 - tf;
  for (long long lane = blockIdx.x; lane < L; lane += gridDim.x) {
    const long long* t = times + lane * N;
    const double* v = values + lane * N;
    for (int s = threadIdx.x; s < S; s += kThreads) {
      const long long step = steps[s];
      const long long left = search_right(t, N, levels, wsub(wsub(step, range_nanos), 1));
      const long long right = search_right(t, N, levels, step);
      double level = 0.0, trend = 0.0;
      long long seen = 0;
      for (long long j = left; j < right; ++j) {
        const double x = v[j];
        if (isnan(x)) continue;
        if (seen == 0) {
          level = x;
        } else {
          if (seen == 1) trend = x - level;
          const double nl = sf * x + sf1 * (level + trend);
          const double nt = tf * (nl - level) + tf1 * trend;
          level = nl;
          trend = nt;
        }
        ++seen;
      }
      out[lane * S + s] = seen >= 2 ? level : nan;
    }
  }
}

}  // namespace

extern "C" {

// times i64[L, N] (ascending, INT64_MAX padded), values f64[L, N], steps
// i64[S] -> out f64[L, S]; left_out/right_out i64[L, S] or null.  `levels`
// is ceil(log2(N + 1)).  `prefix` f64 is scratch of [n_blocks, rows, N + 1]
// (rows 4 for deriv/predict_linear, else 1) and `prefix_counts` i32 of
// [n_blocks, N + 1], for a grid of n_blocks blocks.  `horizon` is
// predict_linear's seconds ahead.  Launches on `stream` and returns
// cudaGetLastError().
int m3_query_temporal(const long long* times, const double* values, const long long* steps,
                      long long L, long long N, int S, int levels, long long range_nanos, int op,
                      int is_counter, int is_rate, double horizon, double* out,
                      long long* left_out, long long* right_out, double* prefix,
                      int* prefix_counts, int n_blocks, void* stream) {
  if (op < kRate || op > kPredict || N < 1 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  if (L <= 0 || S <= 0) return (int)cudaSuccess;
  temporal_kernel<<<(unsigned)n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      times, values, steps, L, N, S, levels, range_nanos, op, is_counter, is_rate, horizon, out,
      left_out, right_out, prefix, prefix_counts);
  return (int)cudaGetLastError();
}

// QK9: times i64[L, N], values f64[L, N], steps i64[S] -> out f64[L, S],
// stddev_over_time when is_stddev, else stdvar_over_time, on a grid of
// n_blocks blocks.  Launches on `stream` and returns cudaGetLastError().
int m3_query_stdvar(const long long* times, const double* values, const long long* steps,
                    long long L, long long N, int S, int levels, long long range_nanos,
                    int is_stddev, double* out, int n_blocks, void* stream) {
  if (N < 1 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  if (L <= 0 || S <= 0) return (int)cudaSuccess;
  stdvar_kernel<<<(unsigned)n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      times, values, steps, L, N, S, levels, range_nanos, is_stddev, out);
  return (int)cudaGetLastError();
}

// QK10: times i64[L, N], values f64[L, N], steps i64[S] -> out f64[L, S],
// holt_winters with smoothing factor sf and trend factor tf, on a grid of
// n_blocks blocks.  Launches on `stream` and returns cudaGetLastError().
int m3_query_holt_winters(const long long* times, const double* values, const long long* steps,
                          long long L, long long N, int S, int levels, long long range_nanos,
                          double sf, double tf, double* out, int n_blocks, void* stream) {
  if (N < 1 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  if (L <= 0 || S <= 0) return (int)cudaSuccess;
  holt_winters_kernel<<<(unsigned)n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      times, values, steps, L, N, S, levels, range_nanos, sf, tf, out);
  return (int)cudaGetLastError();
}

// QK5: times i64[L, N], values f64[L, N], steps i64[S] -> out f64[L, S],
// max_over_time when is_max, else min_over_time, on a grid of n_blocks
// blocks.  Launches on `stream` and returns cudaGetLastError().
int m3_query_minmax(const long long* times, const double* values, const long long* steps,
                    long long L, long long N, int S, int levels, long long range_nanos,
                    int is_max, double* out, int n_blocks, void* stream) {
  if (N < 1 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  if (L <= 0 || S <= 0) return (int)cudaSuccess;
  minmax_kernel<<<(unsigned)n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      times, values, steps, L, N, S, levels, range_nanos, is_max, out);
  return (int)cudaGetLastError();
}

const char* m3_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
