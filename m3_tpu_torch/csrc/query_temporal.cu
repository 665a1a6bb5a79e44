// Windowed PromQL temporal functions over merged lanes on Hopper.
//
// Replaces, from m3_tpu/models/query_pipeline.py:
//   QK2  _window_bounds_device (:85), _rate_device (:98) and
//        _instant_device (:683): rate / increase / delta and irate / idelta;
//   QK3  the prefix-sum half of _reduce_device (:474): sum_over_time,
//        avg_over_time, count_over_time, present_over_time, last_over_time.
// Both are one launch of temporal_kernel, with an op code.
//
// Each block takes lanes in turn (lane = blockIdx.x, += gridDim.x).  For
// each lane it first builds the lane's prefix sums in its own slice of a
// global scratch buffer [gridDim.x, N + 1], so a lane may be of any length
// (the grid is a few blocks per SM, so the scratch stays in L2 at the
// serving shapes): for a counter rate the reset corrections
// where(v[j+1] < v[j], v[j], 0), for the reducers the NaN-masked values and
// the present counts, scanned tile by tile in a fixed order (so the bits
// do not change from run to run).  Then one thread per step does the two
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
};

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

// The j-th term of the lane's prefix sums.
__device__ __forceinline__ Term term(const double* v, long long j, bool resets) {
  if (resets) {  // pair (j, j+1) of a counter
    const double prev = v[j], curr = v[j + 1];
    return {curr < prev ? prev : 0.0, 0};
  }
  const double x = v[j];
  const bool present = !isnan(x);
  return {present ? x : 0.0, present ? 1 : 0};
}

// P[k] = sum of terms j < k, C likewise, for k in [0, n_terms].  The
// terms are scanned in tiles of kThreads consecutive ones, thread t taking
// term base + t, so loads and stores are coalesced: a shuffle scan within
// each warp, the warp totals added in warp order, and the running total of
// the tiles before (the same bits in every thread) added first.
__device__ void block_prefix(const double* v, long long n_terms, bool resets, double* P, int* C) {
  __shared__ double warp_s[kWarps];
  __shared__ int warp_c[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double carry_s = 0.0;
  int carry_c = 0;
  for (long long base = 0; base < n_terms; base += kThreads) {
    const long long j = base + threadIdx.x;
    const Term x = j < n_terms ? term(v, j, resets) : Term{0.0, 0};
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
      C[j] = lane > 0 ? run_c + excl_c : run_c;
    }
    for (int w = 0; w < kWarps; ++w) {
      carry_s += warp_s[w];
      carry_c += warp_c[w];
    }
    __syncthreads();  // warp_s is rewritten by the next tile
  }
  if (threadIdx.x == 0) {
    P[n_terms] = carry_s;
    C[n_terms] = carry_c;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) temporal_kernel(
    const long long* __restrict__ times, const double* __restrict__ values,
    const long long* __restrict__ steps, long long L, long long N, int S, int levels,
    long long range_nanos, int op, int is_counter, int is_rate, double* __restrict__ out,
    long long* __restrict__ left_out, long long* __restrict__ right_out, double* prefix,
    int* prefix_counts) {
  double* P = prefix + blockIdx.x * (N + 1);
  int* C = prefix_counts + blockIdx.x * (N + 1);
  const bool counter_prefix = op == kRate && is_counter && N > 1;
  const bool reduce_prefix = op == kSum || op == kAvg || op == kCount || op == kPresent;
  const double nan = nan_value();
  for (long long lane = blockIdx.x; lane < L; lane += gridDim.x) {
    const long long* t = times + lane * N;
    const double* v = values + lane * N;
    if (counter_prefix) block_prefix(v, N - 1, true, P, C);
    if (reduce_prefix) block_prefix(v, N, false, P, C);

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

}  // namespace

extern "C" {

// times i64[L, N] (ascending, INT64_MAX padded), values f64[L, N], steps
// i64[S] -> out f64[L, S]; left_out/right_out i64[L, S] or null.  `levels`
// is ceil(log2(N + 1)).  `prefix` f64 and `prefix_counts` i32 are scratch
// of [n_blocks, N + 1] each, for a grid of n_blocks blocks.  Launches on
// `stream` and returns cudaGetLastError().
int m3_query_temporal(const long long* times, const double* values, const long long* steps,
                      long long L, long long N, int S, int levels, long long range_nanos, int op,
                      int is_counter, int is_rate, double* out, long long* left_out,
                      long long* right_out, double* prefix, int* prefix_counts, int n_blocks,
                      void* stream) {
  if (op < kRate || op > kLast || N < 1 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  if (L <= 0 || S <= 0) return (int)cudaSuccess;
  temporal_kernel<<<(unsigned)n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      times, values, steps, L, N, S, levels, range_nanos, op, is_counter, is_rate, out, left_out,
      right_out, prefix, prefix_counts);
  return (int)cudaGetLastError();
}

const char* m3_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
