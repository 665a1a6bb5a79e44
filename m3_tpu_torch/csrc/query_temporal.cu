// Windowed PromQL temporal functions over merged lanes on Hopper.
//
// Replaces, from m3_tpu/models/query_pipeline.py:
//   QK2  _window_bounds_device (:85), _rate_device (:98) and
//        _instant_device (:683): rate / increase / delta and irate / idelta,
//        one launch of temporal_kernel, with an op code;
//   QK3  the prefix-sum half of _reduce_device (:474): sum_over_time,
//        avg_over_time, count_over_time, present_over_time, last_over_time;
//        _changes_device (:415): changes / resets; _linreg_device (:437):
//        deriv / predict_linear: one launch of prefix_kernel (below), with
//        the same op codes;
//   QK5  _minmax_device (:205): min_over_time / max_over_time, one launch
//        of minmax_kernel (below).
//   QK9  _stdvar_device (:344): stddev_over_time / stdvar_over_time, one
//        launch of stdvar_kernel (below).
//   QK10 _holt_winters_device (:540): holt_winters, one launch of
//        holt_winters_kernel (below).
//
// temporal_kernel: each block takes lanes in turn (lane = blockIdx.x, +=
// gridDim.x).  For a counter rate it first builds the lane's prefix sums of
// the reset corrections where(v[j+1] < v[j], v[j], 0) in its own slice of a
// global scratch buffer [gridDim.x, N + 1], so a lane may be of any length
// (the grid is a few blocks per SM, so the scratch stays in L2 at the
// serving shapes), scanned tile by tile in a fixed order (so the bits do
// not change from run to run).  Then one thread per step does the two
// searchsorted(side="right") bisections over the lane's times, with the
// reference's fixed number of levels ceil(log2(N + 1)) so that an unsorted
// (error) lane gets the same bounds as in JAX, and evaluates the function.
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

__host__ __device__ constexpr bool is_prefix_op(int op) { return op >= kSum && op <= kPredict; }

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

// P[k] = the sum of a counter's reset corrections where(v[j+1] < v[j],
// v[j], 0) over the pairs j < k, for k in [0, n_terms].  The terms are
// scanned in tiles of kThreads consecutive ones, thread t taking term base +
// t, so loads and stores are coalesced: a shuffle scan within each warp,
// the warp totals added in warp order, and the running total of the tiles
// before (the same bits in every thread) added first.
__device__ void block_prefix(const double* v, long long n_terms, double* P) {
  __shared__ double warp_s[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double carry_s = 0.0;
  for (long long base = 0; base < n_terms; base += kThreads) {
    const long long j = base + threadIdx.x;
    double incl_s = 0.0;
    if (j < n_terms) {
      const double prev = v[j], curr = v[j + 1];
      incl_s = curr < prev ? prev : 0.0;
    }
    for (int o = 1; o < 32; o <<= 1) {
      const double ys = __shfl_up_sync(0xffffffffu, incl_s, o);
      if (lane >= o) incl_s += ys;
    }
    if (lane == 31) warp_s[warp] = incl_s;
    __syncthreads();
    double run_s = carry_s;
    for (int w = 0; w < warp; ++w) run_s += warp_s[w];
    const double excl_s = __shfl_up_sync(0xffffffffu, incl_s, 1);
    if (j < n_terms) P[j] = lane > 0 ? run_s + excl_s : run_s;
    for (int w = 0; w < kWarps; ++w) carry_s += warp_s[w];
    __syncthreads();  // warp_s is rewritten by the next tile
  }
  if (threadIdx.x == 0) P[n_terms] = carry_s;
  __syncthreads();
}

// QK2: rate / increase / delta (op 0) and irate / idelta (op 1).
__global__ void __launch_bounds__(kThreads) temporal_kernel(
    const long long* __restrict__ times, const double* __restrict__ values,
    const long long* __restrict__ steps, long long L, long long N, int S, int levels,
    long long range_nanos, int op, int is_counter, int is_rate,
    double* __restrict__ out, long long* __restrict__ left_out, long long* __restrict__ right_out,
    double* prefix) {
  double* P = prefix + blockIdx.x * (N + 1);
  const bool counter_prefix = op == kRate && is_counter && N > 1;
  const double nan = nan_value();
  for (long long lane = blockIdx.x; lane < L; lane += gridDim.x) {
    const long long* t = times + lane * N;
    const double* v = values + lane * N;
    if (counter_prefix) block_prefix(v, N - 1, P);

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
      } else {
        const long long i_last = clampi(right - 1, 0, N - 1), i_prev = clampi(right - 2, 0, N - 1);
        const double v_last = v[i_last];
        double dv = v_last - v[i_prev];
        if (is_rate) dv = dv < 0.0 ? v_last : dv;
        const double dt = (double)wsub(t[i_last], t[i_prev]) * 1e-9;
        const double o = is_rate ? dv / (dt > 1e-9 ? dt : 1e-9) : dv;
        r = has2 ? o : nan;
      }
      out[lane * S + s] = r;
    }
    __syncthreads();  // every step has read P before the next lane rewrites it
  }
}

// QK3: the prefix op codes (sum, avg, count, present, last; changes,
// resets; deriv, predict_linear), one block of kPrefixThreads a lane.  The
// reference builds whole prefix-sum rows (cumsum) and answers each window
// by csum[right] - csum[left]; the port keeps that form (so cancellation on
// large counters is the reference's) but never writes the rows:
//
// - the lane's times and values are read once, coalesced, into shared
//   memory (lanes of at most kStagedMaxN samples; longer lanes are read in
//   place, from L1 and L2);
// - one pass scans every row the op needs together: thread c folds its
//   chunk of K consecutive terms (the present count and, for the fit, its
//   four moment sums from one read of t and v), then a block scan of the
//   chunk totals gives E[c], the sum of the terms before chunk c;
// - each step's two bisections run over the times in shared memory (the
//   reference's fixed number of levels, so an unsorted error lane gets
//   JAX's bounds), and P[k] = E[k / K] folded with the terms of k's chunk
//   before k: a function of k alone, so each window is P[right] - P[left]
//   of one set of prefix sums, as in the reference;
// - a block holds no global scratch, so as many lanes are in flight as the
//   SM's shared memory and registers allow (the serving shapes' 2,160
//   samples take 44 KB for the fit).
//
// The terms are the reference's: the pair flags curr != prev (resets: curr
// < prev; a NaN on either side is no event), the NaN-masked values (0.0
// added where absent), and for the fit nan_to_num(v), t, t * v and t * t
// with t in seconds from steps[0] - range (tsec_of), where present.  The
// chunks' order of addition differs from torch.cumsum's: the sums and the
// fit are held to their plain versions at a tolerance, the counts bit for
// bit.
//
// What bounds it on an H100: bytes (each lane's times and values read once,
// one f64 written per (lane, step)).
constexpr int kPrefixThreads = 256;
constexpr int kPrefixWarps = kPrefixThreads / 32;
constexpr int kChunks = kPrefixThreads;  // a chunk of consecutive terms a thread
constexpr long long kStagedMaxN = 6144;  // 98 KB of staged lane: 2 blocks an SM at the most

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

// The op families of prefix_kernel: what it scans.
enum Family : int {
  kFamLast = 0,   // last_over_time: the bounds alone
  kFamFlags = 1,  // changes, resets: the count of pair flags
  kFamSums = 2,   // sum, avg, count, present: the present count and the masked sum
  kFamFit = 3,    // deriv, predict_linear: the present count and four moment sums
};

__host__ __device__ constexpr int sum_rows(int fam) {
  return fam == kFamFit ? 4 : (fam == kFamSums ? 1 : 0);
}

__host__ __device__ inline int family_of(int op) {
  if (op == kLast) return kFamLast;
  if (op == kChanges || op == kResets) return kFamFlags;
  if (op == kDeriv || op == kPredict) return kFamFit;
  return kFamSums;
}

// Running prefix sums: the count and kRows f64 sums (kRows >= 1).
template <int kRows>
struct Prefix {
  int c;
  double s[kRows];
};

// Adds term j to p, in the rows' order of the reference.
template <int kFam>
__device__ __forceinline__ void add_term(Prefix<(sum_rows(kFam) > 0 ? sum_rows(kFam) : 1)>& p,
                                         const long long* t, const double* v, int j,
                                         bool resets, long long origin) {
  if constexpr (kFam == kFamFlags) {
    const double prev = v[j], curr = v[j + 1];
    const bool event = resets ? curr < prev : curr != prev;
    p.c += (event && !isnan(prev) && !isnan(curr)) ? 1 : 0;
  } else if constexpr (kFam == kFamSums) {
    const double x = v[j];
    const bool present = !isnan(x);
    p.s[0] += present ? x : 0.0;
    p.c += present ? 1 : 0;
  } else if constexpr (kFam == kFamFit) {
    const double x = v[j];
    if (!isnan(x)) {
      const double vz = nan_to_num(x);
      const double ts = tsec_of(t[j], origin);
      p.s[0] += vz;
      p.s[1] += ts;
      p.s[2] += ts * vz;
      p.s[3] += ts * ts;
      p.c += 1;
    } else {
      for (int r = 0; r < 4; ++r) p.s[r] += 0.0;
    }
  }
}

// Exclusive block scan of x over the threads in order; `total` gets the
// sum of all.  A shuffle scan within each warp, the warp totals added in
// warp order.
template <typename T>
__device__ __forceinline__ T block_excl_scan(T x, T* warp_tot, T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T incl = x;
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  T run = T(0);
  for (int w = 0; w < warp; ++w) run += warp_tot[w];
  const T prev = __shfl_up_sync(0xffffffffu, incl, 1);
  total = T(0);
  for (int w = 0; w < kPrefixWarps; ++w) total += warp_tot[w];
  __syncthreads();  // warp_tot is rewritten by the next scan
  return lane > 0 ? run + prev : run;
}

// Bytes of prefix_kernel's dynamic shared memory: the chunk table E (the
// f64 rows, then the counts) and, staged, the lane's times and values.
__host__ __device__ inline long long prefix_smem_bytes(int fam, long long N, bool staged) {
  const long long table = (long long)(kChunks + 1) * (8 * sum_rows(fam) + 4);
  const long long lane = staged ? N * (fam == kFamLast ? 8 : 16) : 0;
  return ((table + 7) / 8) * 8 + lane;
}

template <bool kStaged, int kFam>
__global__ void __launch_bounds__(kPrefixThreads) prefix_kernel(
    const long long* __restrict__ times, const double* __restrict__ values,
    const long long* __restrict__ steps, int N, int S, int levels, long long range_nanos, int op,
    double horizon, double* __restrict__ out, long long* __restrict__ left_out,
    long long* __restrict__ right_out) {
  constexpr int kRows = sum_rows(kFam) > 0 ? sum_rows(kFam) : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double warp_s[kPrefixWarps];
  __shared__ int warp_c[kPrefixWarps];
  const long long lane = blockIdx.x;
  const long long* gt = times + lane * N;
  const double* gv = values + lane * N;
  // the table: E_s[r][c] (kRows rows of kChunks + 1), then E_c[c]
  double* E_s = reinterpret_cast<double*>(smem);
  const int table = (kChunks + 1) * (8 * sum_rows(kFam) + 4);
  int* E_c = reinterpret_cast<int*>(smem + 8 * sum_rows(kFam) * (kChunks + 1));
  const long long* t = gt;
  const double* v = gv;
  if constexpr (kStaged) {
    long long* st = reinterpret_cast<long long*>(smem + ((table + 7) / 8) * 8);
    double* sv = reinterpret_cast<double*>(st + N);
    for (int i = threadIdx.x; i < N; i += kPrefixThreads) {
      st[i] = __ldg(gt + i);
      if constexpr (kFam != kFamLast) sv[i] = __ldg(gv + i);
    }
    t = st;
    if constexpr (kFam != kFamLast) v = sv;
    __syncthreads();
  }
  const long long origin = wsub(steps[0], range_nanos);
  const bool resets = op == kResets;
  const int n_terms = kFam == kFamFlags ? N - 1 : N;
  int K = 1;
  if constexpr (kFam != kFamLast) {
    // chunk c holds terms [c * K, min((c + 1) * K, n_terms)); K odd, so the
    // chunks' 8-byte reads of shared memory fall on distinct banks
    K = (n_terms + kChunks - 1) / kChunks;
    K = K < 1 ? 1 : K;
    K |= 1;
    Prefix<kRows> p;
    p.c = 0;
    for (int r = 0; r < kRows; ++r) p.s[r] = 0.0;
    const int lo = threadIdx.x * K;
    const int hi = lo + K < n_terms ? lo + K : n_terms;
    for (int j = lo; j < hi; ++j) add_term<kFam>(p, t, v, j, resets, origin);
    int total_c;
    const int ec = block_excl_scan<int>(p.c, warp_c, total_c);
    E_c[threadIdx.x] = ec;
    if (threadIdx.x == 0) E_c[kChunks] = total_c;
    for (int r = 0; r < sum_rows(kFam); ++r) {
      double total_s;
      const double es = block_excl_scan<double>(p.s[r], warp_s, total_s);
      E_s[r * (kChunks + 1) + threadIdx.x] = es;
      if (threadIdx.x == 0) E_s[r * (kChunks + 1) + kChunks] = total_s;
    }
    __syncthreads();
  }
  // P[k]: E[k / K], then the terms of k's chunk before k
  auto prefix_at = [&](int k) {
    const int c = (unsigned)k / (unsigned)K;
    Prefix<kRows> p;
    p.c = E_c[c];
    for (int r = 0; r < sum_rows(kFam); ++r) p.s[r] = E_s[r * (kChunks + 1) + c];
    for (int j = c * K; j < k; ++j) add_term<kFam>(p, t, v, j, resets, origin);
    return p;
  };
  const double nan = nan_value();
  for (int s = threadIdx.x; s < S; s += kPrefixThreads) {
    const long long step = steps[s];
    const long long left = search_right(t, N, levels, wsub(wsub(step, range_nanos), 1));
    const long long right = search_right(t, N, levels, step);
    if (left_out != nullptr) {
      left_out[lane * S + s] = left;
      right_out[lane * S + s] = right;
    }
    double r;
    if constexpr (kFam == kFamLast) {
      r = right == left ? nan : gv[clampi(right - 1, 0, N - 1)];
    } else if constexpr (kFam == kFamFlags) {
      const int events = prefix_at((int)clampi(right - 1, 0, N - 1)).c -
                         prefix_at((int)clampi(left, 0, N - 1)).c;
      r = right > left ? (double)events : nan;
    } else if constexpr (kFam == kFamSums) {
      const Prefix<kRows> pr = prefix_at((int)right), pl = prefix_at((int)left);
      const double sum = pr.s[0] - pl.s[0];
      const double n = (double)pr.c - (double)pl.c;
      double o;
      if (op == kSum) o = sum;
      else if (op == kAvg) o = sum / (n > 1.0 ? n : 1.0);
      else if (op == kCount) o = n;
      else o = n > 0.0 ? 1.0 : nan;
      r = right == left ? nan : o;
    } else {
      // the closed form of the reference, recentred on the step time
      const Prefix<kRows> pr = prefix_at((int)right), pl = prefix_at((int)left);
      const double n = (double)pr.c - (double)pl.c;
      const double sv = pr.s[0] - pl.s[0];
      const double st = pr.s[1] - pl.s[1];
      const double stv = pr.s[2] - pl.s[2];
      const double stt = pr.s[3] - pl.s[3];
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
    }
    out[lane * S + s] = r;
  }
}

using PrefixKernel = void (*)(const long long*, const double*, const long long*, int, int, int,
                              long long, int, double, double*, long long*, long long*);

inline PrefixKernel prefix_kernel_for(int fam, bool staged) {
  switch (fam) {
    case kFamLast: return staged ? prefix_kernel<true, kFamLast> : prefix_kernel<false, kFamLast>;
    case kFamFlags:
      return staged ? prefix_kernel<true, kFamFlags> : prefix_kernel<false, kFamFlags>;
    case kFamSums: return staged ? prefix_kernel<true, kFamSums> : prefix_kernel<false, kFamSums>;
    default: return staged ? prefix_kernel<true, kFamFit> : prefix_kernel<false, kFamFit>;
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

// QK2: times i64[L, N] (ascending, INT64_MAX padded), values f64[L, N],
// steps i64[S] -> out f64[L, S] of op 0 (rate) or 1 (instant);
// left_out/right_out i64[L, S] or null.  `levels` is ceil(log2(N + 1)).
// `prefix` f64 is scratch of [n_blocks, N + 1] for a grid of n_blocks
// blocks.  Launches on `stream` and returns cudaGetLastError().
int m3_query_temporal(const long long* times, const double* values, const long long* steps,
                      long long L, long long N, int S, int levels, long long range_nanos, int op,
                      int is_counter, int is_rate, double* out, long long* left_out,
                      long long* right_out, double* prefix, int n_blocks, void* stream) {
  if (op < kRate || op > kInstant || N < 1 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  if (L <= 0 || S <= 0) return (int)cudaSuccess;
  temporal_kernel<<<(unsigned)n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      times, values, steps, L, N, S, levels, range_nanos, op, is_counter, is_rate, out,
      left_out, right_out, prefix);
  return (int)cudaGetLastError();
}

// QK3: the same lanes -> out f64[L, S] of a prefix op code (2-10: sum, avg,
// count, present, last; changes, resets; deriv, predict_linear, `horizon`
// seconds ahead); left_out/right_out i64[L, S] or null.  One block a lane.
// Launches on `stream` and returns cudaGetLastError().
int m3_query_prefix(const long long* times, const double* values, const long long* steps,
                    long long L, long long N, int S, int levels, long long range_nanos, int op,
                    double horizon, double* out, long long* left_out, long long* right_out,
                    void* stream) {
  if (!is_prefix_op(op) || N < 1 || N > INT32_MAX / 2 || L > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (L <= 0 || S <= 0) return (int)cudaSuccess;
  const int fam = family_of(op);
  const bool staged = N <= kStagedMaxN;
  const PrefixKernel kernel = prefix_kernel_for(fam, staged);
  const long long smem = prefix_smem_bytes(fam, N, staged);
  cudaError_t rc =
      cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<(unsigned)L, kPrefixThreads, (size_t)smem, (cudaStream_t)stream>>>(
      times, values, steps, (int)N, S, levels, range_nanos, op, horizon, out, left_out,
      right_out);
  return (int)cudaGetLastError();
}

// How prefix_kernel sits on the card for op code `op` on lanes of N
// samples: out = {staged (1) or read in place (0), dynamic shared bytes a
// block, resident blocks per SM, registers a thread, threads a block}.
int m3_query_prefix_layout(int op, long long N, int* out) {
  if (!is_prefix_op(op) || N < 1) return (int)cudaErrorInvalidValue;
  const int fam = family_of(op);
  const bool staged = N <= kStagedMaxN;
  const PrefixKernel kernel = prefix_kernel_for(fam, staged);
  const long long smem = prefix_smem_bytes(fam, N, staged);
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc == cudaSuccess) rc = cudaFuncGetAttributes(&attr, (const void*)kernel);
  int blocks = 0;
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kPrefixThreads,
                                                       (size_t)smem);
  if (rc != cudaSuccess) return (int)rc;
  out[0] = staged ? 1 : 0;
  out[1] = (int)smem;
  out[2] = blocks;
  out[3] = attr.numRegs;
  out[4] = kPrefixThreads;
  return 0;
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
