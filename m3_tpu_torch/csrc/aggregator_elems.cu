// The aggregator's window-slot kernels on Hopper (A1a, A1b, A1c).
//
// Replace m3_tpu/aggregator/elems.py: _scatter_update (A1a), _gather_reset
// (A1b) and padded_quantiles (A1c).  The state of one resolution is eight
// flat [capacity * windows] arrays (win_start, sum, sum_sq, count, min, max,
// last_time, last); it stays on the card and the kernels update it in place
// (the reference donates it to the jitted functions).
//
// A1a, one ingest batch.  No floating-point atomics: their order is not
// fixed, so neither bit-for-bit parity nor run-to-run repeatability would
// hold.  The wrapper groups the batch by slot in arrival order (a stable
// sort of the slot keys, index preparation); one thread per touched slot
// then walks its samples in that order and does what the reference's
// scatters do: newest epoch wins, moments reset when the epoch changed,
// NaN-excluded sum/sum_sq (added in arrival order, no FMA: the file is
// built with --fmad=false), count including NaN, IEEE min/max (-0.0 below
// +0.0), last_time the greatest kept time, last the value of the last-
// arriving kept sample at that time, and the stale count.  Bound: bytes
// (the batch and the touched slots, read once and written once).
//
// A1b, flush.  One thread per flushed slot (the flats are unique) copies
// the eight fields out and, with `reset`, writes the empty slot back.
// Bound: bytes.
//
// A1c, weighted nearest-rank quantiles of an inf-padded [F, K] matrix.
// One block per row: a bitonic sort of (order key, column) pairs, so the
// order is the stable ascending one with -0.0 == +0.0 and NaN after +inf
// (jnp.argsort's order); then one thread walks the sorted weights: the
// target of q is q * total, the index the count of running weights below
// it, clipped to [0, K - 1].  The pairs sit in shared memory when the
// padded row fits (the caller's limit, aggregator/elems.py:SMEM_MAX_P) and
// in a per-block slice of a global scratch buffer when it does not, so K
// has no ceiling.  Bound: the sort's
// compares for long rows, the bytes for short ones.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr long long kEmpty = -(1ll << 62);
constexpr int kThreads = 128;
constexpr int kMaxQ = 32;

__device__ __forceinline__ double min_ieee(double a, double b) {
  return a < b ? a : (b < a ? b : (signbit(a) ? a : b));
}

__device__ __forceinline__ double max_ieee(double a, double b) {
  return a > b ? a : (b > a ? b : (signbit(a) ? b : a));
}

struct State {
  long long* win_start;
  double* sum;
  double* sum_sq;
  long long* count;
  double* min;
  double* max;
  long long* last_time;
  double* last;
};

__global__ void __launch_bounds__(kThreads) scatter_update_kernel(
    State s, const long long* __restrict__ seg_slot, const long long* __restrict__ seg_off,
    long long n_segs, const long long* __restrict__ order, const long long* __restrict__ start,
    const long long* __restrict__ times, const double* __restrict__ values,
    unsigned long long* __restrict__ dropped) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= n_segs) return;
  const long long slot = seg_slot[g];
  const long long lo = seg_off[g], hi = seg_off[g + 1];
  const long long resident = s.win_start[slot];
  long long epoch = resident;
  for (long long k = lo; k < hi; ++k) {
    const long long st = start[order[k]];
    epoch = st > epoch ? st : epoch;
  }
  const bool changed = epoch != resident;
  double sum = changed ? 0.0 : s.sum[slot];
  double sum_sq = changed ? 0.0 : s.sum_sq[slot];
  long long count = changed ? 0 : s.count[slot];
  double mn = changed ? INFINITY : s.min[slot];
  double mx = changed ? -INFINITY : s.max[slot];
  long long lt = changed ? kEmpty : s.last_time[slot];
  double last = changed ? NAN : s.last[slot];
  unsigned long long drop = 0;
  for (long long k = lo; k < hi; ++k) {
    const long long i = order[k];
    const double v = values[i];
    const bool keep = start[i] == epoch;
    const bool contrib = keep && !isnan(v);
    const double vz = contrib ? v : 0.0;
    sum = sum + vz;
    sum_sq = sum_sq + vz * vz;
    count += keep;
    mn = min_ieee(mn, contrib ? v : INFINITY);
    mx = max_ieee(mx, contrib ? v : -INFINITY);
    const long long t = keep ? times[i] : kEmpty;
    lt = t > lt ? t : lt;
    drop += !keep;
  }
  for (long long k = lo; k < hi; ++k) {
    const long long i = order[k];
    if (start[i] == epoch && times[i] == lt) last = values[i];
  }
  s.win_start[slot] = epoch;
  s.sum[slot] = sum;
  s.sum_sq[slot] = sum_sq;
  s.count[slot] = count;
  s.min[slot] = mn;
  s.max[slot] = mx;
  s.last_time[slot] = lt;
  s.last[slot] = last;
  if (drop) atomicAdd(dropped, drop);  // an integer count: any order is exact
}

__global__ void __launch_bounds__(kThreads) gather_reset_kernel(
    State s, const long long* __restrict__ flats, long long n, int reset, State out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long f = flats[i];
  out.win_start[i] = s.win_start[f];
  out.sum[i] = s.sum[f];
  out.sum_sq[i] = s.sum_sq[f];
  out.count[i] = s.count[f];
  out.min[i] = s.min[f];
  out.max[i] = s.max[f];
  out.last_time[i] = s.last_time[f];
  out.last[i] = s.last[f];
  if (reset) {
    s.win_start[f] = kEmpty;
    s.sum[f] = 0.0;
    s.sum_sq[f] = 0.0;
    s.count[f] = 0;
    s.min[f] = INFINITY;
    s.max[f] = -INFINITY;
    s.last_time[f] = kEmpty;
    s.last[f] = NAN;
  }
}

struct Quantiles {
  double q[kMaxQ];
};

// Unsigned key whose order is the float order with -0.0 == +0.0 and every
// NaN after +inf; padding past K gets the largest key.
__device__ __forceinline__ unsigned long long order_key(double v) {
  if (isnan(v)) v = NAN;
  if (v == 0.0) v = 0.0;
  const unsigned long long b = (unsigned long long)__double_as_longlong(v);
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}

__global__ void padded_quantiles_kernel(const double* __restrict__ values,
                                        const double* __restrict__ weights, long long F, int K,
                                        int P, Quantiles qs, int n_q,
                                        unsigned long long* __restrict__ scratch_keys,
                                        int* __restrict__ scratch_cols, double* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* keys;
  int* cols;
  if (scratch_keys != nullptr) {
    keys = scratch_keys + (long long)blockIdx.x * P;
    cols = scratch_cols + (long long)blockIdx.x * P;
  } else {
    keys = smem;
    cols = (int*)(smem + P);
  }
  const int tid = threadIdx.x, nt = blockDim.x;
  for (long long row = blockIdx.x; row < F; row += gridDim.x) {
    const double* v = values + row * K;
    const double* w = weights + row * K;
    for (int i = tid; i < P; i += nt) {
      keys[i] = i < K ? order_key(v[i]) : ~0ull;
      cols[i] = i;
    }
    __syncthreads();
    // bitonic sort of (key, col) ascending; cols are distinct, so the
    // order is total and equal keys keep their column order (stable)
    for (int k = 2; k <= P; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < P; i += nt) {
          const int p = i ^ j;
          if (p > i) {
            const unsigned long long ki = keys[i], kp = keys[p];
            const int ci = cols[i], cp = cols[p];
            const bool gt = ki > kp || (ki == kp && ci > cp);
            if (gt == ((i & k) == 0)) {
              keys[i] = kp;
              keys[p] = ki;
              cols[i] = cp;
              cols[p] = ci;
            }
          }
        }
        __syncthreads();
      }
    }
    if (tid == 0) {
      double total = 0.0;
      for (int i = 0; i < K; ++i) total = total + w[cols[i]];
      double target[kMaxQ];
      int below[kMaxQ];
      for (int qi = 0; qi < n_q; ++qi) {
        target[qi] = qs.q[qi] * total;
        below[qi] = 0;
      }
      double cw = 0.0;
      for (int i = 0; i < K; ++i) {
        cw = cw + w[cols[i]];
        for (int qi = 0; qi < n_q; ++qi) below[qi] += cw < target[qi];
      }
      for (int qi = 0; qi < n_q; ++qi) {
        const int at = below[qi] < K - 1 ? below[qi] : K - 1;
        double p = v[cols[at]];
        if (isinf(p)) p = 0.0;
        if (K > 1 && p == 0.0) p = 0.0;  // the reference's masked sum: -0.0 + 0.0
        out[row * n_q + qi] = total > 0.0 ? p : 0.0;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// State: eight device pointers in ElemState order.  Batch grouped by slot:
// seg_slot i64[n_segs], seg_off i64[n_segs + 1] into order i64[N] (sample
// indices, arrival order within a slot); start/times i64[N], values f64[N];
// dropped u64[1] accumulates the stale count.  Returns cudaGetLastError().
int m3_scatter_update(void* const* state, const long long* seg_slot, const long long* seg_off,
                      long long n_segs, const long long* order, const long long* start,
                      const long long* times, const double* values, unsigned long long* dropped,
                      void* stream) {
  if (n_segs <= 0) return 0;
  State s{(long long*)state[0], (double*)state[1], (double*)state[2], (long long*)state[3],
          (double*)state[4],    (double*)state[5], (long long*)state[6], (double*)state[7]};
  const long long blocks = (n_segs + kThreads - 1) / kThreads;
  scatter_update_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      s, seg_slot, seg_off, n_segs, order, start, times, values, dropped);
  return (int)cudaGetLastError();
}

// flats i64[n] (unique) -> out: eight device pointers of [n]; resets the
// slots when `reset`.  Returns cudaGetLastError().
int m3_gather_reset(void* const* state, const long long* flats, long long n, int reset,
                    void* const* out, void* stream) {
  if (n <= 0) return 0;
  State s{(long long*)state[0], (double*)state[1], (double*)state[2], (long long*)state[3],
          (double*)state[4],    (double*)state[5], (long long*)state[6], (double*)state[7]};
  State o{(long long*)out[0], (double*)out[1], (double*)out[2], (long long*)out[3],
          (double*)out[4],    (double*)out[5], (long long*)out[6], (double*)out[7]};
  const long long blocks = (n + kThreads - 1) / kThreads;
  gather_reset_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(s, flats, n, reset,
                                                                               o);
  return (int)cudaGetLastError();
}

// values/weights f64[F, K] -> out f64[F, n_q].  P is K rounded up to a power
// of two.  The pairs sort in the scratch keys u64[grid, P] and cols
// i32[grid, P] when the caller passes them, else in shared memory (12 B a
// pair, at most the 48 KB default dynamic limit).  Returns
// cudaGetLastError().
int m3_padded_quantiles(const double* values, const double* weights, long long F, int K, int P,
                        const double* quantiles_host, int n_q, int grid, int threads,
                        unsigned long long* scratch_keys, int* scratch_cols, double* out,
                        void* stream) {
  if (n_q < 0 || n_q > kMaxQ || K < 1 || P < K || (P & (P - 1)) != 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const bool scratch = scratch_keys != nullptr;
  if (scratch != (scratch_cols != nullptr)) return (int)cudaErrorInvalidValue;
  if (F <= 0 || n_q == 0) return 0;
  Quantiles qs;
  for (int i = 0; i < n_q; ++i) qs.q[i] = quantiles_host[i];
  const size_t smem = scratch ? 0 : (size_t)P * (sizeof(unsigned long long) + sizeof(int));
  padded_quantiles_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      values, weights, F, K, P, qs, n_q, scratch_keys, scratch_cols, out);
  return (int)cudaGetLastError();
}

const char* m3_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
