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
// Each row sorts its (order key, column) pairs bitonically, so the order is
// the stable ascending one with -0.0 == +0.0 and NaN after +inf
// (jnp.argsort's order); the sorted weights' running sums cw come from a
// parallel scan; the target of q is q * total (total = cw[K - 1]) and the
// index the count of cw < target, clipped to [0, K - 1], taken per quantile
// by a ballot or a block count.  Three tiers by row length:
// - K <= kWarpK (32): P = K rounded up to a power of two lanes a row, 32 / P
//   rows a warp, in registers: a sub-warp sort by __shfl_xor_sync, a
//   segmented __shfl_up_sync scan, a masked ballot (quantiles_warp_kernel);
// - P <= kSmemMaxP (8,192): one block of P / E threads a row, E = 2, 4 or
//   8 samples a thread in registers; the sort's stages within a warp run by
//   shuffles and register swaps, only those pairing two warps through
//   dynamic shared memory (20 B a pair with the row's weights; past 48 KB
//   after cudaFuncSetAttribute); a warp scan of each 32 positions carried
//   over e, then a block scan of the warps' sums (quantiles_smem_kernel);
// - longer rows: one block a row on its slice of a global scratch buffer,
//   every stage there, a contiguous run of positions a thread in the scan,
//   the weights read from the row, so K has no ceiling
//   (quantiles_scratch_kernel).
// The scan groups the additions differently from the reference's running
// sum (jnp.cumsum, the plain version's torch.cumsum): the bits are the same
// whenever every partial sum is exact, as it is for the pool's power-of-two
// weights (aggregator/elems.py:_compact_reservoir); that is the contract of
// aggregator/elems.py:padded_quantiles.  Bound: the bytes (each sample and
// weight read once) for short rows; for long rows the sort's P log2(P)^2 / 4
// compare-exchanges, which one block a row cannot spread over the card when
// F is small (64 x 4,096: 64 blocks on 132 SMs).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr long long kEmpty = -(1ll << 62);
constexpr int kThreads = 128;
constexpr int kMaxQ = 32;
constexpr unsigned kFull = 0xffffffffu;
// A1c's tiers: rows of at most kWarpK samples in registers, 32 / P rows a
// warp; padded rows of at most kSmemMaxP pairs in dynamic shared memory,
// one block a row; longer ones in global scratch.
constexpr int kWarpK = 32;
constexpr int kWarpTierThreads = 256;
constexpr int kBlockTierThreads = 1024;
constexpr int kSmemMaxP = 8192;

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

// (key, column) order: the columns are distinct, so it is total and stable.
__device__ __forceinline__ bool pair_gt(unsigned long long ka, int ca, unsigned long long kb,
                                        int cb) {
  return ka > kb || (ka == kb && ca > cb);
}

// The picked sample as the reference returns it: inf -> 0, the masked sum's
// -0.0 + 0.0 = +0.0 for K > 1, and 0 where the row's total is not positive.
__device__ __forceinline__ double picked(double p, int K, double total) {
  if (isinf(p)) p = 0.0;
  if (K > 1 && p == 0.0) p = 0.0;
  return total > 0.0 ? p : 0.0;
}

// Rows of K <= kWarpK: S = P lanes a row, 32 / S rows a warp, one sample a
// lane in registers.  A bitonic sort of (key, column) across the row's lanes
// by __shfl_xor_sync, the sorted weights fetched from the lane that loaded
// them, a segmented inclusive scan by __shfl_up_sync of width S, then per
// quantile one ballot of `cw < target` masked to the row's lanes.
__global__ void __launch_bounds__(kWarpTierThreads) quantiles_warp_kernel(
    const double* __restrict__ values, const double* __restrict__ weights, long long F, int K,
    int S, Quantiles qs, int n_q, double* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int i = lane & (S - 1);  // the sample's column in its row
  const int seg = lane - i;      // the row's first lane
  const unsigned seg_mask = S == 32 ? 0xffffffffu : ((1u << S) - 1u) << seg;
  const int rows_per_warp = 32 / S;
  const long long warps = (long long)gridDim.x * (kWarpTierThreads / 32);
  for (long long w = (long long)blockIdx.x * (kWarpTierThreads / 32) + threadIdx.x / 32;
       w * rows_per_warp < F; w += warps) {  // uniform across the warp
    const long long row = w * rows_per_warp + lane / S;
    const bool live = row < F && i < K;
    const double v = live ? values[row * K + i] : 0.0;
    const double wt = live ? weights[row * K + i] : 0.0;
    unsigned long long key = live ? order_key(v) : ~0ull;
    int col = i;
    for (int k = 2; k <= S; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        const unsigned long long pk = __shfl_xor_sync(kFull, key, j);
        const int pc = __shfl_xor_sync(kFull, col, j);
        if (pair_gt(key, col, pk, pc) == (((i & j) == 0) == ((i & k) == 0))) {
          key = pk;
          col = pc;
        }
      }
    }
    double cw = __shfl_sync(kFull, wt, seg + col);
    for (int d = 1; d < S; d <<= 1) {
      const double t = __shfl_up_sync(kFull, cw, d, S);
      if (i >= d) cw = t + cw;
    }
    const double total = __shfl_sync(kFull, cw, seg + K - 1);
    for (int qi = 0; qi < n_q; ++qi) {
      const double target = qs.q[qi] * total;
      const unsigned below = __ballot_sync(kFull, i < K && cw < target) & seg_mask;
      const int at = min(__popc(below), K - 1);
      const int c = __shfl_sync(kFull, col, seg + at);
      const double p = __shfl_sync(kFull, v, seg + c);
      if (row < F && i == (qi & (S - 1))) out[row * n_q + qi] = picked(p, K, total);
    }
  }
}

// Adds a thread's count n of `cw < target` to the block's count of quantile
// qi: a warp's sum by shuffles, then one shared atomic add.
__device__ __forceinline__ void add_below(int* below, int qi, int n, int lane) {
  for (int d = 16; d > 0; d >>= 1) n += __shfl_xor_sync(kFull, n, d);
  if (lane == 0 && n) atomicAdd(&below[qi], n);
}

// Rows of 32 < K, P <= kSmemMaxP: one block of P / E threads a row, E
// samples a thread in registers at positions seg + e * 32 + lane (seg = the
// warp's 32 * E positions).  Of the sort's stages, those whose pairs lie in
// one warp run in registers: j < 32 by __shfl_xor_sync, 32 <= j < 32 * E
// within the thread; only j >= 32 * E goes through shared memory, with
// __syncthreads between stages.  The running weights are a warp's scan of
// each 32 positions, carried over e, then a block scan of the warps' sums.
template <int E>
__global__ void __launch_bounds__(kBlockTierThreads) quantiles_smem_kernel(
    const double* __restrict__ values, const double* __restrict__ weights, long long F, int K,
    int P, Quantiles qs, int n_q, double* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  __shared__ double warp_sum[kBlockTierThreads / 32];
  __shared__ int below[kMaxQ];
  __shared__ double total_sh;
  unsigned long long* keys = smem;
  double* wsh = (double*)(smem + P);
  int* cols = (int*)(wsh + P);
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int seg = warp * 32 * E;
  for (long long row = blockIdx.x; row < F; row += gridDim.x) {
    const double* v = values + row * K;
    const double* w = weights + row * K;
    unsigned long long key[E];
    int col[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = seg + e * 32 + lane;
      key[e] = i < K ? order_key(v[i]) : ~0ull;
      col[e] = i;
      wsh[i] = i < K ? w[i] : 0.0;
    }
    if (tid < n_q) below[tid] = 0;
    // bitonic sort of (key, col) ascending; cols are distinct, so the
    // order is total and equal keys keep their column order (stable)
    for (int k = 2; k <= P; k <<= 1) {
      if (k > 32 * E) {  // stages j = k / 2 .. 32 * E pair positions of two warps
#pragma unroll
        for (int e = 0; e < E; ++e) {
          keys[seg + e * 32 + lane] = key[e];
          cols[seg + e * 32 + lane] = col[e];
        }
        __syncthreads();
        for (int j = k >> 1; j >= 32 * E; j >>= 1) {
          for (int t = tid; t < P / 2; t += nt) {
            const int i = 2 * t - (t & (j - 1)), p = i + j;
            const unsigned long long ki = keys[i], kp = keys[p];
            const int ci = cols[i], cp = cols[p];
            if (pair_gt(ki, ci, kp, cp) == ((i & k) == 0)) {
              keys[i] = kp;
              keys[p] = ki;
              cols[i] = cp;
              cols[p] = ci;
            }
          }
          __syncthreads();
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          key[e] = keys[seg + e * 32 + lane];
          col[e] = cols[seg + e * 32 + lane];
        }
      }
#pragma unroll
      for (int m = E / 2; m >= 1; m >>= 1) {  // j = 32 * m: partner e | m of the thread
        if (32 * m < k) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            if (e & m) continue;
            const int f = e | m;
            const bool asc = ((seg + e * 32 + lane) & k) == 0;
            if (pair_gt(key[e], col[e], key[f], col[f]) == asc) {
              const unsigned long long kt = key[e];
              const int ct = col[e];
              key[e] = key[f];
              col[e] = col[f];
              key[f] = kt;
              col[f] = ct;
            }
          }
        }
      }
      for (int j = (k >> 1) < 16 ? (k >> 1) : 16; j > 0; j >>= 1) {  // partner lane ^ j
        const bool lower = (lane & j) == 0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const unsigned long long pk = __shfl_xor_sync(kFull, key[e], j);
          const int pc = __shfl_xor_sync(kFull, col[e], j);
          const bool asc = ((seg + e * 32 + lane) & k) == 0;
          if (pair_gt(key[e], col[e], pk, pc) == (lower == asc)) {
            key[e] = pk;
            col[e] = pc;
          }
        }
      }
    }
    __syncthreads();  // wsh complete; the block stages' reads of cols done
    // running weights: a warp's scan of each 32 positions, carried over e
    double cw[E];
    double carry = 0.0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      cols[seg + e * 32 + lane] = col[e];
      double x = wsh[col[e]];
      for (int d = 1; d < 32; d <<= 1) {
        const double t = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x = t + x;
      }
      cw[e] = e == 0 ? x : carry + x;
      carry = __shfl_sync(kFull, cw[e], 31);
    }
    if (lane == 0) warp_sum[warp] = carry;
    __syncthreads();
    if (warp == 0) {
      double x = lane < nt / 32 ? warp_sum[lane] : 0.0;
      for (int d = 1; d < 32; d <<= 1) {
        const double t = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x = t + x;
      }
      if (lane < nt / 32) warp_sum[lane] = x;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (warp > 0) cw[e] = warp_sum[warp - 1] + cw[e];
      if (seg + e * 32 + lane == K - 1) total_sh = cw[e];
    }
    __syncthreads();
    const double total = total_sh;
    for (int qi = 0; qi < n_q; ++qi) {
      const double target = qs.q[qi] * total;
      int n = 0;
#pragma unroll
      for (int e = 0; e < E; ++e) n += (seg + e * 32 + lane < K) && cw[e] < target;
      add_below(below, qi, n, lane);
    }
    __syncthreads();
    if (tid < n_q) {
      const int at = min(below[tid], K - 1);
      out[row * n_q + tid] = picked(v[cols[at]], K, total);
    }
    __syncthreads();
  }
}

// Rows past kSmemMaxP: one block of kBlockTierThreads a row on its slice of
// the global scratch (keys u64[P], cols i32[P]); the sort takes P / 2 /
// blockDim.x compare-exchanges a thread a stage.  Then each thread sums the
// sorted weights (read from the row) of a contiguous run of P / blockDim.x
// positions, a block scan of the runs' sums gives each run its base, and a
// second pass writes the running weights over the keys.
__global__ void __launch_bounds__(kBlockTierThreads) quantiles_scratch_kernel(
    const double* __restrict__ values, const double* __restrict__ weights, long long F, int K,
    int P, Quantiles qs, int n_q, unsigned long long* __restrict__ scratch_keys,
    int* __restrict__ scratch_cols, double* __restrict__ out) {
  __shared__ double warp_sum[kBlockTierThreads / 32];
  __shared__ int below[kMaxQ];
  unsigned long long* keys = scratch_keys + (long long)blockIdx.x * P;
  int* cols = scratch_cols + (long long)blockIdx.x * P;
  double* cw = (double*)keys;  // the running weights, written after the sort
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int run = P / nt;  // P and nt are powers of two, nt <= P / 2
  for (long long row = blockIdx.x; row < F; row += gridDim.x) {
    const double* v = values + row * K;
    const double* w = weights + row * K;
    for (int i = tid; i < P; i += nt) {
      keys[i] = i < K ? order_key(v[i]) : ~0ull;
      cols[i] = i;
    }
    if (tid < n_q) below[tid] = 0;
    __syncthreads();
    for (int k = 2; k <= P; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int t = tid; t < P / 2; t += nt) {
          const int i = 2 * t - (t & (j - 1)), p = i + j;
          const unsigned long long ki = keys[i], kp = keys[p];
          const int ci = cols[i], cp = cols[p];
          if (pair_gt(ki, ci, kp, cp) == ((i & k) == 0)) {
            keys[i] = kp;
            keys[p] = ki;
            cols[i] = cp;
            cols[p] = ci;
          }
        }
        __syncthreads();
      }
    }
    const int lo = tid * run;
    double sum = 0.0;
    for (int e = 0; e < run; ++e) {
      const int c = cols[lo + e];
      sum = sum + (c < K ? w[c] : 0.0);
    }
    double incl = sum;
    for (int d = 1; d < 32; d <<= 1) {
      const double t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl = t + incl;
    }
    const double before_lane = __shfl_up_sync(kFull, incl, 1);
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      double x = lane < nt / 32 ? warp_sum[lane] : 0.0;
      for (int d = 1; d < 32; d <<= 1) {
        const double t = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x = t + x;
      }
      if (lane < nt / 32) warp_sum[lane] = x;
    }
    __syncthreads();
    double acc;
    if (warp == 0) acc = lane == 0 ? 0.0 : before_lane;
    else acc = lane == 0 ? warp_sum[warp - 1] : warp_sum[warp - 1] + before_lane;
    for (int e = 0; e < run; ++e) {
      const int c = cols[lo + e];
      acc = acc + (c < K ? w[c] : 0.0);
      cw[lo + e] = acc;
    }
    __syncthreads();
    const double total = cw[K - 1];
    for (int qi = 0; qi < n_q; ++qi) {
      const double target = qs.q[qi] * total;
      int n = 0;
      for (int i = tid; i < K; i += nt) n += cw[i] < target;
      add_below(below, qi, n, lane);
    }
    __syncthreads();
    if (tid < n_q) {
      const int at = min(below[tid], K - 1);
      out[row * n_q + tid] = picked(v[cols[at]], K, total);
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
// of two.  K <= kWarpK takes the warp tier, `grid` blocks of
// kWarpTierThreads.  Longer rows take `grid` blocks of min(P / 2, 1024)
// threads, one row at a time each: the pairs sort in the scratch keys
// u64[grid, P] and cols i32[grid, P] when the caller passes them, else in
// dynamic shared memory (20 B a pair with the weights, P <= kSmemMaxP).
// Returns cudaGetLastError().
int m3_padded_quantiles(const double* values, const double* weights, long long F, int K, int P,
                        const double* quantiles_host, int n_q, int grid,
                        unsigned long long* scratch_keys, int* scratch_cols, double* out,
                        void* stream) {
  if (n_q < 0 || n_q > kMaxQ || K < 1 || P < K || (P & (P - 1)) != 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const bool scratch = scratch_keys != nullptr;
  if (scratch != (scratch_cols != nullptr)) return (int)cudaErrorInvalidValue;
  if (K > kWarpK && !scratch && P > kSmemMaxP) return (int)cudaErrorInvalidValue;
  if (F <= 0 || n_q == 0) return 0;
  Quantiles qs;
  for (int i = 0; i < n_q; ++i) qs.q[i] = quantiles_host[i];
  const cudaStream_t st = (cudaStream_t)stream;
  if (K <= kWarpK) {
    quantiles_warp_kernel<<<grid, kWarpTierThreads, 0, st>>>(values, weights, F, K, P, qs, n_q,
                                                            out);
    return (int)cudaGetLastError();
  }
  if (scratch) {
    quantiles_scratch_kernel<<<grid, kBlockTierThreads, 0, st>>>(
        values, weights, F, K, P, qs, n_q, scratch_keys, scratch_cols, out);
    return (int)cudaGetLastError();
  }
  // E samples a thread: 2 up to 2,048 pairs, then P / 1,024
  const size_t smem = (size_t)P * (2 * sizeof(double) + sizeof(int));
  const int E = P <= 2 * kBlockTierThreads ? 2 : P / kBlockTierThreads;
  void (*kernel)(const double*, const double*, long long, int, int, Quantiles, int, double*) =
      E == 2 ? quantiles_smem_kernel<2> : E == 4 ? quantiles_smem_kernel<4>
                                                 : quantiles_smem_kernel<8>;
  if (smem > 48 * 1024) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  kernel<<<grid, P / E, smem, st>>>(values, weights, F, K, P, qs, n_q, out);
  return (int)cudaGetLastError();
}

const char* m3_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
