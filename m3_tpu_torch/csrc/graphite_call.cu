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
// Layout.  A warp owns 32 lanes (rows) and moves along the steps a tile of
// kT steps at a time.  It stages each [32 rows x kT steps] tile in shared
// memory as coalesced row segments (cp.async, rows padded to kPitch against
// bank conflicts), with the next tile's copy in flight; each thread then
// walks its own row's kT steps from shared memory in column order, carrying
// its state in registers from tile to tile, writes its results into a
// staged slot, and the warp stores that slot back as coalesced rows.
// Columns at and past real_S are never read (the slot holds NaN there).
//
// Order.  The scans (integral, integralByInterval, keepLastValue,
// summarize, offsetToZero/minMax's two walks) keep the in-order arithmetic
// of the reference's XLA:CPU evaluation (each sum from 0.0 in column
// order), as the plain version (ops/graphite.py:row_transform_plain) does.
// A window of w <= kT cells is summed directly, oldest cell first, from the
// staged current and previous tiles.  A wider window is block-wise, with no
// subtraction (a running difference would turn a window that has dropped an
// Inf into NaN): the columns are cut into aligned blocks of kT; for column c
// in block cb with the window's first column s in block hb < cb, the value
// is (head + mid) + part, where
//   head  the fold of block hb from s to its end, right to left from 0.0
//         (each block's suffix folds are computed once, when the window's
//         start first enters it: the block is staged again from global
//         memory, which is the one extra read of the input);
//   mid   the in-order fold from 0.0 of the whole blocks hb+1..cb-1's
//         in-order sums (kept in a [n_tiles, L] scratch, coalesced);
//   part  the in-order fold of block cb from its start to c.
// So a cell costs O(1), plus O(w / kT) per tile for mid.  The plain version
// repeats this grouping.  max/min over non-NaN operands are associative and
// commutative (min_ieee/max_ieee order -0.0 below +0.0, as XLA's do), and
// the counts are integers, so the block form gives the direct form's bits
// for movingMax/movingMin and for every count.
//
// What bounds it on an H100: bytes (each real cell read once, each cell
// written once; the block windows read each real cell a second time, and
// offsetToZero/minMax walk the cells twice).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 16;                // steps per staged tile and per window block
constexpr int kPitch = kT + 1;        // a staged row, padded against bank conflicts
constexpr int kSlot = 32 * kPitch;    // doubles per staged tile
constexpr int kRowStep = 32 / kT;     // rows one warp copy instruction covers
constexpr int kHeads = 3;             // window head blocks staged (two in use, one in flight)
constexpr int kWarps = 4;             // warps per block

enum Fn : int { kIntegral = 0, kIntegralByInterval = 1, kKeepLastValue = 2, kSummarize = 3,
                kOffsetToZero = 4, kMinMax = 5, kMovingAverage = 6, kMovingSum = 7,
                kMovingMax = 8, kMovingMin = 9 };
enum Func : int { kSum = 0, kAvg = 1, kMax = 2, kMin = 3, kCount = 4, kRange = 5,
                  kMultiply = 6 };

__device__ __forceinline__ double nan_value() { return __longlong_as_double(0x7ff8000000000000LL); }

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

__device__ __forceinline__ void copy_async(double* dst, const double* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void commit_async() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Waits until at most the n most recent groups of this thread's copies are
// in flight.
template <int n>
__device__ __forceinline__ void wait_async() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
#endif
}

// One warp's 32 rows.
struct Rows {
  const double* x;
  double* out;
  long long L, S, n_tiles, row0;
  int real_S, lane;

  // Copies block t (columns [t * kT, t * kT + kT)) of the 32 rows into
  // `slot`, NaN outside the matrix and at or past real_S.
  __device__ void stage(double* slot, long long t) const {
    const long long c = t * kT + lane % kT;
    for (int r = lane / kT; r < 32; r += kRowStep) {
      double* dst = slot + r * kPitch + lane % kT;
      if (row0 + r < L && c < real_S) copy_async(dst, x + (row0 + r) * S + c);
      else *dst = nan_value();
    }
  }

  // Stores `slot` as tile t of the output rows.
  __device__ void unstage(const double* slot, long long t) const {
    const long long c = t * kT + lane % kT;
    if (c >= S) return;
    for (int r = lane / kT; r < 32; r += kRowStep)
      if (row0 + r < L) out[(row0 + r) * S + c] = slot[r * kPitch + lane % kT];
  }
};

struct NoCopies {
  __device__ void operator()(long long) const {}
};

// The staged walk over tiles [0, n): tile t lies in slot t % kSlots, and
// while it is walked the copies of tiles t + 1 .. t + kAhead are in flight
// (one commit group per tile, with the further copies extra(t) issues for
// it).  walk(t, cur, dst) walks tile t (each thread its own row) and writes
// its results into dst, the slot of tile t + kAhead + 1: cur itself when
// kSlots is kAhead + 1, else the previous tile's.  The warp stores dst as
// tile t (if `store`) and then copies tile t + kAhead + 1 into it.
template <int kSlots, int kAhead, class Extra, class Walk>
__device__ void sweep(const Rows& w, double* slots, long long n, bool store, Extra extra,
                      Walk walk) {
  static_assert(kSlots == kAhead + 1 || kSlots == kAhead + 2, "slot ring");
  for (int u = 0; u <= kAhead; ++u) {
    if (u < n) {
      w.stage(slots + u * kSlot, u);
      extra(u);
    }
    commit_async();
  }
  for (long long t = 0; t < n; ++t) {
    wait_async<kAhead>();
    __syncwarp();
    double* cur = slots + (t % kSlots) * kSlot;
    double* dst = slots + ((t + kAhead + 1) % kSlots) * kSlot;
    walk(t, cur, dst);
    __syncwarp();
    if (store) w.unstage(dst, t);
    __syncwarp();
    if (t + kAhead + 1 < n) {
      w.stage(dst, t + kAhead + 1);
      extra(t + kAhead + 1);
    }
    commit_async();
  }
}

// The scans' staged walk: in place, two tiles ahead (three slots, as the
// direct windows take).
constexpr int kScanAhead = 2;
template <class Walk>
__device__ void scan(const Rows& w, double* slots, long long n, bool store, Walk walk) {
  sweep<kScanAhead + 1, kScanAhead>(w, slots, n, store, NoCopies{}, walk);
}

// Staged slots a warp takes: the scans' and the direct windows' three; the
// block windows' two and the head blocks.
__host__ __device__ __forceinline__ int slots_per_warp(int fn, long long k) {
  return fn >= kMovingAverage && k > kT ? 2 + kHeads : kScanAhead + 1;
}

template <int FN>
__device__ __forceinline__ double win_identity() {
  return FN == kMovingMax ? -INFINITY : (FN == kMovingMin ? INFINITY : 0.0);
}

template <int FN>
__device__ __forceinline__ double win_op(double a, double b) {
  return FN == kMovingMax ? max_ieee(a, b) : (FN == kMovingMin ? min_ieee(a, b) : a + b);
}

// The window's result from its fold and its count of present cells
// (movingMax/Min: 0 or 1, whether any is present).
template <int FN>
__device__ __forceinline__ double win_value(double v, int cnt) {
  if (FN == kMovingSum) return v;
  if (cnt == 0) return nan_value();
  return FN == kMovingAverage ? v / (double)cnt : v;
}

// movingX over w <= kT cells: each column's window summed directly, oldest
// cell first, from the current tile and the previous one (the slot the
// results go into: a result lands at offset j only after the columns past j
// no longer need the previous tile's cells at or before j).
template <int FN>
__device__ void moving_direct(const Rows& w, double* slots, int k) {
  double* own = slots + 2 * kSlot + w.lane * kPitch;
  for (int j = 0; j < kT; ++j) own[j] = nan_value();  // the cells before column 0
  sweep<3, 1>(w, slots, w.n_tiles, true, NoCopies{}, [&](long long, double* cur, double* dst) {
    const double* rc = cur + w.lane * kPitch;
    double* rp = dst + w.lane * kPitch;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      double acc = win_identity<FN>();
      int cnt = 0;
      for (int d = k - 1; d >= 0; --d) {
        const double v = j >= d ? rc[j - d] : rp[kT + j - d];
        if (!isnan(v)) {
          acc = win_op<FN>(acc, v);
          ++cnt;
        }
      }
      rp[j] = win_value<FN>(acc, cnt);
    }
  });
}

// movingX over w > kT cells, block-wise (see the head of the file).  heads:
// kHeads staged slots of window head blocks (block b in slot b % kHeads),
// each turned in place into its suffix folds when it arrives; agg: the
// [n_tiles, L] scratch of each block's in-order fold; agg_cnt: of the
// present cells through each block (movingAverage's counts are differences
// of these running counts, exact in integers: the count through c less the
// count before the window's start, from the head block's presence mask).
template <int FN>
__device__ void moving_blocks(const Rows& w, double* slots, double* heads, long long k,
                              double* agg, int* agg_cnt) {
  const long long row = w.row0 + w.lane;
  const bool mine = row < w.L;
  // the last head block of tile t (-1: none; tile 0's windows lie in it)
  auto last_head = [&](long long t) -> long long {
    if (t <= 0) return -1;
    const long long s = t * kT + kT - k;
    return (s > 0 ? s : 0) / kT;
  };
  double part = 0.0, mid = 0.0, prev_agg = 0.0;
  int count = 0;                  // present cells through the current column
  long long last_present = -1;
  long long mid_head = -1;        // mid folds blocks mid_head + 1 .. t - 1
  long long head = -1;            // the newest head block; `mask`/`before` its presence
  unsigned mask = 0, mask_prev = 0;  // and count before it; *_prev: of block head - 1
  int before = 0, before_prev = 0;
  auto extra = [&](long long t) {
    const long long h = last_head(t);
    if (h >= 0 && h > last_head(t - 1)) w.stage(heads + (h % kHeads) * kSlot, h);
  };
  auto fold_blocks = [&](long long b0, long long b1) {  // blocks b0 .. b1 - 1, in order
    double acc = win_identity<FN>();
    for (long long b = b0; b < b1 && mine; ++b) acc = win_op<FN>(acc, agg[b * w.L + row]);
    return acc;
  };
  sweep<2, 1>(w, slots, w.n_tiles, true, extra, [&](long long t, double* cur, double*) {
    double* r = cur + w.lane * kPitch;
    part = win_identity<FN>();
    if (t == 0) {  // every window of the first tile starts at column 0
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        const double v = r[j];
        if (!isnan(v)) {
          part = win_op<FN>(part, v);
          ++count;
          last_present = j;
        }
        r[j] = win_value<FN>(part, FN == kMovingAverage ? count : (int)(last_present >= 0));
      }
    } else {
      const long long h = last_head(t);
      if (h > head) {  // block h arrived: its suffix folds, presence and count before it
        double* q = heads + (h % kHeads) * kSlot + w.lane * kPitch;
        double acc = win_identity<FN>();
        unsigned m = 0;
#pragma unroll
        for (int j = kT - 1; j >= 0; --j) {
          const double v = q[j];
          if (!isnan(v)) {
            acc = win_op<FN>(v, acc);
            m |= 1u << j;
          }
          q[j] = acc;
        }
        mask_prev = mask;
        before_prev = before;
        mask = m;
        before = FN == kMovingAverage && h > 0 && mine ? agg_cnt[(h - 1) * w.L + row] : 0;
        head = h;
      }
      // the tile's windows start in block h0 (the first columns) and h
      const long long base = t * kT - k + 1;
      const long long h0 = (base > 0 ? base : 0) / kT;
      const double mid0 = h0 == mid_head ? win_op<FN>(mid, prev_agg) : fold_blocks(h0 + 1, t);
      const double mid1 = h0 == head ? mid0 : fold_blocks(head + 1, t);
      mid = mid1;
      mid_head = head;
      const double* q0 = heads + (h0 % kHeads) * kSlot + w.lane * kPitch;
      const double* q1 = heads + (head % kHeads) * kSlot + w.lane * kPitch;
      const unsigned m0 = h0 == head ? mask : mask_prev;
      const int b0 = h0 == head ? before : before_prev;
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        const double v = r[j];
        if (!isnan(v)) {
          part = win_op<FN>(part, v);
          ++count;
          last_present = t * kT + j;
        }
        const long long s = base + j > 0 ? base + j : 0;
        const bool second = (s / kT) != h0;
        const int off = (int)(s % kT);
        const double acc = win_op<FN>(win_op<FN>((second ? q1 : q0)[off], second ? mid1 : mid0),
                                      part);
        int cnt = last_present >= s;
        if (FN == kMovingAverage)
          cnt = count - (second ? before : b0) -
                __popc((second ? mask : m0) & ((1u << off) - 1u));
        r[j] = win_value<FN>(acc, cnt);
      }
    }
    if (mine) {
      agg[t * w.L + row] = part;
      if (FN == kMovingAverage) agg_cnt[t * w.L + row] = count;
    }
    prev_agg = part;
  });
}

template <int FN>
__device__ void moving(const Rows& w, double* slots, long long k, double* agg, int* agg_cnt) {
  if (k <= kT) moving_direct<FN>(w, slots, (int)k);
  else moving_blocks<FN>(w, slots, slots + 2 * kSlot, k, agg, agg_cnt);
}

// summarize's func over one bucket, in order.
struct Bucket {
  double sum = 0.0, prod = 1.0, lo = INFINITY, hi = -INFINITY;
  int cnt = 0;
  __device__ __forceinline__ void add(int func, double v) {
    if (isnan(v)) return;
    ++cnt;
    if (func == kSum || func == kAvg) sum += v;
    else if (func == kMultiply) prod *= v;
    if (func == kMin || func == kRange) lo = min_ieee(lo, v);
    if (func == kMax || func == kRange) hi = max_ieee(hi, v);
  }
  __device__ __forceinline__ double value(int func) const {
    const bool empty = cnt == 0;
    switch (func) {
      case kSum: return sum;
      case kAvg: return empty ? nan_value() : sum / (double)cnt;
      case kMax: return empty ? nan_value() : hi;
      case kMin: return empty ? nan_value() : lo;
      case kCount: return (double)cnt;
      case kRange: return empty ? nan_value() : hi - lo;
      default: return prod;  // kMultiply
    }
  }
};

// summarize: the bucket values first, each into its lane's output row at the
// bucket's index (never past the bucket's own columns); then every column
// takes its bucket's value, the tiles in descending order so that a value is
// read before its column is overwritten.
__device__ void summarize(const Rows& w, double* slots, long long k, int func) {
  const long long row = w.row0 + w.lane;
  Bucket b;
  const long long n_real = (w.real_S + kT - 1) / kT;
  scan(w, slots, n_real, false, [&](long long t, double* cur, double*) {
    const double* r = cur + w.lane * kPitch;
    for (int j = 0; j < kT; ++j) {
      const long long c = t * kT + j;
      if (c >= w.real_S) break;
      b.add(func, r[j]);
      if ((c + 1) % k == 0 || c + 1 == w.real_S) {
        if (row < w.L) w.out[row * w.S + c / k] = b.value(func);
        b = Bucket{};
      }
    }
  });
  __syncwarp();
  for (long long t = w.n_tiles - 1; t >= 0; --t) {
    const long long c = t * kT + w.lane % kT;
    for (int r = w.lane / kT; r < 32; r += kRowStep) {
      const long long rr = w.row0 + r;
      const bool ok = rr < w.L && c < w.S;
      const double v = ok && c < w.real_S ? w.out[rr * w.S + c / k] : nan_value();
      __syncwarp();
      if (ok) w.out[rr * w.S + c] = v;
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32) graphite_row_kernel(
    const double* __restrict__ x, long long L, long long S, int real_S, int fn, long long k,
    int func, double limit, double* agg, int* agg_cnt, double* __restrict__ out) {
  extern __shared__ double staged[];
  const int warp = threadIdx.x >> 5;
  Rows w{x, out, L, S, (S + kT - 1) / kT, ((long long)blockIdx.x * kWarps + warp) * 32, real_S,
         (int)(threadIdx.x & 31)};
  if (w.row0 >= L) return;  // the whole warp: no lane of it takes part in a shuffle
  double* slots = staged + (size_t)warp * slots_per_warp(fn, k) * kSlot;
  const long long n_real = (real_S + kT - 1) / kT;
  switch (fn) {
    case kIntegral: {
      double acc = 0.0;
      scan(w, slots, w.n_tiles, true, [&](long long, double* cur, double*) {
        double* r = cur + w.lane * kPitch;
        for (int j = 0; j < kT; ++j) {
          const double v = r[j];
          acc += isnan(v) ? 0.0 : v;
          r[j] = acc;
        }
      });
      return;
    }
    case kIntegralByInterval: {
      double acc = 0.0;
      scan(w, slots, w.n_tiles, true, [&](long long t, double* cur, double*) {
        double* r = cur + w.lane * kPitch;
        for (int j = 0; j < kT; ++j) {
          const long long c = t * kT + j;
          if (c >= real_S) {
            r[j] = nan_value();
            continue;
          }
          if (c % k == 0) acc = 0.0;
          const double v = r[j];
          acc += isnan(v) ? 0.0 : v;
          r[j] = acc;
        }
      });
      return;
    }
    case kKeepLastValue: {
      double last_v = nan_value();
      long long last_c = -1;
      scan(w, slots, w.n_tiles, true, [&](long long t, double* cur, double*) {
        double* r = cur + w.lane * kPitch;
        for (int j = 0; j < kT; ++j) {
          const long long c = t * kT + j;
          const double v = r[j];
          if (!isnan(v)) {
            last_v = v;
            last_c = c;
          } else {
            r[j] = (last_c >= 0 && (double)(c - last_c) <= limit) ? last_v : nan_value();
          }
        }
      });
      return;
    }
    case kSummarize:
      summarize(w, slots, k, func);
      return;
    case kOffsetToZero:
    case kMinMax: {
      double lo = INFINITY, hi = -INFINITY;
      bool any = false;
      scan(w, slots, n_real, false, [&](long long, double* cur, double*) {
        const double* r = cur + w.lane * kPitch;
        for (int j = 0; j < kT; ++j) {
          const double v = r[j];
          if (isnan(v)) continue;
          any = true;
          lo = min_ieee(lo, v);
          hi = max_ieee(hi, v);
        }
      });
      if (!any) lo = hi = nan_value();
      const double rng = hi - lo;
      const double den = rng == 0.0 ? nan_value() : rng;
      scan(w, slots, w.n_tiles, true, [&](long long, double* cur, double*) {
        double* r = cur + w.lane * kPitch;
        for (int j = 0; j < kT; ++j) {
          if (fn == kOffsetToZero) {
            r[j] = r[j] - lo;
          } else {
            const double v = (r[j] - lo) / den;
            r[j] = isfinite(v) ? v : 0.0;
          }
        }
      });
      return;
    }
    case kMovingAverage:
      moving<kMovingAverage>(w, slots, k, agg, agg_cnt);
      return;
    case kMovingSum:
      moving<kMovingSum>(w, slots, k, agg, agg_cnt);
      return;
    case kMovingMax:
      moving<kMovingMax>(w, slots, k, agg, agg_cnt);
      return;
    default:
      moving<kMovingMin>(w, slots, k, agg, agg_cnt);
      return;
  }
}

// Bytes of the scratch a moving window of width k over [L, S] needs (0
// when it needs none): each block's fold and running count.
long long row_scratch_bytes(long long L, long long S, int fn, long long k) {
  if (fn < kMovingAverage || fn > kMovingMin || k <= kT || L <= 0 || S <= 0) return 0;
  return ((S + kT - 1) / kT) * L * (long long)(sizeof(double) + sizeof(int));
}

}  // namespace

extern "C" {

// x f64[L, S] -> out f64[L, S]: `fn` along each lane, the columns at and
// past real_S read as NaN.  k >= 1: the bucket size (integralByInterval,
// summarize) or window width (moving*); func: summarize's reducer; limit:
// keepLastValue's gap limit; scratch: ((S + kT - 1) / kT) * L * 12 bytes
// for a moving window wider than kT (null otherwise).  Launches on `stream` and returns
// cudaGetLastError().
int m3_graphite_row(const double* x, long long L, long long S, int real_S, int fn, long long k,
                    int func, double limit, void* scratch, long long scratch_bytes, double* out,
                    void* stream) {
  if (fn < kIntegral || fn > kMovingMin || func < kSum || func > kMultiply || k < 1 ||
      real_S < 0 || real_S > S)
    return (int)cudaErrorInvalidValue;
  const long long need = row_scratch_bytes(L, S, fn, k);
  if (need > 0 && (scratch == nullptr || scratch_bytes < need)) return (int)cudaErrorInvalidValue;
  if (L <= 0 || S <= 0) return (int)cudaSuccess;
  const bool blocks = need > 0;
  const size_t smem = (size_t)kWarps * slots_per_warp(fn, k) * kSlot * sizeof(double);
  cudaError_t rc = cudaFuncSetAttribute(graphite_row_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  const long long n_tiles = (S + kT - 1) / kT;
  double* agg = blocks ? (double*)scratch : nullptr;
  int* agg_cnt = blocks ? (int*)((char*)scratch + n_tiles * L * sizeof(double)) : nullptr;
  const long long grid = (L + 32 * kWarps - 1) / (32 * kWarps);
  graphite_row_kernel<<<(unsigned)grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      x, L, S, real_S, fn, k, func, limit, agg, agg_cnt, out);
  return (int)cudaGetLastError();
}

const char* m3_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
