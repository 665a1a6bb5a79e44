// Order statistics of each group's lanes, per step, on Hopper (QK6, QK7),
// of each window of a lane (QK11, quantile_window_kernel below), and
// Graphite's percentiles over the lanes of a step or the steps of a lane
// (GK2, the graphite_percentile kernels below).
//
// Replaces:
//   QK6  m3_tpu/models/query_pipeline.py:871 _grouped_quantile: the
//        phi-quantile of each group's present cells per step (linear
//        interpolation at h = phi * (n_present - 1); no present cell: NaN);
//   QK7  m3_tpu/ops/lane_topk.py:33 masked_topk: topk/bottomk per (group,
//        step): keep the k best lanes, NaN the rest, and report per lane
//        whether it was kept at any step and its position at the last step.
//
// Which kernel serves which mode:
//   QK6 (quantile by)        quantile_chunk_kernel + quantile_finish_kernel
//                            (C entry m3_query_quantile), a selection;
//   QK7, k <= kKMax          topk_chunk_kernel + topk_merge_kernel
//                            (m3_query_topk), a selection;
//   QK7, k > kKMax           select_kernel (m3_query_select), a sort;
//   QK11                     quantile_window_kernel + quantile_long_kernel;
//   GK2                      graphite_percentile_{columns,finish,rows}_kernel.
//
// The reference sorts the whole [L, S] matrix per step by (group, key) in
// one lax.sort (stable: equal keys keep lane order; -0.0 equals +0.0 and
// NaN keys sort last) and finds each group's run from segment counts.
// Here the host hands in a stable CSR of each group's lanes (ascending
// lane order).  Keys: quantile orders v with NaN -> +inf; topk sorts -v with
// NaN -> -inf before the negation (so NaN lanes come last, still selectable
// once the real values run out); bottomk sorts v with NaN -> +inf.  The
// order key maps -0.0 to +0.0, as the reference's comparator compares them.
// A lane's member position breaks ties: positions are distinct and ascend
// with the lane, so (order key, position) is a total order and the same as
// the reference's stable one.
//
// QK7 for k <= kKMax is a selection (topk_chunk_kernel, topk_merge_kernel
// below): no sort of the group.  The host's chunk table (the one QK4 takes,
// ops/query_grouped.py:chunk_plan) cuts each group into chunks of at most
// CHUNK (256) members, and one warp takes a (chunk, tile of 32 steps): lane w on
// step w, coalesced 256-byte row loads, each lane keeping the k least
// (key, position) pairs of its step sorted in shared memory.  Positions
// ascend along the sweep, so a cell enters only with a key strictly below
// the list's k-th, and after the first rows most cells fail that one
// compare.  A group of one chunk then has its k best and sweeps its rows
// again: a cell is kept exactly when its (key, position) is not after the
// k-th pair, so the write needs no scatter and no sort, and `present` comes
// from a warp ballot (every writer stores the same 1).  The chunks of a
// group of several write their lists to a scratch; topk_merge_kernel, one
// thread per (group, step), merges them in ascending chunk order (reading a
// list only while its entries beat the running k-th; the order is total, so
// the result does not depend on the merge order) and writes the k-th pair;
// a last chunk pass writes the cells against it.  Ranks: whoever holds a
// group's final list at the last step writes each kept lane's position
// (the caller fills 2^62 first).  Bytes: about two reads of [L, S] and one
// write.
//
// QK7 for k > kKMax: one block owns one (group, step) at a time
// (select_kernel), taking them in turn: it loads the group's cells of that
// step, builds (order key, member position) pairs and sorts them ascending
// with a bitonic network.  A group whose padded size P is at most p_smem
// pairs (the caller's shared-memory limit,
// ops/query_grouped.py:SELECT_SMEM_MAX_P) sorts in dynamic shared memory; a
// larger one sorts in the block's slice of a global scratch buffer, so
// groups have no size limit.  It then writes every member's cell of the
// step (kept or NaN), sets present[lane] = 1 for kept lanes, and at the last
// step writes each member's rank: its position if kept, else 2^62.
//
// QK6 is described with its kernels below.
//
// What bounds it on an H100: bytes for the selections and for small groups
// (each cell read once, or a few times by the selections; QK7 writes each
// cell once); for the sorts of large groups, operations (the network's
// P log2(P)^2 / 4 compare-exchanges per (group, step)).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr long long kNoRank = 1LL << 62;
constexpr unsigned kFull = 0xffffffffu;

enum Mode : int { kTopk = 1, kBottomk = 2 };  // QK7's (ops/query_grouped.py:SELECT_*)

// Unsigned key whose order is the float order with -0.0 == +0.0 and every
// NaN after +inf (the padding key ~0 is above all of them).
__device__ __forceinline__ unsigned long long order_key(double v) {
  if (isnan(v)) v = NAN;
  if (v == 0.0) v = 0.0;
  const unsigned long long b = (unsigned long long)__double_as_longlong(v);
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}

constexpr unsigned long long kZeroKey = 0x8000000000000000ull;  // order_key(+-0.0)

__device__ __forceinline__ double key_value(unsigned long long key) {  // order_key's inverse
  const unsigned long long b = (key >> 63) ? (key & ~kZeroKey) : ~key;
  return __longlong_as_double((long long)b);
}

__device__ __forceinline__ double sort_value(double v, int mode) {
  if (mode == kTopk) return -(isnan(v) ? -INFINITY : v);
  return isnan(v) ? INFINITY : v;
}

// One stage (k, j) of an ascending bitonic sort of P (key, pos) pairs, P a
// power of two: the compare-exchanges of pairs i = first, first + stride, ...
__device__ __forceinline__ void bitonic_stage(unsigned long long* keys, int* pos, int P, int k,
                                              int j, int first, int stride) {
  for (int i = first; i < P; i += stride) {
    const int p = i ^ j;
    if (p > i) {
      const unsigned long long ki = keys[i], kp = keys[p];
      const int ci = pos[i], cp = pos[p];
      const bool gt = ki > kp || (ki == kp && ci > cp);
      if (gt == ((i & k) == 0)) {
        keys[i] = kp;
        keys[p] = ki;
        pos[i] = cp;
        pos[p] = ci;
      }
    }
  }
}

// The whole sort; every thread of the block calls it.
__device__ void bitonic_sort(unsigned long long* keys, int* pos, int P) {
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      bitonic_stage(keys, pos, P, k, j, threadIdx.x, blockDim.x);
      __syncthreads();
    }
  }
}

// The whole sort by one warp; every lane of it calls it (the pairs are the
// warp's own).
__device__ void warp_bitonic_sort(unsigned long long* keys, int* pos, int P) {
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      bitonic_stage(keys, pos, P, k, j, threadIdx.x & 31, 32);
      __syncwarp();
    }
  }
}

__global__ void select_kernel(const double* __restrict__ x, long long S,
                              const long long* __restrict__ members,
                              const long long* __restrict__ offsets, long long n_groups, int mode,
                              long long k, int p_smem, long long p_scratch,
                              unsigned long long* __restrict__ scratch_keys,
                              int* __restrict__ scratch_pos, double* __restrict__ out,
                              int* __restrict__ present, long long* __restrict__ rank) {
  extern __shared__ unsigned long long smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  for (long long item = blockIdx.x; item < n_groups * S; item += gridDim.x) {
    const long long g = item / S, s = item % S;
    const long long off = offsets[g];
    const int size = (int)(offsets[g + 1] - off);
    if (size == 0) continue;  // block-uniform: no thread reaches a barrier below
    int P = 1;
    while (P < size) P <<= 1;
    unsigned long long* keys;
    int* pos;
    if (P <= p_smem) {
      keys = smem;
      pos = (int*)(smem + P);
    } else {
      keys = scratch_keys + (long long)blockIdx.x * p_scratch;
      pos = scratch_pos + (long long)blockIdx.x * p_scratch;
    }
    for (int i = tid; i < P; i += nt) {
      keys[i] = i < size ? order_key(sort_value(x[members[off + i] * S + s], mode)) : ~0ull;
      pos[i] = i;
    }
    __syncthreads();
    bitonic_sort(keys, pos, P);
    for (int i = tid; i < size; i += nt) {
      const long long lane = members[off + pos[i]];
      const bool kept = i < k;
      out[lane * S + s] = kept ? x[lane * S + s] : nan;
      if (kept) present[lane] = 1;
      if (s == S - 1) rank[lane] = kept ? (long long)i : kNoRank;
    }
    __syncthreads();  // the pairs are rewritten by the next item
  }
}

constexpr int kKMax = 32;    // the selection's largest k (ops/query_grouped.py:K_MAX)
constexpr int kSelWarps = 8;
constexpr int kSelBatch = 8;
constexpr int kMergeThreads = 64;
constexpr unsigned long long kNone = ~0ull;  // no entry: after every key
constexpr long long kNoPos = 0x7fffffffffffffffLL;

__device__ __forceinline__ bool before(unsigned long long ka, long long pa,
                                       unsigned long long kb, long long pb) {
  return ka < kb || (ka == kb && pa < pb);
}

// Writes the cells of members [lo, hi) at step s: a cell is kept when its
// (key, position) is not after (tk, tp); present[lane] = 1 where a lane is
// kept at any step of the warp's tile.  Every lane of the warp calls it.
__device__ void write_sweep(const double* __restrict__ x, long long S,
                            const long long* __restrict__ members, long long lo, long long hi,
                            long long s, bool live, int mode, unsigned long long tk, long long tp,
                            double* __restrict__ out, int* __restrict__ present) {
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  const int col = threadIdx.x & 31;
  for (long long base = lo; base < hi; base += 32) {
    const int n = hi - base < 32 ? (int)(hi - base) : 32;
    const long long mine = col < n ? members[base + col] : 0;
    for (int j0 = 0; j0 < n; j0 += kSelBatch) {
      double v[kSelBatch];
      long long lane[kSelBatch];
#pragma unroll
      for (int u = 0; u < kSelBatch; ++u) {
        lane[u] = __shfl_sync(0xffffffffu, mine, j0 + u);
        v[u] = live && j0 + u < n ? x[lane[u] * S + s] : nan;
      }
#pragma unroll
      for (int u = 0; u < kSelBatch; ++u) {
        if (j0 + u < n) {  // warp-uniform
          const bool kept =
              live && !before(tk, tp, order_key(sort_value(v[u], mode)), base + j0 + u);
          if (live) out[lane[u] * S + s] = kept ? v[u] : nan;
          if (__ballot_sync(0xffffffffu, kept) != 0u && col == 0) present[lane[u]] = 1;
        }
      }
    }
  }
}

// chunks i64[5, n_table] as QK4's: rows lo, hi, group, fold index (-1 for a
// group of one chunk), first lane; chunk i < n_partial belongs to a group of
// several.  pass 0 takes the units of chunks [0, n_work): each lane's k least pairs,
// then the write (a group of one chunk) or the list to the scratch
// cand_{keys,pos}[chunk][k][S] (padded with kNone).  pass 1 takes the chunks
// of groups of several and writes their cells against the merged k-th pair
// thr_{keys,pos}[fold][S].
__global__ void __launch_bounds__(kSelWarps * 32) topk_chunk_kernel(
    const double* __restrict__ x, long long S, const long long* __restrict__ members,
    const long long* __restrict__ chunks, long long n_table, long long n_work,
    long long n_partial, long long n_tiles, int mode, int k, int pass,
    unsigned long long* __restrict__ cand_keys, long long* __restrict__ cand_pos,
    const unsigned long long* __restrict__ thr_keys, const long long* __restrict__ thr_pos,
    double* __restrict__ out, int* __restrict__ present, long long* __restrict__ rank) {
  extern __shared__ unsigned long long lists[];  // per warp: keys [k][32], positions [k][32]
  const int warp = threadIdx.x >> 5, col = threadIdx.x & 31;
  const long long unit = (long long)blockIdx.x * kSelWarps + warp;
  if (unit >= n_work * n_tiles) return;  // warp-uniform
  const long long ch = unit / n_tiles;
  const long long s = (unit % n_tiles) * 32 + col;
  const bool live = s < S;
  const long long lo = chunks[ch], hi = chunks[n_table + ch], f = chunks[3 * n_table + ch];
  if (pass == 1) {
    write_sweep(x, S, members, lo, hi, s, live, mode, live ? thr_keys[f * S + s] : kNone,
                live ? thr_pos[f * S + s] : kNoPos, out, present);
    return;
  }
  unsigned long long* lk = lists + (long long)warp * 2 * k * 32 + col;
  long long* lp = (long long*)(lk + k * 32);
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  int held = 0;  // entries of this lane's list, ascending by (key, position)
  for (long long base = lo; base < hi; base += 32) {
    const int n = hi - base < 32 ? (int)(hi - base) : 32;
    const long long mine = col < n ? members[base + col] : 0;
    for (int j0 = 0; j0 < n; j0 += kSelBatch) {
      double v[kSelBatch];
#pragma unroll
      for (int u = 0; u < kSelBatch; ++u) {
        const long long lane = __shfl_sync(0xffffffffu, mine, j0 + u);
        v[u] = live && j0 + u < n ? x[lane * S + s] : nan;
      }
#pragma unroll
      for (int u = 0; u < kSelBatch; ++u) {
        if (!live || j0 + u >= n) continue;
        const unsigned long long key = order_key(sort_value(v[u], mode));
        // a later position never beats an equal key
        if (held == k && key >= lk[(k - 1) * 32]) continue;
        int j = held < k ? held++ : k - 1;
        for (; j > 0 && lk[(j - 1) * 32] > key; --j) {
          lk[j * 32] = lk[(j - 1) * 32];
          lp[j * 32] = lp[(j - 1) * 32];
        }
        lk[j * 32] = key;
        lp[j * 32] = base + j0 + u;
      }
    }
  }
  if (ch < n_partial) {  // warp-uniform
    for (int j = 0; live && j < k; ++j) {
      const long long at = (ch * k + j) * S + s;
      cand_keys[at] = j < held ? lk[j * 32] : kNone;
      cand_pos[at] = j < held ? lp[j * 32] : kNoPos;
    }
    return;
  }
  // a group of one chunk: its list is the group's
  if (live && s == S - 1)
    for (int j = 0; j < held; ++j) rank[members[lp[j * 32]]] = j;
  const unsigned long long tk = held == k ? lk[(k - 1) * 32] : kNone;
  const long long tp = held == k ? lp[(k - 1) * 32] : kNoPos;
  write_sweep(x, S, members, lo, hi, s, live, mode, tk, tp, out, present);
}

// folds i64[3, n_folds]: rows group, first chunk, number of chunks.  One
// thread per (group of several chunks, step) merges its chunks' lists into
// the group's k least pairs, writes the k-th (kNone if the group has fewer
// than k lanes) and, at the last step, the kept lanes' ranks.
__global__ void __launch_bounds__(kMergeThreads) topk_merge_kernel(
    const long long* __restrict__ members, long long S, const long long* __restrict__ folds,
    long long n_folds, int k, const unsigned long long* __restrict__ cand_keys,
    const long long* __restrict__ cand_pos, unsigned long long* __restrict__ thr_keys,
    long long* __restrict__ thr_pos, long long* __restrict__ rank) {
  extern __shared__ unsigned long long mlists[];  // keys [k][threads], positions alike
  const long long i = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
  if (i >= n_folds * S) return;
  const long long f = i / S, s = i % S;
  const long long first = folds[n_folds + f], end = first + folds[2 * n_folds + f];
  unsigned long long* lk = mlists + threadIdx.x;
  long long* lp = (long long*)(mlists + k * kMergeThreads) + threadIdx.x;
  int held = 0;
  for (long long c0 = first; c0 < end; c0 += kSelBatch) {
    unsigned long long hk[kSelBatch];
    long long hp[kSelBatch];
#pragma unroll
    for (int u = 0; u < kSelBatch; ++u) {  // the lists' heads, loaded ahead
      const bool in = c0 + u < end;
      hk[u] = in ? cand_keys[(c0 + u) * k * S + s] : kNone;
      hp[u] = in ? cand_pos[(c0 + u) * k * S + s] : kNoPos;
    }
#pragma unroll
    for (int u = 0; u < kSelBatch; ++u) {
      for (int e = 0; e < k; ++e) {
        const long long at = ((c0 + u) * k + e) * S + s;
        const unsigned long long key = e == 0 ? hk[u] : cand_keys[at];
        const long long pos = e == 0 ? hp[u] : cand_pos[at];
        // the list ran out, or its entries are all after the k-th from here
        if (key == kNone ||
            (held == k && !before(key, pos, lk[(k - 1) * kMergeThreads],
                                  lp[(k - 1) * kMergeThreads])))
          break;
        int j = held < k ? held++ : k - 1;
        for (; j > 0 && before(key, pos, lk[(j - 1) * kMergeThreads],
                               lp[(j - 1) * kMergeThreads]); --j) {
          lk[j * kMergeThreads] = lk[(j - 1) * kMergeThreads];
          lp[j * kMergeThreads] = lp[(j - 1) * kMergeThreads];
        }
        lk[j * kMergeThreads] = key;
        lp[j * kMergeThreads] = pos;
      }
    }
  }
  thr_keys[f * S + s] = held == k ? lk[(k - 1) * kMergeThreads] : kNone;
  thr_pos[f * S + s] = held == k ? lp[(k - 1) * kMergeThreads] : kNoPos;
  if (s == S - 1)
    for (int j = 0; j < held; ++j) rank[members[lp[j * kMergeThreads]]] = j;
}

// QK6 (quantile by) is a selection of each (group, step)'s two order
// statistics, an MSB-first radix select over the 64-bit order key: no sort.
// It reads x through the chunk table as QK7 does (one warp per (chunk, tile
// of 32 steps), lane w on step w, coalesced 256-byte row loads).  A group's
// ranks are low = floor(h) and high = ceil(h), h = phi * (n - 1), over its
// n present cells: a NaN cell never holds a rank below n (it ties with +inf
// at worst and then reads as +inf), so only present cells are counted and
// ranked.  A step's selection moves through these states:
//   count    n and the least and greatest key (ranks 0 and n - 1 are then
//            known: phi 0 and 1, and a step whose cells are all equal, end
//            here);
//   radix    count the next kGqDigit-bit digit of (key - lo_k) >> shift over
//            the candidates, the keys in [lo_k, hi_k], and take their least
//            and greatest key; the bucket holding low, cut to those two,
//            becomes the candidates (candidates all of one key, or shift 0:
//            that key is the answer, so long runs of ties end early);
//   listing  gather the candidates' keys (at most the list's capacity) and
//            rank them;
//   split    low is the greatest key of one bucket and high the least of the
//            next non-empty one: a max and a min over the candidates.
// The first digit starts below the bits that the least and the greatest key
// share, so values of one magnitude do not spend passes on their common
// exponent.  The result is v_lo + (v_hi - v_lo) * frac, in the reference's
// order of operations (the file is built with --fmad=false), with v_lo and
// v_hi the values of the two keys.  Equal keys hold equal values but for the
// zero key (+0.0 and -0.0), whose lane order the reference's stable sort
// keeps; it is read as +0.0 all the same, because no zero's sign reaches the
// result: with v_lo a zero, v_hi >= v_lo makes (v_hi - v_lo) * frac +0.0 or
// of v_hi's sign, and -0.0 + +0.0 is +0.0; with only v_hi a zero, v_hi -
// v_lo is positive either way.  So no rank is traced to its lane.
//
// A group of one chunk (at most CHUNK lanes, empty groups too) is settled by
// its warp in the first launch: it re-reads its rows (which stay in L1/L2)
// once per state, with each lane's digit counts in its own column of the
// warp's shared histogram and its list (at most kGqRegs keys) in registers.
// The chunks of a group of several ("a fold") share a global state per
// (fold, step) (GqScratch): each launch is one pass, every chunk of the fold
// adds its counts with integer atomics (exact, so the result does not depend
// on their order), and the warp of the (fold, tile) that arrives last
// updates the tile's states.  The count pass
// also records which chunk tiles hold any present cell (later passes skip
// the rest: padding lanes cost one read).  quantile_finish_kernel, a warp per
// (fold, step), ranks a listed step's candidates and writes the result.  A
// launch whose previous launch left no step to read returns at once.
//
// Grid: a warp per (chunk, tile) in the first launch, per (chunk of a fold,
// tile) after it, a warp per (fold, step) in the finish: sized by the work.
// What bounds it on an H100: bytes (each cell read once by the count pass;
// the radix, listing and split passes read the chunk tiles that hold present
// cells of steps still selecting, from L2 where they fit).

constexpr int kGqDigit = 6;      // key bits a radix pass resolves
constexpr int kGqBuckets = 1 << kGqDigit;
constexpr int kGqWarps = 8;      // warps a block
constexpr int kGqMinBlocks = 4;  // blocks an SM holds (caps the registers)
constexpr int kGqBatch = 8;      // rows loaded ahead
constexpr int kGqList = 32;      // a fold's listed candidates (the finish's warp ranks them)
constexpr int kGqPer = kGqList / 32;          // listed candidates a lane of the finish holds
static_assert(kGqList % 32 == 0 && kGqList >= 32, "a whole number of keys a lane");
constexpr int kGqRegs = 8;                    // a one-chunk group's listed candidates (registers)
// Launches of the chunk kernel: the count pass, then radix passes at shifts
// of at most 58, 52, ..., 4 and one at 0, or a listing or split pass after
// one of the first ten: at most 11 more.
constexpr int kGqLaunches = 12;

// count, radix, listing and split read x; listed and done do not.
enum GqMode : int { kGqCount = 0, kGqRadix = 1, kGqListing = 2, kGqSplit = 3, kGqListed = 4,
                    kGqDone = 5 };

// A step's selection state (zero: count).
struct GqStep {
  unsigned long long lo_k, hi_k;      // the candidates' keys (split: low's bucket)
  unsigned long long lo2, hi2;        // split: high's bucket
  unsigned long long key_lo, key_hi;  // done: the keys at ranks low and high
  long long r;                        // low's rank among the candidates
  long long n;                        // present cells
  int mode, shift, d, pad;            // d = high - low
};

struct GqScratch {
  GqStep* steps;               // [F, S]
  unsigned* hist;              // [F, kGqBuckets, S] digit counts (a warp's steps side by side)
  unsigned* arrivals;          // [F, n_tiles] warps of a (fold, tile) done with a pass
  unsigned* active;            // [kGqLaunches] (fold, tile)s left selecting after each launch
  unsigned* cnt;               // [F, S] the count pass's n, then the listed candidates
  unsigned long long* kmax;    // [F, S] the greatest key (count, radix); split: low's
  unsigned long long* kmin_c;  // [F, S] ~ the least key (count, radix); split: ~ high's
  unsigned long long* list;    // [F, S, kGqList]
  unsigned* live;              // [n_partial, n_tiles] steps of a chunk tile with a present cell
};

// Calls f(v) on the cell of each row of CSR positions [lo, hi) at step s, in
// lane order (NaN where !live); members null: row = position.  Every lane of
// the warp calls it.
template <class F>
__device__ __forceinline__ void gq_rows(const double* __restrict__ x, long long S,
                                        const long long* __restrict__ members, long long lo,
                                        long long hi, long long s, bool live, F&& f) {
  const int col = threadIdx.x & 31;
  for (long long base = lo; base < hi; base += 32) {
    const int n = hi - base < 32 ? (int)(hi - base) : 32;
    const long long mine = col < n ? (members ? members[base + col] : base + col) : 0;
    for (int j0 = 0; j0 < n; j0 += kGqBatch) {
      double v[kGqBatch];
#pragma unroll
      for (int u = 0; u < kGqBatch; ++u) {
        const long long row = __shfl_sync(kFull, mine, (j0 + u) & 31);
        v[u] = live && j0 + u < n ? x[row * S + s] : NAN;
      }
#pragma unroll
      for (int u = 0; u < kGqBatch; ++u)
        if (j0 + u < n) f(v[u]);
    }
  }
}

__device__ __forceinline__ int gq_shift(unsigned long long span) {
  const int bits = 64 - __clzll((long long)span);
  return bits > kGqDigit ? bits - kGqDigit : 0;
}

__device__ __forceinline__ double gq_interpolate(double v_lo, double v_hi, double phi, long long n) {
  const double h = phi * ((double)n - 1.0);
  const double frac = h - floor(h);
  return v_lo + (v_hi - v_lo) * frac;
}

// The state after the count pass: n present cells, least key mn, greatest mx.
__device__ void gq_start(GqStep& st, long long n, unsigned long long mn, unsigned long long mx,
                         double phi, int cap) {
  st.n = n;
  st.mode = kGqDone;
  if (n == 0) return;
  const double h = phi * ((double)n - 1.0);
  const double lo = floor(h);
  st.r = (long long)lo;
  st.d = (int)(ceil(h) - lo);
  const long long top = n - 1, r2 = st.r + st.d;
  if (mn == mx || ((st.r == 0 || st.r == top) && (r2 == 0 || r2 == top))) {
    st.key_lo = st.r == 0 ? mn : mx;  // ranks 0 and n - 1 (all one key: mn == mx)
    st.key_hi = r2 == 0 ? mn : mx;
    return;
  }
  st.lo_k = mn;
  st.hi_k = mx;
  st.shift = gq_shift(mx - mn);
  st.mode = n <= cap ? kGqListing : kGqRadix;
}

// The state after a radix pass; count(b) gives bucket b's candidates.
template <class Count>
__device__ void gq_radix_step(GqStep& st, Count count, int cap) {
  long long before = 0, cb = count(0);
  int b = 0;
  while (b < kGqBuckets - 1 && st.r >= before + cb) {
    before += cb;
    cb = count(++b);
  }
  const unsigned long long width = (1ull << st.shift) - 1ull;  // shift <= 58
  const unsigned long long base = st.lo_k + ((unsigned long long)b << st.shift);
  const unsigned long long top = st.hi_k - base < width ? st.hi_k : base + width;
  if (st.r + st.d < before + cb) {  // both ranks in bucket b
    st.r -= before;
    st.lo_k = base;
    st.hi_k = top;
    if (st.shift == 0) {
      st.mode = kGqDone;
      st.key_lo = st.key_hi = base;
    } else if (cb <= cap) {
      st.mode = kGqListing;
    } else {
      st.shift = gq_shift(top - base);
    }
    return;
  }
  // low is the last candidate of bucket b, high the first of the next non-empty one
  int nb = b + 1;
  while (nb < kGqBuckets - 1 && count(nb) == 0) ++nb;
  const unsigned long long base2 = st.lo_k + ((unsigned long long)nb << st.shift);
  const unsigned long long top2 = st.hi_k - base2 < width ? st.hi_k : base2 + width;
  if (st.shift == 0) {
    st.mode = kGqDone;
    st.key_lo = base;
    st.key_hi = base2;
    return;
  }
  st.mode = kGqSplit;
  st.lo_k = base;
  st.hi_k = top;
  st.lo2 = base2;
  st.hi2 = top2;
}

// The state after a radix pass whose candidates' keys ran from cmin to cmax.
template <class Count>
__device__ void gq_radix_done(GqStep& st, Count count, unsigned long long cmin,
                              unsigned long long cmax, int cap) {
  if (cmin == cmax) {
    st.mode = kGqDone;
    st.key_lo = st.key_hi = cmin;
    return;
  }
  gq_radix_step(st, count, cap);
  if (st.mode == kGqRadix || st.mode == kGqListing) {  // bucket b's candidates lie in both
    st.lo_k = st.lo_k > cmin ? st.lo_k : cmin;
    st.hi_k = st.hi_k < cmax ? st.hi_k : cmax;
    st.shift = gq_shift(st.hi_k - st.lo_k);
  }
}

__device__ __forceinline__ bool gq_in(unsigned long long key, unsigned long long lo,
                                      unsigned long long hi) {
  return key >= lo && key <= hi;
}

// One cell v of a pass in `mode` over a step in state st (every mode that
// reads x): count takes n and the extremes; radix counts the digit in the
// lane's column of h and takes the candidates' extremes; listing hands each
// candidate's key to list; split takes low's bucket's greatest key into mx
// and high's least into mn.
template <class List>
__device__ __forceinline__ void gq_cell(const GqStep& st, int mode, double v,
                                        unsigned short* __restrict__ h, int col, long long& n,
                                        unsigned long long& mn, unsigned long long& mx,
                                        List&& list) {
  if (isnan(v)) return;
  const unsigned long long key = order_key(v);
  if (mode == kGqCount) {
    ++n;
    mn = key < mn ? key : mn;
    mx = key > mx ? key : mx;
  } else if (mode == kGqRadix) {
    if (gq_in(key, st.lo_k, st.hi_k)) {
      ++h[((key - st.lo_k) >> st.shift) * 32 + col];
      mn = key < mn ? key : mn;
      mx = key > mx ? key : mx;
    }
  } else if (mode == kGqListing) {
    if (gq_in(key, st.lo_k, st.hi_k)) list(key);
  } else if (gq_in(key, st.lo_k, st.hi_k)) {  // split
    mx = key > mx ? key : mx;
  } else if (gq_in(key, st.lo2, st.hi2)) {
    mn = key < mn ? key : mn;
  }
}

// A group of one chunk, rows [lo, hi): the whole selection of each lane's
// step, then out[g, s].  Every lane of the warp calls it.
__device__ void gq_one_chunk(const double* __restrict__ x, long long S,
                             const long long* __restrict__ members, long long lo, long long hi,
                             long long g, long long s, bool live, double phi,
                             unsigned short* __restrict__ h, double* __restrict__ out) {
  const int col = threadIdx.x & 31;
  GqStep st{};  // count
  bool zeroed = false;
  while (__any_sync(kFull, st.mode < kGqListed)) {
    const int mode = st.mode;
    if (mode == kGqRadix && !zeroed) {  // the lane's own column: no other lane touches it
      for (int b = 0; b < kGqBuckets; ++b) h[b * 32 + col] = 0;
      zeroed = true;
    }
    unsigned long long lst[kGqRegs];  // ascending; kNone past the listed keys
#pragma unroll
    for (int j = 0; j < kGqRegs; ++j) lst[j] = kNone;
    long long n = 0;
    unsigned long long mn = ~0ull, mx = 0;
    gq_rows(x, S, members, lo, hi, s, live && mode < kGqListed, [&](double v) {
      gq_cell(st, mode, v, h, col, n, mn, mx, [&](unsigned long long key) {
#pragma unroll
        for (int j = 0; j < kGqRegs; ++j) {
          const unsigned long long a = lst[j];
          lst[j] = key < a ? key : a;
          key = key < a ? a : key;
        }
      });
    });
    if (mode == kGqCount) {
      gq_start(st, n, mn, mx, phi, kGqRegs);
    } else if (mode == kGqRadix) {
      gq_radix_done(st, [&](int b) { return (long long)h[b * 32 + col]; }, mn, mx, kGqRegs);
      for (int b = 0; b < kGqBuckets; ++b) h[b * 32 + col] = 0;
    } else if (mode == kGqListing) {
#pragma unroll
      for (int j = 0; j < kGqRegs; ++j) {
        if (j == st.r) st.key_lo = lst[j];
        if (j == st.r + st.d) st.key_hi = lst[j];
      }
      st.mode = kGqDone;
    } else if (mode == kGqSplit) {
      st.key_lo = mx;
      st.key_hi = mn;
      st.mode = kGqDone;
    }
  }
  if (live)
    out[g * S + s] = st.n > 0 ? gq_interpolate(key_value(st.key_lo), key_value(st.key_hi), phi,
                                                st.n)
                              : NAN;
}

// One pass of a fold's chunk ch (rows [lo, hi)) over a tile; the warp of
// the (fold, tile) that arrives last updates the tile's states.  Every lane
// of the warp calls it.
__device__ void gq_fold_pass(const double* __restrict__ x, long long S,
                             const long long* __restrict__ members, long long lo, long long hi,
                             long long ch, long long f, long long tile, long long n_tiles,
                             const long long* __restrict__ folds, long long n_folds, double phi,
                             int pass, unsigned short* __restrict__ h, const GqScratch& sc) {
  const int col = threadIdx.x & 31;
  const long long s = tile * 32 + col;
  const bool live = s < S;
  const long long fs = f * S + s;
  GqStep st{};
  st.mode = kGqDone;
  if (live) st = sc.steps[fs];
  const int mode = st.mode;
  const bool reads = mode < kGqListed;
  if (!__any_sync(kFull, reads)) return;  // the fold's warps of this tile agree: none arrives
  if (mode == kGqRadix)
    for (int b = 0; b < kGqBuckets; ++b) h[b * 32 + col] = 0;
  long long n = 0;
  unsigned long long mx = 0, mn = ~0ull;  // count, radix: the extremes; split: low's max, high's min
  if (pass == 0 || sc.live[ch * n_tiles + tile] != 0) {
    gq_rows(x, S, members, lo, hi, s, live && reads, [&](double v) {
      gq_cell(st, mode, v, h, col, n, mn, mx, [&](unsigned long long key) {
        const unsigned at = atomicAdd(&sc.cnt[fs], 1u);
        if (at < (unsigned)kGqList) sc.list[fs * kGqList + at] = key;
      });
    });
  }
  if (live) {  // this chunk's share
    if (mode == kGqCount && n) {
      atomicAdd(&sc.cnt[fs], (unsigned)n);
      atomicMax(&sc.kmax[fs], mx);
      atomicMax(&sc.kmin_c[fs], ~mn);
    } else if (mode == kGqRadix || mode == kGqSplit) {
      if (mode == kGqRadix)
        for (int b = 0; b < kGqBuckets; ++b) {
          const unsigned c = h[b * 32 + col];
          if (c) atomicAdd(&sc.hist[(f * kGqBuckets + b) * S + s], c);
        }
      if (mx != 0) atomicMax(&sc.kmax[fs], mx);  // a present cell's key is never 0
      if (mn != ~0ull) atomicMax(&sc.kmin_c[fs], ~mn);
    }
  }
  if (pass == 0) {
    const unsigned any = __ballot_sync(kFull, n > 0);
    if (col == 0) sc.live[ch * n_tiles + tile] = any;
  }
  __syncwarp();
  __threadfence();
  int last = 0;
  if (col == 0)
    last = atomicAdd(&sc.arrivals[f * n_tiles + tile], 1u) ==
           (unsigned)(folds[2 * n_folds + f] - 1);
  if (!__shfl_sync(kFull, last, 0)) return;
  __threadfence();
  if (col == 0) sc.arrivals[f * n_tiles + tile] = 0;
  if (live && reads) {
    if (mode == kGqCount) {
      const long long n_all = __ldcg(&sc.cnt[fs]);
      const unsigned long long kx = __ldcg(&sc.kmax[fs]), kn = ~__ldcg(&sc.kmin_c[fs]);
      sc.cnt[fs] = 0;
      sc.kmax[fs] = 0;
      sc.kmin_c[fs] = 0;
      gq_start(st, n_all, kn, kx, phi, kGqList);
    } else if (mode == kGqRadix) {
      unsigned* g = sc.hist + f * kGqBuckets * S + s;
      unsigned c[kGqBuckets];  // loaded together, not one dependent load a bucket
#pragma unroll
      for (int b = 0; b < kGqBuckets; ++b) c[b] = __ldcg(g + b * S);
      const unsigned long long kx = __ldcg(&sc.kmax[fs]), kn = ~__ldcg(&sc.kmin_c[fs]);
      sc.kmax[fs] = 0;
      sc.kmin_c[fs] = 0;
      gq_radix_done(st, [&](int b) { return (long long)c[b]; }, kn, kx, kGqList);
      for (int b = 0; b < kGqBuckets; ++b) g[b * S] = 0;
    } else if (mode == kGqListing) {
      st.mode = kGqListed;
    } else {  // split
      st.key_lo = __ldcg(&sc.kmax[fs]);
      st.key_hi = ~__ldcg(&sc.kmin_c[fs]);
      st.mode = kGqDone;
    }
    sc.steps[fs] = st;
  }
  if (__any_sync(kFull, live && st.mode < kGqListed) && col == 0) atomicAdd(&sc.active[pass], 1u);
}

// chunks i64[5, n_table] and folds i64[3, n_folds] as QK7's; the warps take
// the (chunk, tile) units of chunks [0, n_work).  Launch `pass` 0 settles
// every group of one chunk and counts the folds; later launches are the
// folds' passes.
__global__ void __launch_bounds__(kGqWarps * 32, kGqMinBlocks) quantile_chunk_kernel(
    const double* __restrict__ x, long long S, const long long* __restrict__ members,
    const long long* __restrict__ chunks, long long n_table, long long n_work, long long n_tiles,
    const long long* __restrict__ folds, long long n_folds, double phi, int pass, GqScratch sc,
    double* __restrict__ out) {
  __shared__ unsigned short hist[kGqWarps][kGqBuckets * 32];  // [bucket][lane] per warp
  if (pass > 0 && __ldcg(&sc.active[pass - 1]) == 0) return;   // nothing left to select
  const int warp = threadIdx.x >> 5, col = threadIdx.x & 31;
  const long long unit = (long long)blockIdx.x * kGqWarps + warp;
  if (unit >= n_work * n_tiles) return;  // warp-uniform
  const long long ch = unit / n_tiles, tile = unit % n_tiles;
  const long long lo = chunks[ch], hi = chunks[n_table + ch], f = chunks[3 * n_table + ch];
  if (f < 0) {
    const long long s = tile * 32 + col;
    gq_one_chunk(x, S, members, lo, hi, chunks[2 * n_table + ch], s, s < S, phi, hist[warp], out);
    return;
  }
  gq_fold_pass(x, S, members, lo, hi, ch, f, tile, n_tiles, folds, n_folds, phi, pass, hist[warp],
               sc);
}

// Each fold's steps from their states, a warp per (fold, step): a listed
// step's candidates ranked first (one a lane), then out[g, s].
__global__ void __launch_bounds__(kGqWarps * 32) quantile_finish_kernel(
    long long S, const long long* __restrict__ folds, long long n_folds, double phi,
    GqScratch sc, double* __restrict__ out) {
  const int col = threadIdx.x & 31;
  const long long fs = (long long)blockIdx.x * kGqWarps + (threadIdx.x >> 5);
  if (fs >= n_folds * S) return;  // warp-uniform
  const long long f = fs / S, s = fs % S;
  GqStep st = sc.steps[fs];
  if (st.mode == kGqListed) {
    const unsigned m = sc.cnt[fs];
    unsigned long long key[kGqPer];  // entry q * 32 + col
    int rank[kGqPer];                // among the listed keys, ties by entry
#pragma unroll
    for (int q = 0; q < kGqPer; ++q) {
      key[q] = (unsigned)(q * 32 + col) < m ? sc.list[fs * kGqList + q * 32 + col] : kNone;
      rank[q] = 0;
    }
    for (int j = 0; j < 32; ++j) {
#pragma unroll
      for (int p = 0; p < kGqPer; ++p) {
        const unsigned long long kj = __shfl_sync(kFull, key[p], j);
#pragma unroll
        for (int q = 0; q < kGqPer; ++q)
          rank[q] += kj < key[q] || (kj == key[q] && p * 32 + j < q * 32 + col);
      }
    }
#pragma unroll
    for (int q = 0; q < kGqPer; ++q) {
      const unsigned at_lo = __ballot_sync(kFull, rank[q] == st.r);
      const unsigned at_hi = __ballot_sync(kFull, rank[q] == st.r + st.d);
      const unsigned long long klo = __shfl_sync(kFull, key[q], at_lo ? __ffs(at_lo) - 1 : 0);
      const unsigned long long khi = __shfl_sync(kFull, key[q], at_hi ? __ffs(at_hi) - 1 : 0);
      if (at_lo) st.key_lo = klo;
      if (at_hi) st.key_hi = khi;
    }
  }
  if (col == 0)
    out[folds[f] * S + s] = st.n > 0 ? gq_interpolate(key_value(st.key_lo), key_value(st.key_hi),
                                                      phi, st.n)
                                     : NAN;
}

// QK6's scratch carved from `base` (null: sizes only); returns its bytes,
// and in *zeroed the bytes of its head that start at zero.
long long gq_layout(long long F, long long n_partial, long long S, void* base, GqScratch* sc,
                    long long* zeroed) {
  const long long n_tiles = (S + 31) / 32;
  char* p = (char*)base;
  long long at = 0;
  auto take = [&](long long bytes) {
    void* q = p ? p + at : nullptr;
    at += (bytes + 15) / 16 * 16;
    return q;
  };
  sc->steps = (GqStep*)take(F * S * (long long)sizeof(GqStep));
  sc->hist = (unsigned*)take(F * kGqBuckets * S * 4LL);
  sc->arrivals = (unsigned*)take(F * n_tiles * 4LL);
  sc->active = (unsigned*)take(kGqLaunches * 4LL);
  sc->cnt = (unsigned*)take(F * S * 4LL);
  sc->kmax = (unsigned long long*)take(F * S * 8LL);
  sc->kmin_c = (unsigned long long*)take(F * S * 8LL);
  *zeroed = at;
  sc->list = (unsigned long long*)take(F * S * kGqList * 8LL);
  sc->live = (unsigned*)take(n_partial * n_tiles * 4LL);
  return at;
}

// jnp.searchsorted(t, q, side="right") as JAX computes it: a fixed number
// of bisection levels, returning `high` (csrc/query_temporal.cu's).
__device__ __forceinline__ long long search_right(const long long* t, long long n, int levels,
                                                  long long q) {
  long long low = 0, high = n;
  for (int k = 0; k < levels; ++k) {
    const long long mid = (long long)(((unsigned long long)low + (unsigned long long)high) >> 1);
    if (q < t[mid]) high = mid; else low = mid;
  }
  return high;
}

// search_right of qa and qb at once: the two bisections' loads in flight
// together.
__device__ __forceinline__ void search_right2(const long long* t, long long n, int levels,
                                              long long qa, long long qb, long long& ra,
                                              long long& rb) {
  long long la = 0, ha = n, lb = 0, hb = n;
  for (int k = 0; k < levels; ++k) {
    const long long ma = (long long)(((unsigned long long)la + (unsigned long long)ha) >> 1);
    const long long mb = (long long)(((unsigned long long)lb + (unsigned long long)hb) >> 1);
    const long long ta = t[ma], tb = t[mb];
    if (qa < ta) ha = ma; else la = ma;
    if (qb < tb) hb = mb; else lb = mb;
  }
  ra = ha;
  rb = hb;
}

__device__ __forceinline__ long long wsub(long long a, long long b) {
  return (long long)((unsigned long long)a - (unsigned long long)b);
}

constexpr int kQWarps = 8;          // warps a block of the short-run kernel
constexpr int kQRegion = 256;       // samples of a short run
constexpr int kQLongWarps = 4;      // warps a block of the long-run kernel
constexpr int kQLongRegion = 1024;  // samples of a long run
constexpr int kQStage = 8;          // samples a lane loads ahead while staging

// Shared memory of one warp's run of kRegion samples: its (order key,
// offset) pairs (u64, i32), values (f64), ranks (u16), and each thread's
// kRegion / 32 mask words (word j of lane l at j * 32 + l).
template <int kRegion>
__host__ __device__ constexpr size_t run_bytes() {
  return (size_t)kRegion * 26;
}

// The position of the k-th (from 0) set bit of m, which has more than k.
__device__ __forceinline__ int nth_bit(unsigned m, int k) {
  int p = 0;
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    const int c = __popc(m & ((1u << half) - 1u));
    if (k >= c) {
      k -= c;
      m >>= half;
      p += half;
    }
  }
  return p;
}

// The k-th (from 0) set bit of a thread's mask (its words 32 apart).
__device__ __forceinline__ int kth_rank(const unsigned* mask, int n_words, int k) {
  for (int j = 0; j < n_words; ++j) {
    const unsigned m = mask[j * 32];
    const int c = __popc(m);
    if (k < c) return j * 32 + nth_bit(m, k);
    k -= c;
  }
  return 0;  // not reached: the mask holds more than k bits
}

__device__ __forceinline__ long long warp_min(long long x) {
  for (int o = 16; o > 0; o >>= 1) {
    const long long y = __shfl_xor_sync(0xffffffffu, x, o);
    x = y < x ? y : x;
  }
  return x;
}

__device__ __forceinline__ long long warp_max(long long x) {
  for (int o = 16; o > 0; o >>= 1) {
    const long long y = __shfl_xor_sync(0xffffffffu, x, o);
    x = y > x ? y : x;
  }
  return x;
}

__device__ __forceinline__ double interpolate(double v_lo, double v_hi, double frac) {
  return v_lo + (v_hi - v_lo) * frac;
}

constexpr int kQNarrow = 32;  // samples of a window sorted in a thread's registers

// Batcher's odd-even merge network over kQNarrow elements: its comparators
// in order, comparator `index` as the pair (a, b), a < b, worked out at
// compile time so that every index into the keys is a constant.
struct Comparator {
  int a, b;
};

__host__ __device__ constexpr Comparator batcher_comparator(int index) {
  int c = 0;
  for (int p = 1; p < kQNarrow; p <<= 1)
    for (int d = p; d >= 1; d >>= 1)
      for (int j = d % p; j + d < kQNarrow; j += 2 * d)
        for (int i = 0; i < d && i + j + d < kQNarrow; ++i)
          if ((i + j) / (2 * p) == (i + j + d) / (2 * p) && c++ == index) return {i + j, i + j + d};
  return {0, 0};
}

__host__ __device__ constexpr int batcher_size() {
  int c = 0;
  for (int p = 1; p < kQNarrow; p <<= 1)
    for (int d = p; d >= 1; d >>= 1)
      for (int j = d % p; j + d < kQNarrow; j += 2 * d)
        for (int i = 0; i < d && i + j + d < kQNarrow; ++i)
          c += (i + j) / (2 * p) == (i + j + d) / (2 * p);
  return c;
}

static_assert(batcher_size() == 191, "Batcher's network over 32 elements");

// Comparators I.. of the network on k, ascending.
template <int I>
__device__ __forceinline__ void batcher_sort(unsigned long long (&k)[kQNarrow]) {
  if constexpr (I < batcher_size()) {
    constexpr Comparator c = batcher_comparator(I);
    const unsigned long long a = k[c.a], b = k[c.b];
    k[c.a] = a < b ? a : b;
    k[c.b] = a < b ? b : a;
    batcher_sort<I + 1>(k);
  }
}

// The keys at places a and b (from 0) of the B largest (kTop) or smallest
// present keys of k, by a buffer of B keys that each key passes through: B
// compare-exchanges a key, against the network's 191 for the whole sort.
// Absent and NaN keys (~0) take no place.
template <int B, bool kTop>
__device__ __forceinline__ void end_keys(const unsigned long long (&k)[kQNarrow], int a, int b,
                                         unsigned long long& key_a, unsigned long long& key_b) {
  unsigned long long buf[B];
#pragma unroll
  for (int j = 0; j < B; ++j) buf[j] = kTop ? 0ull : ~0ull;  // below / above every key
#pragma unroll
  for (int u = 0; u < kQNarrow; ++u) {
    unsigned long long x = kTop && k[u] == ~0ull ? 0ull : k[u];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const bool keep = kTop ? buf[j] >= x : buf[j] <= x;
      const unsigned long long y = keep ? buf[j] : x;
      x = keep ? x : buf[j];
      buf[j] = y;
    }
  }
#pragma unroll
  for (int j = 0; j < B; ++j) {
    if (j == a) key_a = buf[j];
    if (j == b) key_b = buf[j];
  }
}

// The quantile of one window of w <= kQNarrow samples wv[0, w), by one
// thread: the order keys in registers, the floor(h)-th and ceil(h)-th found
// by a buffer of the window's few largest or smallest keys when they sit
// within 4 of an end (phi >= 0.9 or <= 0.1 for 30 samples), else by
// sorting them with Batcher's odd-even merge network (191 compare-exchanges
// at constant indices, so the keys never leave the registers), and read
// back as values.
// Equal keys are equal values but for +-0.0, so the key order needs no
// offsets (nor the network its inputs in offset order): a zero at rank k is
// the (k - below)-th zero of the window in offset order (`below`: the keys
// under the zero key), with its own sign.
__device__ double narrow_quantile(const double* wv, int w, double phi) {
  unsigned long long k[kQNarrow];
  int n = 0, below = 0;
  // the network takes its inputs in any order: lane l starts at offset l
  // (mod w), so the lanes' reads fall in different banks
  const int rot = w > 0 ? (threadIdx.x & 31) % w : 0;
#pragma unroll
  for (int u = 0; u < kQNarrow; ++u) {
    unsigned long long key = ~0ull;
    if (u < w) {
      const double x = wv[u + rot < w ? u + rot : u + rot - w];
      if (!isnan(x)) {
        key = order_key(x);
        ++n;
        below += key < kZeroKey;
      }
    }
    k[u] = key;
  }
  if (n == 0) return __longlong_as_double(0x7ff8000000000000LL);
  const double h = phi * ((double)n - 1.0 > 0.0 ? (double)n - 1.0 : 0.0);
  const double fl = floor(h);
  const int i_lo = (int)fl, i_hi = (int)ceil(h);
  unsigned long long k_lo = 0, k_hi = 0;
  if (n - i_lo <= 2) {  // the ranks sit at an end: no sort, a buffer of that end
    end_keys<2, true>(k, n - 1 - i_lo, n - 1 - i_hi, k_lo, k_hi);
  } else if (i_hi < 2) {
    end_keys<2, false>(k, i_lo, i_hi, k_lo, k_hi);
  } else if (n - i_lo <= 4) {
    end_keys<4, true>(k, n - 1 - i_lo, n - 1 - i_hi, k_lo, k_hi);
  } else if (i_hi < 4) {
    end_keys<4, false>(k, i_lo, i_hi, k_lo, k_hi);
  } else {
    batcher_sort<0>(k);
#pragma unroll
    for (int u = 0; u < kQNarrow; ++u) {
      if (u == i_lo) k_lo = k[u];
      if (u == i_hi) k_hi = k[u];
    }
  }
  double v_lo = key_value(k_lo), v_hi = key_value(k_hi);
  if (k_lo == kZeroKey || k_hi == kZeroKey) {  // the zeros' signs, in offset order
    int z = 0;
    for (int u = 0; u < w; ++u) {
      if (wv[u] == 0.0) {
        if (z == i_lo - below) v_lo = wv[u];
        if (z == i_hi - below) v_hi = wv[u];
        ++z;
      }
    }
  }
  return interpolate(v_lo, v_hi, h - fl);
}

// A tile's run: the samples [lo, lo + n_run) of a lane, n_run <= kRegion,
// that hold the windows of its 32 steps ([left, right) of the run for this
// lane's step).  The warp stages the run's values in `w` (kQStage loads a
// lane in flight).  If every window holds at most kQNarrow samples, each
// live lane sorts its own in registers (narrow_quantile); else the warp
// sorts the run's (order key, offset) pairs once (a bitonic network), and
// each live lane marks the ranks of its window's present samples in a mask
// and reads the floor(h)-th and ceil(h)-th set bits.  Returns the lane's quantile (NaN
// for a window with no present sample).
template <int kRegion>
__device__ double run_quantile(const double* __restrict__ v, long long lo, int n_run, int left,
                               int right, bool live, double phi, char* w) {
  const unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  unsigned long long* keys = (unsigned long long*)w;
  int* pos = (int*)(w + 8 * kRegion);
  double* vals = (double*)(w + 12 * kRegion);
  unsigned short* rank = (unsigned short*)(w + 20 * kRegion);
  for (int b0 = 0; b0 < n_run; b0 += 32 * kQStage) {
    double vv[kQStage];
#pragma unroll
    for (int u = 0; u < kQStage; ++u) {
      const int i = b0 + u * 32 + lane;
      if (i < n_run) vv[u] = v[lo + i];
    }
#pragma unroll
    for (int u = 0; u < kQStage; ++u) {
      const int i = b0 + u * 32 + lane;
      if (i < n_run) vals[i] = vv[u];
    }
  }
  __syncwarp();
  if (__all_sync(kFull, !live || right - left <= kQNarrow)) {  // each window in registers
    const double q = live ? narrow_quantile(vals + left, right - left, phi)
                          : __longlong_as_double(0x7ff8000000000000LL);
    __syncwarp();  // the warp's shared memory is rewritten by its next tile
    return q;
  }
  int P = 32;
  while (P < n_run) P <<= 1;
  int n_real = 0;  // the run's present samples: ranks 0..n_real-1
  for (int i = lane; i < P; i += 32) {
    unsigned long long key = ~0ull;
    if (i < n_run && !isnan(vals[i])) key = order_key(vals[i]);
    keys[i] = key;
    pos[i] = i;
    n_real += __popc(__ballot_sync(kFull, key != ~0ull));
  }
  __syncwarp();
  warp_bitonic_sort(keys, pos, P);
  for (int r = lane; r < n_run; r += 32) rank[pos[r]] = (unsigned short)r;
  __syncwarp();
  double q = __longlong_as_double(0x7ff8000000000000LL);
  if (live) {
    const int n_words = P >> 5;
    unsigned* mask = (unsigned*)(w + 22 * kRegion) + lane;  // word j of this lane at j * 32
    for (int j = 0; j < n_words; ++j) mask[j * 32] = 0u;
    int n = 0;
    for (int i = left; i < right; ++i) {
      const int r = rank[i];
      if (r < n_real) {
        mask[(r >> 5) * 32] |= 1u << (r & 31);
        ++n;
      }
    }
    const double h = phi * ((double)n - 1.0 > 0.0 ? (double)n - 1.0 : 0.0);
    const int r_lo = kth_rank(mask, n_words, (int)floor(h));
    const int r_hi = kth_rank(mask, n_words, (int)ceil(h));
    if (n > 0) q = interpolate(vals[pos[r_lo]], vals[pos[r_hi]], h - floor(h));
  }
  __syncwarp();  // the warp's shared memory is rewritten by its next tile
  return q;
}

// The quantile of one window, samples v[left, left + w), by the whole warp
// (past a long run): (order key, offset) pairs sorted by a bitonic network
// in the warp's shared memory (kQLongRegion pairs) or, past them, in its
// slice of the global scratch; lane 0 returns the interpolation, the
// others NaN.
__device__ double window_sort_quantile(const double* __restrict__ v, long long left,
                                       long long w, double phi, unsigned long long* smem_keys,
                                       int* smem_pos, unsigned long long* scratch_keys,
                                       int* scratch_pos) {
  const int lane = threadIdx.x & 31;
  int P = 1;
  while (P < w) P <<= 1;
  unsigned long long* keys = P <= kQLongRegion ? smem_keys : scratch_keys;
  int* pos = P <= kQLongRegion ? smem_pos : scratch_pos;
  int n = 0;
  for (int i = lane; i < P; i += 32) {
    unsigned long long key = ~0ull;
    if (i < w) {
      const double x = v[left + i];
      if (!isnan(x)) {
        key = order_key(x);
        ++n;
      }
    }
    keys[i] = key;
    pos[i] = i;
  }
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
  __syncwarp();
  warp_bitonic_sort(keys, pos, P);
  double q = __longlong_as_double(0x7ff8000000000000LL);
  if (lane == 0 && n > 0) {
    const double h = phi * ((double)n - 1.0 > 0.0 ? (double)n - 1.0 : 0.0);
    const double lo = floor(h);
    q = interpolate(v[left + pos[(long long)lo]], v[left + pos[(long long)ceil(h)]], h - lo);
  }
  __syncwarp();  // the pairs are rewritten by the next window
  return q;
}

// A (lane, tile of 32 steps) unit: its lane's samples, this thread's step
// and its window [left, right) (the reference's bisections over the lane,
// so lanes need not be sorted), and the run [lo, hi) holding the tile's
// windows.
struct QUnit {
  const double* v;
  long long row, s0, s, left, right, lo, hi;
  bool live;
};

__device__ __forceinline__ QUnit quantile_unit(const long long* __restrict__ times,
                                               const double* __restrict__ values,
                                               const long long* __restrict__ steps,
                                               long long N, int S, int levels,
                                               long long range_nanos, long long unit) {
  const int lane = threadIdx.x & 31;
  const long long n_tiles = (S + 31) / 32;
  QUnit u;
  u.row = unit / n_tiles;
  u.s0 = (unit % n_tiles) * 32;
  u.s = u.s0 + lane;
  u.live = u.s < S;
  const long long* t = times + u.row * N;
  u.v = values + u.row * N;
  u.left = u.right = 0;
  if (u.live) {
    const long long step = steps[u.s];
    search_right2(t, N, levels, wsub(wsub(step, range_nanos), 1), step, u.left, u.right);
    if (u.right < u.left) u.right = u.left;  // an unsorted lane's empty window
  }
  u.lo = warp_min(u.live ? u.left : N);
  u.hi = warp_max(u.live ? u.right : 0);
  return u;
}

// QK11.  Replaces m3_tpu/models/query_pipeline.py:648
// _quantile_window_device: quantile_over_time, the phi-quantile of each
// (lane, step) window's present samples, interpolated at h = phi * max(n -
// 1, 0) as v_lo + (v_hi - v_lo) * frac between the floor(h)-th and
// ceil(h)-th samples in the order of (order key, offset): -0.0 equals +0.0,
// ties go by offset (lax.sort's stable order), NaN and absent samples come
// last, and the value read keeps its own sign of zero; no present sample:
// NaN.  The reference gathers every window into an [L, S, N] grid and sorts
// it (the engine gates the function on that grid's size).
//
// Here one warp takes a (lane, tile of 32 steps), thread w step s0 + w: it
// finds its window by the reference's two bisections over the lane (so an
// unsorted lane gets the reference's windows), and the tile's windows lie
// in one run of the lane's samples, [lo, hi), which the warp stages in
// shared memory once (run_quantile).  A window of at most kQNarrow samples
// (config 4's 5m windows: 30) is done in its thread's registers: a buffer
// of its 2 or 4 largest or smallest keys when the ranks sit that near an
// end, else a fixed sorting network.  A tile with a longer window sorts its
// run's (order key, offset) pairs once instead, which gives every sample
// its rank in the run: ranks are a total order that agrees with each
// window's own, so a thread marks the ranks of its window's present samples
// in a bit mask and reads the floor(h)-th and ceil(h)-th set bits, with no
// sort per window.
// quantile_window_kernel takes the runs of at most kQRegion samples and
// lists the other units; quantile_long_kernel, the second launch, takes
// the listed units with fewer warps and larger buffers: runs of at most
// kQLongRegion samples (1h windows of ~360 samples) alike, and longer ones
// (sparse steps, windows of hours) a window at a time, each sorted by the
// warp in shared memory or, past kQLongRegion pairs, in its slice of a
// global scratch of p_scratch pairs (the padded lane length), so windows
// have no length limit.
//
// What bounds it on an H100: bytes at short windows (each lane read about
// once, one f64 written per (lane, step)) against the end buffers' 2-4 or
// the network's 191 compare-exchanges a window; the sorts' compares per
// run, or per window past a long run.
//
// Three blocks an SM: the launch bounds cap a thread at 85 registers, so the
// narrow windows' keys spill a little, which runs faster than two blocks an
// SM without spills.
__global__ void __launch_bounds__(kQWarps * 32, 3) quantile_window_kernel(
    const long long* __restrict__ times, const double* __restrict__ values,
    const long long* __restrict__ steps, long long L, long long N, int S, int levels,
    long long range_nanos, double phi, long long* __restrict__ listed,
    unsigned long long* __restrict__ n_listed, double* __restrict__ out) {
  extern __shared__ unsigned long long qsmem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  char* w = (char*)qsmem + warp * run_bytes<kQRegion>();
  const long long n_units = L * ((S + 31) / 32);
  for (long long unit = (long long)blockIdx.x * kQWarps + warp; unit < n_units;
       unit += (long long)gridDim.x * kQWarps) {
    const QUnit u = quantile_unit(times, values, steps, N, S, levels, range_nanos, unit);
    const long long n_run = u.hi - u.lo;
    if (n_run <= kQRegion) {
      const double q = run_quantile<kQRegion>(u.v, u.lo, (int)n_run, (int)(u.left - u.lo),
                                              (int)(u.right - u.lo), u.live, phi, w);
      if (u.live) out[u.row * S + u.s] = q;
    } else if (lane == 0) {
      listed[atomicAdd(n_listed, 1ull)] = unit;
    }
  }
}

__global__ void __launch_bounds__(kQLongWarps * 32) quantile_long_kernel(
    const long long* __restrict__ times, const double* __restrict__ values,
    const long long* __restrict__ steps, long long N, int S, int levels, long long range_nanos,
    double phi, const long long* __restrict__ listed,
    const unsigned long long* __restrict__ n_listed, long long p_scratch,
    unsigned long long* __restrict__ scratch_keys, int* __restrict__ scratch_pos,
    double* __restrict__ out) {
  extern __shared__ unsigned long long lsmem[];
  const unsigned kFull = 0xffffffffu;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  char* w = (char*)lsmem + warp * run_bytes<kQLongRegion>();
  const long long gw = (long long)blockIdx.x * kQLongWarps + warp;
  unsigned long long* wkeys = scratch_keys + (p_scratch ? gw * p_scratch : 0);
  int* wpos = scratch_pos + (p_scratch ? gw * p_scratch : 0);
  const long long n = (long long)*n_listed;
  for (long long i = gw; i < n; i += (long long)gridDim.x * kQLongWarps) {
    const QUnit u = quantile_unit(times, values, steps, N, S, levels, range_nanos, listed[i]);
    const long long n_run = u.hi - u.lo;
    if (n_run <= kQLongRegion) {
      const double q = run_quantile<kQLongRegion>(u.v, u.lo, (int)n_run, (int)(u.left - u.lo),
                                                  (int)(u.right - u.lo), u.live, phi, w);
      if (u.live) out[u.row * S + u.s] = q;
      continue;
    }
    for (int k = 0; k < 32 && u.s0 + k < S; ++k) {
      const long long lk = __shfl_sync(kFull, u.left, k), rk = __shfl_sync(kFull, u.right, k);
      const double q = window_sort_quantile(u.v, lk, rk - lk, phi, (unsigned long long*)w,
                                            (int*)(w + 8 * kQLongRegion), wkeys, wpos);
      if (lane == 0) out[u.row * S + u.s0 + k] = q;
    }
  }
}

// GK2.  Replaces jnp.nanpercentile / jnp.nanmedian as
// m3_tpu/models/query_pipeline.py uses them in _graphite_grouped_reduce
// (:1278-1280, medianSeries and percentileOfSeries: over the lanes of each
// step, one group) and in _graphite_call (:1432-1440, nPercentile and
// remove{Above,Below}Percentile: over each lane's real steps), in jnp's own
// arithmetic (jax/_src/numpy/reductions.py:_quantile): h = q * (n - 1) with
// n the present cells, low = floor(h) and high = ceil(h) clamped to
// [0, n - 1], the result lo * (1 - w) + hi * w with w = h - floor(h) (so a
// +-inf neighbour at weight 0 gives NaN, as it does there), NaN where
// nothing is present.  Not QK6's v_lo + (v_hi - v_lo) * frac.
//
// jnp sorts with NaN last and -0.0 equal to +0.0; the values it reads lie
// among the n present ones, in the stable order of order_key (ties by
// lane).  Ranks low and high < n never reach a NaN cell but for one tied
// with a real +inf, which reads as +inf either way, so NaN cells are simply
// left out.
//
// The row form is one warp per lane over its real_S steps (QK11's layout):
// (order key, position) pairs sorted as in QK6, the cells at positions low
// and high read back; then it writes the lane's row: mode 1 the percentile
// on each real step (NaN past them), mode 2 / 3 the cells above / below it
// NaN.
//
// The column form (mode 0) is a selection of the two order statistics of
// each step, an MSB-first radix select over the 64-bit order key: no sort.
// Each pass reads x in coalesced units as QK4 and QK7 do, a warp per (chunk
// of kColChunk lanes, tile of 32 steps), lane w on step w, one 256-byte row
// per load, and a step of the tile does what its state asks:
//   radix    count the next kDigitBits-bit digit of the cells that match the
//            step's prefix: shared-memory integer atomics per block, then
//            global integer atomics (integer sums are exact, so the counts
//            do not depend on the order);
//   compact  append the matching cells' keys to the step's list (few
//            remain: at most kColCap);
//   split    low is the greatest key of one bucket and high the least of the
//            next non-empty one: a max and a min over the matching cells.
// The block of each tile that arrives last then updates the tile's steps
// (column_step): the first pass's counts give n and the ranks; a scan of
// the digit counts picks the bucket holding low (and high = low or low + 1),
// extends the prefix, or switches to compact or split.  After kColPasses
// passes (64 bits) every step is listed or done; the finish kernel sorts a
// listed step's keys in shared memory and reads them at the ranks.  Equal
// keys hold equal values but for the zero key (+0.0 and -0.0): there the
// value is the sign of the (rank within the key's cells)-th zero cell in
// lane order, which the first pass's per-(chunk, step) zero counts and a
// walk of the one chunk holding it settle (column_value).  Then out = lo *
// lw + hi * hw, or (lo + hi) * 0.5 for the median (mode 4: jnp.nanmedian is
// nanquantile's midpoint method), as the plain version
// (ops/graphite.py:nanpercentile_plain) computes it.
//
// What bounds it on an H100: bytes (each cell read once); the column form
// reads [L, S] once per pass until its steps are done (a step's prefix
// usually narrows its candidates to a list within two or three passes;
// ties of more than kColCap equal keys take all eight), and a tile whose
// steps are all listed or done is not read; the row form's sorts' P
// log2(P)^2 / 4 compare-exchanges per lane.

struct PercentilePick {
  long long low, high;
  double lw, hw;
};

__device__ __forceinline__ PercentilePick percentile_pick(double n, double qf) {
  const double h = qf * (n - 1.0);
  double low = floor(h), high = ceil(h);
  const double hw = h - low;
  const double lw = 1.0 - hw;
  const double top = n - 1.0;
  low = low < top ? low : top;
  low = low > 0.0 ? low : 0.0;
  high = high < top ? high : top;
  high = high > 0.0 ? high : 0.0;
  return {(long long)low, (long long)high, lw, hw};
}

__device__ __forceinline__ double present_or_inf(double v) { return isnan(v) ? INFINITY : v; }

constexpr int kColWarps = 8;       // warps per block of the column passes
constexpr int kColChunk = 256;     // lanes a warp sweeps per unit
constexpr int kColRows = 8;        // rows loaded ahead
constexpr int kDigitBits = 8;
constexpr int kBuckets = 1 << kDigitBits;
constexpr int kColPasses = 64 / kDigitBits;
constexpr int kColCap = 2048;      // candidates gathered into a list rather than counted
static_assert(kColWarps * 32 == kBuckets, "a thread per bucket");

// radix, compact and split read x in the next pass; listed and done do not
// (the finish kernel settles a listed step).
enum ColMode : int { kColRadix = 0, kColCompact = 1, kColSplit = 2, kColListed = 3,
                     kColDone = 4 };

// A step's selection state (zero: radix, no digit known yet).
struct ColStep {
  unsigned long long prefix;     // the candidates' top `bits` bits (split: low's)
  unsigned long long prefix_hi;  // split: high's
  unsigned long long key_lo, key_hi;  // done: the keys at ranks low and high
  long long r;                   // low's rank among the candidates
  long long z_lo, z_hi;          // done: each rank among its key's cells (-1: the last)
  long long n;                   // the step's present cells
  int mode, bits, d, pad;        // d = high - low
};

struct ColScratch {
  ColStep* steps;                // [S]
  unsigned* hist;                // [S, kBuckets] digit counts
  unsigned* arrivals;            // [n_tiles] blocks of a tile done with a pass
  unsigned* list_n;              // [S]
  unsigned long long* list;      // [S, kColCap]
  unsigned long long* lo_max;    // [S] split: the greatest key of low's bucket
  unsigned long long* hi_min;    // [S] split: the least key of high's bucket
  unsigned* zeros;               // [n_chunks, S] zero cells per (chunk, step)
};

__device__ __forceinline__ bool prefix_match(unsigned long long key, unsigned long long prefix,
                                             int bits) {
  return bits == 0 || ((key ^ prefix) >> (64 - bits)) == 0;
}

// Updates step s after a pass; one whole warp calls it.
__device__ void column_step(long long s, double qf, const ColScratch& sc) {
  const int lane = threadIdx.x & 31;
  ColStep st = sc.steps[s];
  if (st.mode == kColRadix) {
    unsigned cnt[kBuckets / 32];
    unsigned mine = 0;
    for (int q = 0; q < kBuckets / 32; ++q) {
      cnt[q] = __ldcg(&sc.hist[s * kBuckets + lane * (kBuckets / 32) + q]);
      sc.hist[s * kBuckets + lane * (kBuckets / 32) + q] = 0;  // for the next pass
      mine += cnt[q];
    }
    unsigned incl = mine;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const long long excl = (long long)(incl - mine);
    if (st.bits == 0) {
      st.n = __shfl_sync(kFull, incl, 31);
      if (st.n == 0) {
        st.mode = kColDone;
        if (lane == 0) sc.steps[s] = st;
        return;
      }
      const PercentilePick k = percentile_pick((double)st.n, qf);
      st.r = k.low;
      st.d = (int)(k.high - k.low);
    }
    const int src = __ffs(__ballot_sync(kFull, excl <= st.r && st.r < excl + mine)) - 1;
    int b = 0;
    long long before = excl;
    unsigned cb = 0;
    if (lane == src) {
      for (int q = 0; q < kBuckets / 32; ++q) {
        if (st.r < before + cnt[q]) {
          b = lane * (kBuckets / 32) + q;
          cb = cnt[q];
          break;
        }
        before += cnt[q];
      }
    }
    b = __shfl_sync(kFull, b, src);
    before = __shfl_sync(kFull, before, src);
    cb = __shfl_sync(kFull, cb, src);
    const int shift = 64 - kDigitBits - st.bits;
    if (st.r + st.d < before + cb) {  // both ranks in bucket b
      st.prefix |= (unsigned long long)b << shift;
      st.bits += kDigitBits;
      st.r -= before;
      if (st.bits == 64) {
        st.mode = kColDone;
        st.key_lo = st.key_hi = st.prefix;
        st.z_lo = st.r;
        st.z_hi = st.r + st.d;
      } else if (cb <= kColCap) {
        st.mode = kColCompact;
        if (lane == 0) sc.list_n[s] = 0;
      }
    } else {  // low is the last of bucket b, high the first of the next non-empty one
      int nb = kBuckets;
      for (int q = kBuckets / 32 - 1; q >= 0; --q)
        if (lane * (kBuckets / 32) + q > b && cnt[q] > 0) nb = lane * (kBuckets / 32) + q;
      for (int o = 16; o > 0; o >>= 1) nb = min(nb, __shfl_xor_sync(kFull, nb, o));
      const unsigned long long lo = st.prefix | (unsigned long long)b << shift;
      const unsigned long long hi = st.prefix | (unsigned long long)nb << shift;
      st.bits += kDigitBits;
      if (st.bits == 64) {
        st.mode = kColDone;
        st.key_lo = lo;
        st.key_hi = hi;
        st.z_lo = -1;
        st.z_hi = 0;
      } else {
        st.mode = kColSplit;
        st.prefix = lo;
        st.prefix_hi = hi;
        if (lane == 0) {
          sc.lo_max[s] = 0;
          sc.hi_min[s] = ~0ull;
        }
      }
    }
  } else if (st.mode == kColCompact) {  // the list is gathered: the finish kernel sorts it
    st.mode = kColListed;
  } else if (st.mode == kColSplit) {
    st.key_lo = __ldcg(&sc.lo_max[s]);
    st.key_hi = __ldcg(&sc.hi_min[s]);
    st.z_lo = -1;
    st.z_hi = 0;
    st.mode = kColDone;
  } else {
    return;
  }
  if (lane == 0) sc.steps[s] = st;
}

// One pass of the column form over a (tile of 32 steps, kColWarps chunks)
// block; `first`: the first pass (also counts each chunk's zero cells).
// The tile's last block to finish updates its steps.
__global__ void __launch_bounds__(kColWarps * 32) graphite_percentile_columns_kernel(
    const double* __restrict__ x, long long L, long long S, double qf, int first,
    long long groups, ColScratch sc) {
  __shared__ unsigned hist[kBuckets * 32];  // the digit counts [bucket][step of the tile]
  __shared__ unsigned long long lo_max[32], hi_min[32];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long tile = blockIdx.x / groups, g = blockIdx.x % groups;
  const long long s = tile * 32 + lane;
  ColStep st{};
  st.mode = kColDone;
  if (s < S) st = sc.steps[s];
  const bool reads = st.mode < kColListed;
  if (!__syncthreads_or(reads)) return;  // every block of the tile agrees
  for (int i = tid; i < kBuckets * 32; i += kColWarps * 32) hist[i] = 0;
  if (tid < 32) {
    lo_max[tid] = 0;
    hi_min[tid] = ~0ull;
  }
  __syncthreads();
  const long long n_chunks = (L + kColChunk - 1) / kColChunk;
  const long long c_end = (g + 1) * kColWarps < n_chunks ? (g + 1) * kColWarps : n_chunks;
  const int shift = 64 - kDigitBits - st.bits;
  unsigned long long mx = 0, mn = ~0ull;
  for (long long c = g * kColWarps + warp; c < c_end; c += kColWarps) {
    const long long i0 = c * kColChunk, i1 = i0 + kColChunk < L ? i0 + kColChunk : L;
    unsigned zeros = 0;
    for (long long i = i0; i < i1; i += kColRows) {
      double v[kColRows];
#pragma unroll
      for (int r = 0; r < kColRows; ++r)
        v[r] = reads && i + r < i1 ? x[(i + r) * S + s] : NAN;
#pragma unroll
      for (int r = 0; r < kColRows; ++r) {
        if (isnan(v[r])) continue;
        zeros += v[r] == 0.0;
        const unsigned long long key = order_key(v[r]);
        if (st.mode == kColRadix) {
          if (prefix_match(key, st.prefix, st.bits))
            atomicAdd(&hist[((key >> shift) & (kBuckets - 1)) * 32 + lane], 1u);
        } else if (st.mode == kColCompact) {
          if (prefix_match(key, st.prefix, st.bits)) {
            const unsigned at = atomicAdd(&sc.list_n[s], 1u);
            if (at < kColCap) sc.list[s * kColCap + at] = key;
          }
        } else if (prefix_match(key, st.prefix, st.bits)) {  // split
          mx = key > mx ? key : mx;
        } else if (prefix_match(key, st.prefix_hi, st.bits)) {
          mn = key < mn ? key : mn;
        }
      }
    }
    if (first && s < S) sc.zeros[c * S + s] = zeros;
  }
  if (st.mode == kColSplit) {
    atomicMax(&lo_max[lane], mx);
    atomicMin(&hi_min[lane], mn);
  }
  __syncthreads();
  for (int i = tid; i < kBuckets * 32; i += kColWarps * 32) {
    const unsigned n = hist[i];
    if (n) atomicAdd(&sc.hist[(tile * 32 + i % 32) * kBuckets + i / 32], n);
  }
  if (tid < 32 && tile * 32 + tid < S) {
    if (lo_max[tid] != 0) atomicMax(&sc.lo_max[tile * 32 + tid], lo_max[tid]);
    if (hi_min[tid] != ~0ull) atomicMin(&sc.hi_min[tile * 32 + tid], hi_min[tid]);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&sc.arrivals[tile], 1u) == (unsigned)(groups - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int w = warp; w < 32; w += kColWarps)
    if (tile * 32 + w < S) column_step(tile * 32 + w, qf, sc);
  if (tid == 0) sc.arrivals[tile] = 0;
}

// The value of the cell at rank z (-1: the last) among the cells of `key`
// at step s; one whole warp calls it.
__device__ double column_value(const double* __restrict__ x, long long L, long long S,
                               long long s, unsigned long long key, long long z,
                               const unsigned* __restrict__ zeros) {
  if (key != kZeroKey) return key_value(key);
  // +-0.0: the sign of the z-th zero cell in lane order; first its chunk
  const int lane = threadIdx.x & 31;
  const long long n_chunks = (L + kColChunk - 1) / kColChunk;
  long long chunk = -1, before = 0;
  if (z < 0) {
    for (long long c0 = (n_chunks - 1) / 32 * 32; c0 >= 0 && chunk < 0; c0 -= 32) {
      const long long c = c0 + lane;
      const unsigned has = __ballot_sync(kFull, c < n_chunks && zeros[c * S + s] > 0);
      if (has) chunk = c0 + 31 - __clz(has);
    }
  } else {
    for (long long c0 = 0; c0 < n_chunks && chunk < 0; c0 += 32) {
      const long long c = c0 + lane;
      const unsigned n = c < n_chunks ? zeros[c * S + s] : 0;
      unsigned incl = n;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      const unsigned hit = __ballot_sync(kFull, before + (long long)incl > z);
      if (hit) {
        const int src = __ffs(hit) - 1;
        chunk = c0 + src;
        before += __shfl_sync(kFull, incl - n, src);
      } else {
        before += __shfl_sync(kFull, incl, 31);
      }
    }
  }
  // then the cell, walking the chunk in lane order
  const long long i0 = chunk * kColChunk, i1 = i0 + kColChunk < L ? i0 + kColChunk : L;
  long long want = z - before;
  double found = 0.0;
  for (long long i = i0; i < i1; i += 32) {
    const double v = i + lane < i1 ? x[(i + lane) * S + s] : NAN;
    const unsigned zb = __ballot_sync(kFull, v == 0.0);
    if (!zb) continue;
    if (z < 0) {
      found = __shfl_sync(kFull, v, 31 - __clz(zb));
      continue;
    }
    const int n = __popc(zb);
    if (want < n) {
      const bool hit = ((zb >> lane) & 1u) && __popc(zb & ((1u << lane) - 1u)) == want;
      return __shfl_sync(kFull, v, __ffs(__ballot_sync(kFull, hit)) - 1);
    }
    want -= n;
  }
  return found;
}

// Writes each step's percentile from its selected keys, a block per step;
// a listed step's candidates are sorted first and read at the ranks.
__global__ void __launch_bounds__(kColWarps * 32) graphite_percentile_finish_kernel(
    const double* __restrict__ x, long long L, long long S, double qf, int midpoint,
    ColScratch sc, double* __restrict__ out) {
  __shared__ unsigned long long keys[kColCap];
  __shared__ int pos[kColCap];
  const long long s = blockIdx.x;
  ColStep st = sc.steps[s];
  if (st.mode == kColListed) {
    const int m = (int)sc.list_n[s];
    int P = 1;
    while (P < m) P <<= 1;
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
      keys[i] = i < m ? sc.list[s * kColCap + i] : ~0ull;
      pos[i] = i;
    }
    __syncthreads();
    bitonic_sort(keys, pos, P);
    st.key_lo = keys[st.r];
    st.key_hi = keys[st.r + st.d];
    // each rank among its key's cells: less the first position of the key
    int lo = 0, hi = (int)st.r;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (keys[mid] < st.key_lo) lo = mid + 1;
      else hi = mid;
    }
    st.z_lo = st.r - lo;
    lo = 0, hi = (int)(st.r + st.d);
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (keys[mid] < st.key_hi) lo = mid + 1;
      else hi = mid;
    }
    st.z_hi = st.r + st.d - lo;
  }
  if (threadIdx.x >= 32) return;  // the first warp reads the values
  double v = __longlong_as_double(0x7ff8000000000000LL);
  if (st.n > 0) {
    const PercentilePick k = percentile_pick((double)st.n, qf);
    const double lo = column_value(x, L, S, s, st.key_lo, st.z_lo, sc.zeros);
    const double hi = column_value(x, L, S, s, st.key_hi, st.z_hi, sc.zeros);
    v = midpoint ? (lo + hi) * 0.5 : lo * k.lw + hi * k.hw;
  }
  if (threadIdx.x == 0) out[s] = v;
}

// The column form's scratch carved from `base` (null: sizes only); returns
// its bytes, and in *zeroed the bytes of its head that start at zero.
long long column_layout(long long L, long long S, void* base, ColScratch* sc, long long* zeroed) {
  const long long n_tiles = (S + 31) / 32, n_chunks = (L + kColChunk - 1) / kColChunk;
  char* p = (char*)base;
  long long at = 0;
  auto take = [&](long long bytes) {
    void* q = p ? p + at : nullptr;
    at += (bytes + 15) / 16 * 16;
    return q;
  };
  sc->steps = (ColStep*)take(S * (long long)sizeof(ColStep));
  sc->hist = (unsigned*)take(S * kBuckets * 4LL);
  sc->arrivals = (unsigned*)take(n_tiles * 4LL);
  *zeroed = at;
  sc->list_n = (unsigned*)take(S * 4LL);
  sc->list = (unsigned long long*)take(S * kColCap * 8LL);
  sc->lo_max = (unsigned long long*)take(S * 8LL);
  sc->hi_min = (unsigned long long*)take(S * 8LL);
  sc->zeros = (unsigned*)take(n_chunks * S * 4LL);
  return at;
}

constexpr int kRowWarps = 8;

__global__ void __launch_bounds__(kRowWarps * 32) graphite_percentile_rows_kernel(
    const double* __restrict__ x, long long L, long long S, int real_S, int mode, double qf,
    int p_smem, long long p_scratch, unsigned long long* __restrict__ scratch_keys,
    int* __restrict__ scratch_pos, double* __restrict__ out) {
  extern __shared__ unsigned long long rsmem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long gw = (long long)blockIdx.x * kRowWarps + warp;
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  int P = 1;
  while (P < real_S) P <<= 1;
  unsigned long long* keys;
  int* pos;
  if (P <= p_smem) {
    keys = rsmem + warp * p_smem;
    pos = (int*)(rsmem + kRowWarps * p_smem) + warp * p_smem;
  } else {
    keys = scratch_keys + gw * p_scratch;
    pos = scratch_pos + gw * p_scratch;
  }
  for (long long row = gw; row < L; row += (long long)gridDim.x * kRowWarps) {
    const double* xr = x + row * S;
    int n = 0;
    for (int i = lane; i < P; i += 32) {
      if (i < real_S) {
        const double v = xr[i];
        n += !isnan(v);
        keys[i] = order_key(present_or_inf(v));
      } else {
        keys[i] = ~0ull;
      }
      pos[i] = i;
    }
    for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
    __syncwarp();
    warp_bitonic_sort(keys, pos, P);
    const PercentilePick k = percentile_pick((double)n, qf);
    const double p = n > 0 ? present_or_inf(xr[pos[k.low]]) * k.lw +
                                 present_or_inf(xr[pos[k.high]]) * k.hw
                           : nan;
    double* o = out + row * S;
    for (long long c = lane; c < S; c += 32) {
      const double v = c < real_S ? xr[c] : nan;
      if (mode == 1) o[c] = c < real_S ? p : nan;
      else if (mode == 2) o[c] = v > p ? nan : v;
      else o[c] = v < p ? nan : v;
    }
    __syncwarp();  // the pairs are rewritten by the next lane
  }
}

}  // namespace

extern "C" {

// QK7 for k > kKMax, topk (mode 1) or bottomk (mode 2): x f64[L, S]; members
// i64[offsets[G]] (lane ids, ascending within a group; every lane in exactly
// one group), offsets i64[G + 1] -> out f64[L, S], present i32[L] (zeroed by
// the caller), rank i64[L].  p_smem is the largest padded group size that
// sorts in shared memory (0 if none); p_scratch the largest padded size above
// it (0 if none), with scratch keys u64[grid, p_scratch] and positions
// i32[grid, p_scratch].  Launches on `stream` and returns cudaGetLastError()
// (a p_smem above the device's shared-memory opt-in fails at
// cudaFuncSetAttribute).
int m3_query_select(const double* x, long long S, const long long* members,
                    const long long* offsets, long long n_groups, int mode, long long k, int p_smem,
                    long long p_scratch, unsigned long long* scratch_keys, int* scratch_pos,
                    int grid, int threads, double* out, int* present, long long* rank,
                    void* stream) {
  if (mode < kTopk || mode > kBottomk || p_smem < 0 || grid < 1 ||
      (p_scratch > 0 && (p_scratch <= p_smem || scratch_keys == nullptr || scratch_pos == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n_groups <= 0 || S <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)p_smem * (sizeof(unsigned long long) + sizeof(int));
  // 4,096 pairs are 48 KB, at the default limit: opt in to the dynamic size
  // every launch asks for
  cudaError_t rc = cudaFuncSetAttribute(select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  select_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      x, S, members, offsets, n_groups, mode, k, p_smem, p_scratch, scratch_keys, scratch_pos, out,
      present, rank);
  return (int)cudaGetLastError();
}

// QK6's scratch: the bytes m3_query_quantile needs for n_folds groups of
// several chunks holding n_partial chunks, over S steps (0 when n_partial is
// 0: groups of one chunk need none).
long long m3_query_quantile_scratch(long long n_folds, long long n_partial, long long S) {
  if (n_partial <= 0 || S <= 0) return 0;
  GqScratch sc;
  long long zeroed;
  return gq_layout(n_folds, n_partial, S, nullptr, &sc, &zeroed);
}

// QK6, quantile by at phi (0 <= phi <= 1): x f64[L, S]; members i64[K] (lane
// ids, ascending within a group; null: lanes in order); chunks i64[5,
// n_chunks] and folds i64[3, n_folds] (ops/query_grouped.py:chunk_plan, the
// n_partial chunks of the folds first) -> out f64[G, S], G the groups of the
// table.  scratch: at least m3_query_quantile_scratch(n_folds, n_partial, S)
// bytes.  Launches on `stream` (one launch without folds; else a memset,
// kGqLaunches chunk launches and the finish) and returns cudaGetLastError().
int m3_query_quantile(const double* x, long long S, const long long* members,
                      const long long* chunks, long long n_chunks, long long n_partial,
                      const long long* folds, long long n_folds, double phi, void* scratch,
                      long long scratch_bytes, double* out, void* stream) {
  if (!(phi >= 0.0 && phi <= 1.0) || n_chunks < 0 || n_partial < 0 || n_partial > n_chunks ||
      n_folds < 0 || (n_partial > 0 && n_folds == 0))
    return (int)cudaErrorInvalidValue;
  if (n_chunks == 0 || S <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n_tiles = (S + 31) / 32;
  GqScratch sc{};
  if (n_partial > 0) {
    long long zeroed;
    if (scratch == nullptr ||
        scratch_bytes < gq_layout(n_folds, n_partial, S, nullptr, &sc, &zeroed))
      return (int)cudaErrorInvalidValue;
    gq_layout(n_folds, n_partial, S, scratch, &sc, &zeroed);
    cudaError_t rc = cudaMemsetAsync(scratch, 0, (size_t)zeroed, st);
    if (rc != cudaSuccess) return (int)rc;
  }
  const long long blocks = (n_chunks * n_tiles + kGqWarps - 1) / kGqWarps;
  const long long finish = (n_folds * S + kGqWarps - 1) / kGqWarps;
  if (blocks > 0x7fffffffLL || finish > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  for (int p = 0; p < (n_partial > 0 ? kGqLaunches : 1); ++p) {
    const long long work = p == 0 ? n_chunks : n_partial;
    quantile_chunk_kernel<<<(unsigned)((work * n_tiles + kGqWarps - 1) / kGqWarps),
                            kGqWarps * 32, 0, st>>>(x, S, members, chunks, n_chunks, work,
                                                    n_tiles, folds, n_folds, phi, p, sc, out);
  }
  if (n_partial > 0)
    quantile_finish_kernel<<<(unsigned)finish, kGqWarps * 32, 0, st>>>(S, folds, n_folds, phi, sc,
                                                                       out);
  return (int)cudaGetLastError();
}

// QK7's selection, topk (mode 1) or bottomk (mode 2) of 1 <= k <= kKMax:
// x f64[L, S]; members i64[K] (lane ids, ascending within a group; every
// lane in exactly one group); chunks i64[5, n_chunks] and folds i64[3,
// n_folds] (ops/query_grouped.py:chunk_plan); scratch
// cand_keys u64[n_partial, k, S], cand_pos i64 alike, thr_keys u64[n_folds,
// S], thr_pos i64 alike (null when n_partial is 0) -> out f64[L, S], present
// i32[L] (zeroed by the caller), rank i64[L] (filled with 2^62 by the
// caller).  Launches on `stream` (one or three kernels) and returns
// cudaGetLastError().
int m3_query_topk(const double* x, long long S, const long long* members,
                  const long long* chunks, long long n_chunks, long long n_partial,
                  const long long* folds, long long n_folds, int mode, int k,
                  unsigned long long* cand_keys, long long* cand_pos,
                  unsigned long long* thr_keys, long long* thr_pos, double* out, int* present,
                  long long* rank, void* stream) {
  if (mode < kTopk || mode > kBottomk || k < 1 || k > kKMax || n_chunks < 0 || n_partial < 0 ||
      n_partial > n_chunks || n_folds < 0 ||
      (n_partial > 0 && (n_folds == 0 || cand_keys == nullptr || cand_pos == nullptr ||
                         thr_keys == nullptr || thr_pos == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n_chunks == 0 || S <= 0) return (int)cudaSuccess;
  const long long n_tiles = (S + 31) / 32;
  const long long blocks = (n_chunks * n_tiles + kSelWarps - 1) / kSelWarps;
  const long long merge_blocks = (n_folds * S + kMergeThreads - 1) / kMergeThreads;
  if (blocks > 0x7fffffffLL || merge_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kSelWarps * 2 * k * 32 * sizeof(unsigned long long);
  cudaError_t rc = cudaFuncSetAttribute(topk_chunk_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  cudaStream_t st = (cudaStream_t)stream;
  topk_chunk_kernel<<<(unsigned)blocks, kSelWarps * 32, smem, st>>>(
      x, S, members, chunks, n_chunks, n_chunks, n_partial, n_tiles, mode, k, 0, cand_keys,
      cand_pos, thr_keys, thr_pos, out, present, rank);
  if ((rc = cudaGetLastError()) != cudaSuccess || n_folds == 0) return (int)rc;
  topk_merge_kernel<<<(unsigned)merge_blocks, kMergeThreads,
                      (size_t)2 * k * kMergeThreads * sizeof(unsigned long long), st>>>(
      members, S, folds, n_folds, k, cand_keys, cand_pos, thr_keys, thr_pos, rank);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  topk_chunk_kernel<<<(unsigned)((n_partial * n_tiles + kSelWarps - 1) / kSelWarps),
                      kSelWarps * 32, smem, st>>>(
      x, S, members, chunks, n_chunks, n_partial, n_partial, n_tiles, mode, k, 1, cand_keys,
      cand_pos, thr_keys, thr_pos, out, present, rank);
  return (int)cudaGetLastError();
}

// QK11: times i64[L, N], values f64[L, N], steps i64[S] -> out f64[L, S],
// quantile_over_time at phi (0 <= phi <= 1).
// listed i64[L * ceil(S / 32)] and n_listed u64[1]: the long runs' units
// (scratch); grid: at most this many blocks of the short-run kernel (capped
// at the blocks the card holds at once), long_grid blocks of the long-run
// one.  p_scratch: 0, or the padded lane length with scratch keys
// u64[long_grid * kQLongWarps * p_scratch] and positions i32 alike (windows
// of more than kQLongRegion samples sort there).  Launches both kernels on
// `stream` and returns cudaGetLastError().
int m3_quantile_window(const long long* times, const double* values, const long long* steps,
                       long long L, long long N, int S, int levels, long long range_nanos,
                       double phi, long long* listed, unsigned long long* n_listed,
                       long long p_scratch, unsigned long long* scratch_keys, int* scratch_pos,
                       double* out, int grid, int long_grid, void* stream) {
  if (!(phi >= 0.0 && phi <= 1.0) || N < 1 || grid < 1 || long_grid < 1 ||
      listed == nullptr || n_listed == nullptr ||
      (p_scratch > 0 && (scratch_keys == nullptr || scratch_pos == nullptr)) ||
      (N > kQLongRegion && p_scratch < N))
    return (int)cudaErrorInvalidValue;
  if (L <= 0 || S <= 0) return (int)cudaSuccess;
  const size_t smem = kQWarps * run_bytes<kQRegion>();
  const size_t long_smem = kQLongWarps * run_bytes<kQLongRegion>();
  cudaError_t rc = cudaFuncSetAttribute(quantile_window_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaFuncSetAttribute(quantile_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)long_smem);
  if (rc != cudaSuccess) return (int)rc;
  int dev = 0, sms = 1, per_sm = 1;
  if ((rc = cudaGetDevice(&dev)) != cudaSuccess ||
      (rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, quantile_window_kernel,
                                                          kQWarps * 32, smem)) != cudaSuccess)
    return (int)rc;
  if (per_sm >= 1 && grid > per_sm * sms) grid = per_sm * sms;  // one wave, striding over units
  cudaStream_t st = (cudaStream_t)stream;
  if ((rc = cudaMemsetAsync(n_listed, 0, sizeof(unsigned long long), st)) != cudaSuccess)
    return (int)rc;
  quantile_window_kernel<<<grid, kQWarps * 32, smem, st>>>(times, values, steps, L, N, S, levels,
                                                           range_nanos, phi, listed, n_listed,
                                                           out);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  quantile_long_kernel<<<long_grid, kQLongWarps * 32, long_smem, st>>>(
      times, values, steps, N, S, levels, range_nanos, phi, listed, n_listed, p_scratch,
      scratch_keys, scratch_pos, out);
  return (int)cudaGetLastError();
}

// GK2's column form's scratch: the bytes m3_graphite_percentile needs in
// mode 0 for x f64[L, S].
long long m3_graphite_percentile_scratch(long long L, long long S) {
  ColScratch sc;
  long long zeroed;
  return column_layout(L, S, nullptr, &sc, &zeroed);
}

// GK2: x f64[L, S].  mode 0 (the column form): out f64[S], the percentile at
// the finite fraction qf of each step's L lanes (mode 4: the midpoint of its
// two cells, the median at qf 0.5); scratch_keys is a scratch of p_scratch
// >= m3_graphite_percentile_scratch(L, S) bytes (p_smem, scratch_pos and
// grid unused); kColPasses + 1 launches after a memset.
// mode 1-3 (the row form: nPercentile, removeAbovePercentile,
// removeBelowPercentile): out f64[L, S] from each lane's first real_S steps,
// `grid` blocks of kRowWarps warps; p_smem: the padded size (pairs) that
// sorts in shared memory; p_scratch: 0, or the padded size past it with
// scratch keys u64[grid * kRowWarps * p_scratch] and positions i32 alike.
// Launches on `stream` and returns cudaGetLastError().
int m3_graphite_percentile(const double* x, long long L, long long S, int real_S, int mode,
                           double qf, int p_smem, long long p_scratch,
                           unsigned long long* scratch_keys, int* scratch_pos, int grid,
                           double* out, void* stream) {
  if (mode < 0 || mode > 4 || !isfinite(qf) || real_S < 0 || real_S > S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0 || mode == 4) {
    ColScratch sc;
    long long zeroed;
    if (scratch_keys == nullptr || p_scratch < column_layout(L, S, nullptr, &sc, &zeroed))
      return (int)cudaErrorInvalidValue;
    if (L <= 0 || S <= 0) return (int)cudaSuccess;
    column_layout(L, S, scratch_keys, &sc, &zeroed);
    cudaError_t rc = cudaMemsetAsync(scratch_keys, 0, (size_t)zeroed, st);
    if (rc != cudaSuccess) return (int)rc;
    const long long n_tiles = (S + 31) / 32;
    const long long groups = ((L + kColChunk - 1) / kColChunk + kColWarps - 1) / kColWarps;
    if (n_tiles * groups > 0x7fffffffLL || S > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    for (int p = 0; p < kColPasses; ++p)
      graphite_percentile_columns_kernel<<<(unsigned)(n_tiles * groups), kColWarps * 32, 0, st>>>(
          x, L, S, qf, p == 0, groups, sc);
    graphite_percentile_finish_kernel<<<(unsigned)S, kColWarps * 32, 0, st>>>(
        x, L, S, qf, mode == 4, sc, out);
    return (int)cudaGetLastError();
  }
  if (p_smem < 1 || grid < 1 ||
      (p_scratch > 0 && (scratch_keys == nullptr || scratch_pos == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (L <= 0 || S <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)kRowWarps * p_smem * (sizeof(unsigned long long) + sizeof(int));
  cudaError_t rc = cudaFuncSetAttribute(graphite_percentile_rows_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  graphite_percentile_rows_kernel<<<grid, kRowWarps * 32, smem, st>>>(
      x, L, S, real_S, mode, qf, p_smem, p_scratch, scratch_keys, scratch_pos, out);
  return (int)cudaGetLastError();
}

const char* m3_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
