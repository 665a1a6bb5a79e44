// Group-by reduction of a served [L, S] matrix on Hopper (QK4).
//
// Replaces, from m3_tpu/models/query_pipeline.py:
//   _grouped_reduce (:915) without quantile: sum, avg, count, min, max,
//       group, stddev, stdvar of each group's lanes, per step (NaN cells
//       absent, a group-step with no present cell NaN, stddev/stdvar in the
//       reference's two passes: the mean, then sum((x - mean)^2));
//   the fleet sum jnp.nansum(rate, axis=0) of device_rate_pipeline (:806):
//       the one-group case, with 0.0 in place of NaN;
//   the second pass of _grouped_reduce_sharded (:814) for stddev/stdvar
//       (op code sqdev): sum((x - center[seg % n_center, s])^2) over each
//       segment's present cells, 0.0 where none is present, with `center` the
//       [n_groups, S] global mean read by global group id, so that one launch
//       covers every (shard, group) segment (seg = shard * n_groups + group);
//   _graphite_grouped_reduce (:1216) but for count_series, median and
//       percentile: graphite's numpy NaN-reductions, the ops above (stddev
//       the population one) with multiply (the product of the present
//       cells), range (max - min) and the single-group diff (2 * row0 -
//       sum, NaN cells as 0.0) and last (the cell of the highest lane
//       present).  The caller picks what a group-step with no present cell
//       gives: 0.0 for graphite's sum and count, 1.0 for its product.
//
// The JAX program uses segment_sum/segment_min, which are scatters with a
// combiner.  Here there are no floating-point atomics, so the result is the
// same on every run.  The host hands in a stable CSR of each group's lanes
// (ascending lane order) and a chunk table built from the group sizes alone
// (ops/query_grouped.py:chunk_plan): each group is cut into chunks of at most
// CHUNK (256) consecutive members, an empty group being one empty chunk.  The
// unit of work is a (chunk, tile of 32 steps), taken by one warp: lane w on
// step w of the tile, so each load is a coalesced 256-byte row segment; the
// chunk's member ids are loaded 32 at a time and shuffled (a one-lane chunk's
// lane comes with the chunk), and kRows rows are loaded ahead of the fold.  A
// block holds kWarps units, so small groups go kWarps to a block, and a group
// of n lanes spreads over ceil(n / CHUNK) warps per tile.
//
// Order.  A warp folds its chunk from 0.0 in ascending lane order.  A group
// of one chunk writes its result directly: a group of at most CHUNK lanes is
// folded strictly in lane order.  A group of several chunks writes per-chunk
// partials (the sum, the count, and the min/max or last pair) to a scratch,
// and fold_kernel, a second launch, folds each (group, step)'s partials from
// 0.0 in ascending chunk order.  multiply is the exception: a product that
// overflows and later meets a zero ends NaN, 0 or +-inf by its order, and
// the reference (segment_prod on XLA:CPU) multiplies strictly in lane order
// from 1.0.  So for a group of several chunks product_kernel, in place of
// fold_kernel, takes the chunks' counts and multiplies the group's members
// again in lane order, one warp per (group, tile of 32 steps) fed by the
// block's other warps through shared memory.  The order depends on the
// group's own size only, never on the other groups, the grid or the card.
// stddev/stdvar: a one-chunk group's warp sweeps its lanes twice (the sum and
// count, then (x - mean)^2); for a group of several chunks the first fold
// writes the mean into `out`, a second chunk pass sums (x - mean)^2 per chunk
// (the sqdev form, `out` as the center) and a second fold adds those in chunk
// order.  min/max exclude NaN with +-inf fill and order -0.0 below +0.0, as
// XLA's min/max do.
//
// What bounds it on an H100: bytes (each cell of the [L, S] input read once,
// twice for stddev/stdvar; one f64 written per (group, step)); the partials
// are 32 bytes per (chunk, step) against the chunk's 8 * CHUNK.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;    // steps per unit of work (a warp's lanes)
constexpr int kWarps = 8;    // units per block
constexpr int kRows = 8;     // rows loaded ahead of the fold
constexpr int kFoldBatch = 16;  // partials loaded ahead of the fold
constexpr int kFoldThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

enum Agg : int { kSum = 0, kAvg = 1, kCount = 2, kMin = 3, kMax = 4, kGroup = 5, kStddev = 6,
                 kStdvar = 7, kMultiply = 8, kRange = 9, kDiff = 10, kLast = 11, kSqdev = 12,
                 kMean = 13 };  // kMean: the first fold of a multi-chunk stddev/stdvar

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

// What a fold carries besides the sum and the count: (a, b) is (min, max)
// for min/max/range, (product, unused) for multiply and (the last present
// cell, its lane) for last.
struct Pair {
  double a, b;
};

// Whether a chunk's partials carry its pair (multiply's product is taken
// anew by fold_kernel).
__device__ __forceinline__ bool uses_pair(int agg) {
  return agg == kMin || agg == kMax || agg == kRange || agg == kLast;
}

__device__ __forceinline__ Pair pair_init(int agg) {
  if (agg == kMultiply) return {1.0, 0.0};
  if (agg == kLast) return {__longlong_as_double(0x7ff8000000000000LL), -1.0};
  return {INFINITY, -INFINITY};
}

// Folds q (a cell, or a later chunk's partial) into p.
__device__ __forceinline__ Pair pair_fold(int agg, Pair p, Pair q) {
  if (agg == kMultiply) return {p.a * q.a, 0.0};
  if (agg == kLast) return q.b > p.b ? q : p;
  return {min_ieee(p.a, q.a), max_ieee(p.b, q.b)};
}

struct Acc {
  double sum, cnt;
  Pair p;
};

// The fold of members [lo, hi) at step s, from 0.0 in ascending order; with
// agg kSqdev it sums (x - c)^2 over the present cells.  Every lane of the
// warp calls it (the shuffles); a step past S reads nothing.  `first` is the
// lane of member lo, which a one-lane chunk reads without the member list.
__device__ Acc sweep(const double* __restrict__ x, long long S,
                     const long long* __restrict__ members, long long lo, long long hi,
                     long long first, long long s, int agg, double c) {
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  const int col = threadIdx.x & 31;
  Acc acc{0.0, 0.0, pair_init(agg)};
  for (long long base = lo; base < hi; base += 32) {
    const int n = hi - base < 32 ? (int)(hi - base) : 32;
    const long long mine = col >= n ? 0 : members == nullptr ? base + col
                           : hi - lo == 1 ? first : members[base + col];
    for (int j0 = 0; j0 < n; j0 += kRows) {
      double v[kRows];
      long long lane[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        lane[u] = __shfl_sync(kFull, mine, j0 + u);
        v[u] = s < S && j0 + u < n ? x[lane[u] * S + s] : nan;  // NaN: absent
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const bool m = !isnan(v[u]);
        if (agg == kSqdev) {
          const double d = m ? v[u] - c : 0.0;
          acc.sum += d * d;
        } else {
          acc.sum += m ? v[u] : 0.0;
        }
        acc.cnt += m ? 1.0 : 0.0;
        if (m) acc.p = pair_fold(agg, acc.p, {v[u], agg == kLast ? (double)lane[u] : v[u]});
      }
    }
  }
  return acc;
}

// A (group, step)'s result from its folded sum, count and pair (`var`:
// stddev/stdvar's sum((x - mean)^2) / max(count, 1)).
__device__ __forceinline__ double finish(int agg, const Acc& a, double var,
                                         const double* __restrict__ x, long long s,
                                         double empty_value) {
  const double denom = a.cnt > 1.0 ? a.cnt : 1.0;
  double r;
  switch (agg) {
    case kSum: r = a.sum; break;
    case kAvg: r = a.sum / denom; break;
    case kCount: r = a.cnt; break;
    case kMin: r = a.p.a; break;
    case kMax: r = a.p.b; break;
    case kGroup: r = 1.0; break;
    case kStddev: r = sqrt(var); break;
    case kStdvar: r = var; break;
    case kMultiply: r = a.p.a; break;
    case kRange: r = a.p.b - a.p.a; break;
    case kDiff: {
      const double v0 = x[s];  // lane 0 at this step, the minuend
      r = 2.0 * (isnan(v0) ? 0.0 : v0) - a.sum;
      break;
    }
    case kSqdev: r = a.sum; break;
    case kMean: return a.sum / denom;
    default: r = a.p.a; break;  // kLast
  }
  return a.cnt == 0.0 ? empty_value : r;
}

// The units (chunk, tile of 32 steps) of chunks [0, n_work), one a warp:
// the fold of the chunk's lanes at the tile's steps, written to the partials
// (a chunk of a group of several: chunk i < n_partial writes partial slot i)
// or finished into `out`.
__global__ void __launch_bounds__(kWarps * 32) chunk_kernel(
    const double* __restrict__ x, long long S, const long long* __restrict__ members,
    const long long* __restrict__ chunks, long long n_table, long long n_work,
    long long n_partial, long long n_tiles, int agg, double empty_value,
    const double* __restrict__ center, long long n_center, double* __restrict__ partials,
    double* __restrict__ out) {
  const long long unit = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (unit >= n_work * n_tiles) return;  // warp-uniform
  const long long ch = unit / n_tiles;
  const long long s = (unit % n_tiles) * kTile + (threadIdx.x & 31);
  const long long lo = chunks[ch], hi = chunks[n_table + ch], g = chunks[2 * n_table + ch];
  const long long first = chunks[4 * n_table + ch];
  const double c = agg == kSqdev && s < S ? center[(g % n_center) * S + s] : 0.0;
  const Acc a = sweep(x, S, members, lo, hi, first, s, agg, c);
  if (ch < n_partial) {  // a chunk of a group of several: its partials
    if (s >= S) return;
    const long long at = ch * S + s, part = n_partial * S;
    partials[at] = a.sum;
    partials[part + at] = a.cnt;
    if (uses_pair(agg)) {
      partials[2 * part + at] = a.p.a;
      partials[3 * part + at] = a.p.b;
    }
    return;
  }
  double var = 0.0;
  if (agg == kStddev || agg == kStdvar) {
    const double denom = a.cnt > 1.0 ? a.cnt : 1.0;
    var = sweep(x, S, members, lo, hi, first, s, kSqdev, a.sum / denom).sum / denom;
  }
  if (s < S) out[g * S + s] = finish(agg, a, var, x, s, empty_value);
}

// multiply for a group of several chunks: one block per (group, tile of 32
// steps).  Warp 0 multiplies, lane w on step w, in lane order from 1.0 (a
// NaN cell as 1.0, which leaves the product's bits as skipping it does);
// the other warps stage the next kProdBatch rows in shared memory while it
// multiplies the last ones, kProdRows rows a warp with their loads in
// flight together, so the chain of multiplies, and not the loads, sets
// the pace.
constexpr int kProdWarps = 16;
constexpr int kProdRows = 8;  // rows a staging warp loads at once
constexpr int kProdBatch = (kProdWarps - 1) * kProdRows;

// Rows [at, at + kProdBatch) of members (CSR positions, < hi) at step s into
// buf[row][32] by the staging warp `warp` (1 .. kProdWarps - 1).
__device__ __forceinline__ void stage_rows(const double* __restrict__ x, long long S,
                                           const long long* __restrict__ members, long long at,
                                           long long hi, long long s, int warp,
                                           double* __restrict__ buf) {
  const int lane = threadIdx.x & 31;
  const long long base = at + (long long)(warp - 1) * kProdRows;
  long long mine = 0;  // lane u < kProdRows holds row base + u's lane id
  if (lane < kProdRows && base + lane < hi) mine = members == nullptr ? base + lane
                                                                      : members[base + lane];
  double v[kProdRows];
#pragma unroll
  for (int u = 0; u < kProdRows; ++u) {
    const long long m = __shfl_sync(kFull, mine, u);
    v[u] = base + u < hi && s < S ? x[m * S + s] : 1.0;
  }
#pragma unroll
  for (int u = 0; u < kProdRows; ++u)
    buf[((warp - 1) * kProdRows + u) * kTile + lane] = isnan(v[u]) ? 1.0 : v[u];
}

__global__ void __launch_bounds__(kProdWarps * 32) product_kernel(
    const double* __restrict__ x, long long S, const long long* __restrict__ members,
    const long long* __restrict__ chunks, long long n_table,
    const long long* __restrict__ folds, long long n_folds, long long n_tiles,
    long long n_partial, double empty_value, const double* __restrict__ partials,
    double* __restrict__ out) {
  extern __shared__ double prod_rows[];  // [2][kProdBatch][kTile]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long f = blockIdx.x / n_tiles, s = (blockIdx.x % n_tiles) * kTile + lane;
  const long long g = folds[f], first = folds[n_folds + f], end = first + folds[2 * n_folds + f];
  const long long lo = chunks[first], hi = chunks[n_table + end - 1];
  const long long n_batches = (hi - lo + kProdBatch - 1) / kProdBatch;
  if (warp > 0 && n_batches > 0) stage_rows(x, S, members, lo, hi, s, warp, prod_rows);
  __syncthreads();
  double prod = 1.0;
  for (long long b = 0; b < n_batches; ++b) {
    double* cur = prod_rows + (b & 1) * kProdBatch * kTile;
    if (warp > 0) {
      if (b + 1 < n_batches)
        stage_rows(x, S, members, lo + (b + 1) * kProdBatch, hi, s, warp,
                   prod_rows + ((b + 1) & 1) * kProdBatch * kTile);
    } else {
      const long long left = hi - (lo + b * kProdBatch);
      const int n_rows = left < kProdBatch ? (int)left : kProdBatch;
      for (int r0 = 0; r0 < n_rows; r0 += kRows) {
        double v[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) v[u] = r0 + u < n_rows ? cur[(r0 + u) * kTile + lane] : 1.0;
#pragma unroll
        for (int u = 0; u < kRows; ++u) prod *= v[u];
      }
    }
    __syncthreads();
  }
  if (warp != 0 || s >= S) return;
  double cnt = 0.0;  // the chunks' counts of present cells
  for (long long c = first; c < end; ++c) cnt += partials[n_partial * S + c * S + s];
  out[g * S + s] = cnt == 0.0 ? empty_value : prod;
}

// folds i64[3, n_folds]: rows group, first chunk, number of chunks.  One
// thread per (group of several chunks, step) folds its partials from 0.0 in
// ascending chunk order (multiply takes product_kernel instead).  For
// stddev/stdvar the partial sums are the (x - mean)^2 sums of the second
// chunk pass.
__global__ void __launch_bounds__(kFoldThreads) fold_kernel(
    const double* __restrict__ x, long long S, const long long* __restrict__ folds,
    long long n_folds, long long n_partial, int agg, double empty_value,
    const double* __restrict__ partials, double* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kFoldThreads + threadIdx.x;
  if (i >= n_folds * S) return;
  const long long f = i / S, s = i % S;
  const long long g = folds[f], first = folds[n_folds + f], end = first + folds[2 * n_folds + f];
  const long long part = n_partial * S;
  const bool pair = uses_pair(agg);
  const Pair init = pair_init(agg);
  Acc a{0.0, 0.0, init};
  for (long long c0 = first; c0 < end; c0 += kFoldBatch) {
    double ps[kFoldBatch], pn[kFoldBatch], pa[kFoldBatch], pb[kFoldBatch];
#pragma unroll
    for (int u = 0; u < kFoldBatch; ++u) {
      const bool in = c0 + u < end;
      const long long at = (c0 + u) * S + s;
      ps[u] = in ? partials[at] : 0.0;
      pn[u] = in ? partials[part + at] : 0.0;
      pa[u] = in && pair ? partials[2 * part + at] : init.a;
      pb[u] = in && pair ? partials[3 * part + at] : init.b;
    }
#pragma unroll
    for (int u = 0; u < kFoldBatch; ++u) {
      if (c0 + u < end) {
        a.sum += ps[u];
        a.cnt += pn[u];
        if (pair) a.p = pair_fold(agg, a.p, {pa[u], pb[u]});
      }
    }
  }
  const double var = a.sum / (a.cnt > 1.0 ? a.cnt : 1.0);  // read by stddev/stdvar only
  out[g * S + s] = finish(agg, a, var, x, s, empty_value);
}

}  // namespace

extern "C" {

// x f64[L, S]; members i64[K] (lane ids, ascending within a group) or null
// for lanes 0..K-1 in order; chunks i64[5, n_chunks] and folds i64[3, n_folds]
// as above (ops/query_grouped.py:chunk_plan); partials f64[4, n_partial, S]
// (null if n_partial is 0) -> out f64[n_groups, S].  A group-step with no
// present cell gets `empty_value`.  agg kSqdev reads center f64[n_center, S]
// (row g % n_center for group g; null otherwise).  Launches on `stream` (one
// kernel; two with a group of several chunks, four for stddev/stdvar) and
// returns cudaGetLastError().
int m3_query_grouped(const double* x, long long S, const long long* members,
                     const long long* chunks, long long n_chunks, long long n_partial,
                     const long long* folds, long long n_folds, long long n_groups, int agg,
                     double empty_value, const double* center, long long n_center,
                     double* partials, double* out, void* stream) {
  if (agg < kSum || agg > kSqdev || n_chunks < 0 || n_partial < 0 || n_partial > n_chunks ||
      n_folds < 0 || (n_partial > 0 && (partials == nullptr || n_folds == 0)) ||
      (agg == kSqdev && (center == nullptr || n_center < 1)))
    return (int)cudaErrorInvalidValue;
  if (n_chunks == 0 || S <= 0) return (int)cudaSuccess;
  const long long n_tiles = (S + kTile - 1) / kTile;
  const long long blocks = (n_chunks * n_tiles + kWarps - 1) / kWarps;
  const long long fold_blocks = (n_folds * S + kFoldThreads - 1) / kFoldThreads;
  if (blocks > 0x7fffffffLL || fold_blocks > 0x7fffffffLL || n_folds * n_tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  chunk_kernel<<<(unsigned)blocks, kWarps * 32, 0, st>>>(
      x, S, members, chunks, n_chunks, n_chunks, n_partial, n_tiles, agg, empty_value, center,
      n_center, partials, out);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || n_folds == 0) return (int)rc;
  if (agg == kStddev || agg == kStdvar) {
    fold_kernel<<<(unsigned)fold_blocks, kFoldThreads, 0, st>>>(
        x, S, folds, n_folds, n_partial, kMean, 0.0, partials, out);
    if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
    chunk_kernel<<<(unsigned)((n_partial * n_tiles + kWarps - 1) / kWarps), kWarps * 32, 0, st>>>(
        x, S, members, chunks, n_chunks, n_partial, n_partial, n_tiles, kSqdev, 0.0, out,
        n_groups, partials, out);
    if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  }
  if (agg == kMultiply) {
    const size_t smem = (size_t)2 * kProdBatch * kTile * sizeof(double);
    if ((rc = cudaFuncSetAttribute(product_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem)) != cudaSuccess)
      return (int)rc;
    product_kernel<<<(unsigned)(n_folds * n_tiles), kProdWarps * 32, smem, st>>>(
        x, S, members, chunks, n_chunks, folds, n_folds, n_tiles, n_partial, empty_value,
        partials, out);
    return (int)cudaGetLastError();
  }
  fold_kernel<<<(unsigned)fold_blocks, kFoldThreads, 0, st>>>(
      x, S, folds, n_folds, n_partial, agg, empty_value, partials, out);
  return (int)cudaGetLastError();
}

const char* m3_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
