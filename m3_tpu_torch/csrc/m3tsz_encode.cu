// Batched M3TSZ encode, the device half (kernel E1) on Hopper.
//
// Replaces m3_tpu/ops/m3tsz_encode.py: pack_encode (with _time_fields and
// _pack_fields, jitted as _pack_encode_jit).  The reference builds an
// [L, 2 + 3T] matrix of variable-width fields (stream start, then per step
// the delta-of-delta time field, the value control field and the value
// payload, then the EOS marker), gives each field its bit offset with an
// exclusive prefix sum, and scatter-adds each field into at most three
// 32-bit words.
//
// Here one warp encodes one lane, 32 steps at a time, in the reference's
// form.  Each thread loads one step's timestamp and value fields (coalesced
// runs of the row; the next chunk's loads are issued before this chunk is
// packed), forms the step's delta-of-delta time field from the previous two
// timestamps (by shuffle, with the chunk's carry), and an exclusive warp
// scan of the steps' widths plus the lane's running bit count gives each
// field its bit offset (the 64-bit stream start before step 0, the 11-bit
// EOS after the last step).  The threads OR their fields into the warp's
// word buffer in shared memory (atomicOr: the fields never overlap, so the
// bits do not depend on the order); after each chunk the warp stores the
// finished words up to a 32-byte boundary of `words` as consecutive 4-byte
// stores, whole sectors, and keeps the rest (at most 7 words and the partial
// one).  It then zero-fills the row's tail up to W (the decoder
// loads five words past its cursor).  Words past W are dropped and nbits
// is the exact length all the same (the caller's capacity guard).
//
// What bounds it on an H100: the bytes.  Each step reads 32 B (timestamp,
// two u64 and two i32 value fields) and each row writes W = n_words_for(T)
// u32; with a warp a lane, loads and stores are whole-sector runs, and a
// seal's 1,024 lanes are 1,024 warps (256 blocks) rather than 8 blocks of
// one thread a lane.
//
// Every field is at most 64 bits wide (wider value fields are cut to 64);
// shifts by 64 are undefined in C++: every shift below stays in [0, 63].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // warps (lanes) a block
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kEos = (0x100ull << 2) | 0ull;  // marker opcode + EOS
constexpr int kEosBits = 11;
constexpr int kMaxStepBits = 36 + 64 + 64;  // time field, control, payload
// up to 7 carried words and the partial one (or the stream start), a
// chunk's fields and the spill word of the last one
constexpr int kBufWords = (8 * 32 + 32 * kMaxStepBits) / 32 + 3;

// The delta-of-delta time field of one valid step (second unit; the 32-bit
// default bucket): ref timestamp_encoder.go:174-213, scheme.go:42-52.
__device__ __forceinline__ void time_field(long long dod, unsigned long long* bits, int* n) {
  const unsigned long long d = (unsigned long long)dod;
  if (dod == 0) {
    *bits = 0ull;
    *n = 1;
  } else if (dod >= -64 && dod <= 63) {
    *bits = (0b10ull << 7) | (d & 0x7Full);
    *n = 9;
  } else if (dod >= -256 && dod <= 255) {
    *bits = (0b110ull << 9) | (d & 0x1FFull);
    *n = 12;
  } else if (dod >= -2048 && dod <= 2047) {
    *bits = (0b1110ull << 12) | (d & 0xFFFull);
    *n = 16;
  } else {
    *bits = (0b1111ull << 32) | (d & 0xFFFFFFFFull);
    *n = 36;
  }
}

__device__ __forceinline__ int field_width(int n) { return n < 0 ? 0 : (n > 64 ? 64 : n); }

// OR the low n bits of `bits` (0 <= n <= 64), most significant first, into
// buf at bit `at` (big-endian words): at most three words, as _pack_fields.
__device__ __forceinline__ void or_field(unsigned* buf, int at, unsigned long long bits, int n) {
  if (n <= 0) return;
  const unsigned long long aligned = bits << (64 - n);
  const int b = at & 31, w0 = at >> 5;
  const unsigned long long main = aligned >> b;
  if ((unsigned)(main >> 32)) atomicOr(&buf[w0], (unsigned)(main >> 32));
  if ((unsigned)main) atomicOr(&buf[w0 + 1], (unsigned)main);
  if (b > 0) {
    const unsigned spill = (unsigned)((aligned << (64 - b)) >> 32);
    if (spill) atomicOr(&buf[w0 + 2], spill);
  }
}

struct Step {
  unsigned long long ts, cb, pb;
  int cn, pn;
};

__device__ __forceinline__ Step load_step(const long long* __restrict__ ts,
                                          const unsigned long long* __restrict__ ctl_bits,
                                          const int* __restrict__ ctl_n,
                                          const unsigned long long* __restrict__ pay_bits,
                                          const int* __restrict__ pay_n, long long at, bool in) {
  Step s{0ull, 0ull, 0ull, 0, 0};
  if (in) {
    s.ts = (unsigned long long)ts[at];
    s.cb = ctl_bits[at];
    s.cn = field_width(ctl_n[at]);
    s.pb = pay_bits[at];
    s.pn = field_width(pay_n[at]);
  }
  return s;
}

__global__ void __launch_bounds__(kWarps * 32) pack_encode_kernel(
    const long long* __restrict__ ts, const long long* __restrict__ start,
    const int* __restrict__ n_valid, const unsigned long long* __restrict__ ctl_bits,
    const int* __restrict__ ctl_n, const unsigned long long* __restrict__ pay_bits,
    const int* __restrict__ pay_n, int L, int T, int W, long long unit,
    unsigned* __restrict__ words, int* __restrict__ nbits) {
  __shared__ unsigned bufs[kWarps][kBufWords];
  const int lane = threadIdx.x & 31;
  unsigned* buf = bufs[threadIdx.x >> 5];
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= L) return;  // the whole warp
  for (int k = lane; k < kBufWords; k += 32) buf[k] = 0u;
  __syncwarp();
  const long long rt = row * (long long)T;
  const long long g0 = row * (long long)W;  // the row's first word in `words`
  unsigned* out = words + g0;
  const int nv = n_valid[row];
  const unsigned long long st = (unsigned long long)start[row];
  long long base = 0;   // bits placed so far
  long long wbase = 0;  // the row word buf[0] holds
  if (nv > 0) {
    if (lane == 0) {
      buf[0] = (unsigned)(st >> 32);
      buf[1] = (unsigned)st;
    }
    base = 64;
  }
  __syncwarp();
  unsigned long long carry_t = st, carry_d = 0ull;  // ts[t0 - 1] and its delta
  Step next = load_step(ts, ctl_bits, ctl_n, pay_bits, pay_n, rt + lane, lane < T);
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int t = t0 + lane;
    const Step s = next;
    next = load_step(ts, ctl_bits, ctl_n, pay_bits, pay_n, rt + t + 32, t + 32 < T);
    const unsigned long long up_t = __shfl_up_sync(kFull, s.ts, 1);
    const unsigned long long delta = s.ts - (lane == 0 ? carry_t : up_t);  // wrapping, as XLA
    const unsigned long long up_d = __shfl_up_sync(kFull, delta, 1);
    const unsigned long long prev_delta = lane == 0 ? carry_d : up_d;
    carry_t = __shfl_sync(kFull, s.ts, 31);
    carry_d = __shfl_sync(kFull, delta, 31);
    unsigned long long tb = 0ull;
    int tn = 0;
    if (t < T && t < nv)
      time_field((long long)(delta - prev_delta) / unit, &tb, &tn);  // '/' truncates to zero
    const int width = tn + s.cn + s.pn;
    int incl = width;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    const int chunk = __shfl_sync(kFull, incl, 31);
    int at = (int)(base - wbase * 32) + incl - width;
    or_field(buf, at, tb, tn);
    at += tn;
    or_field(buf, at, s.cb, s.cn);
    at += s.cn;
    or_field(buf, at, s.pb, s.pn);
    __syncwarp();
    base += chunk;
    // store the finished words up to a sector boundary; keep the rest
    const long long done = base >> 5;
    const long long flush = ((g0 + done) & ~7ll) - g0;
    const int n_out = (int)(flush - wbase);
    if (n_out > 0) {
      for (int k = lane; k < n_out; k += 32)
        if (wbase + k < W) out[wbase + k] = buf[k];
      const int keep = (int)(done - flush) + 1;  // <= 7 finished words and the partial one
      const unsigned moved = lane < keep ? buf[n_out + lane] : 0u;
      __syncwarp();
      for (int k = lane; k < n_out + keep; k += 32) buf[k] = k < keep ? moved : 0u;
      __syncwarp();
      wbase = flush;
    }
  }
  if (nv > 0) {
    if (lane == 0) or_field(buf, (int)(base - wbase * 32), kEos, kEosBits);
    base += kEosBits;
    __syncwarp();
  }
  const long long used = (base + 31) >> 5;  // words holding bits
  for (long long k = wbase + lane; k < used && k < W; k += 32) out[k] = buf[k - wbase];
  for (long long k = used + lane; k < W; k += 32) out[k] = 0u;
  if (lane == 0) nbits[row] = (int)base;
}

}  // namespace

extern "C" {

// ts i64[L, T], start i64[L], n_valid i32[L], ctl_bits u64[L, T], ctl_n i32[L, T],
// pay_bits u64[L, T], pay_n i32[L, T] -> words u32[L, W], nbits i32[L].
// Launches on `stream` and returns cudaGetLastError().
int m3_pack_encode(const long long* ts, const long long* start, const int* n_valid,
                   const unsigned long long* ctl_bits, const int* ctl_n,
                   const unsigned long long* pay_bits, const int* pay_n, int L, int T, int W,
                   long long unit, unsigned* words, int* nbits, void* stream) {
  if (L <= 0) return 0;
  const int blocks = (L + kWarps - 1) / kWarps;
  pack_encode_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      ts, start, n_valid, ctl_bits, ctl_n, pay_bits, pay_n, L, T, W, unit, words, nbits);
  return (int)cudaGetLastError();
}

const char* m3_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
