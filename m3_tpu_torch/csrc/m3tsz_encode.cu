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
// Here one thread walks one lane's fields in order with a 64-bit bit buffer
// and writes each finished big-endian word once: the prefix sum is the
// thread's running bit count, and the scatter-add (a bitwise OR, since the
// fields never overlap) is the shift into the buffer.  After the walk the
// block zero-fills the tail of each of its rows with coalesced stores (the
// decoder loads five words at its cursor, so the tail must be zero).
//
// What bounds it on an H100: the bytes.  Each step reads 32 B (timestamp,
// two u64 and two i32 value fields) and each row writes n_words_for(T) u32.
// One thread per lane makes the reads and the used words strided across a
// warp; the zero-fill, most of the row on compact series, is coalesced.
//
// Shifts by 64 are undefined in C++: every shift below stays in [0, 63].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr unsigned long long kEos = (0x100ull << 2) | 0ull;  // marker opcode + EOS
constexpr int kEosBits = 11;

struct Writer {
  unsigned* row;
  int cap;     // words in the row
  int nw;      // words written
  int used;    // bits held at the top of buf, < 32 between calls
  long long total;
  unsigned long long buf;

  __device__ void emit(unsigned w) {
    if (nw < cap) row[nw] = w;
    ++nw;
  }

  // Append the low n bits of `bits` (0 <= n <= 64), most significant first.
  __device__ void put(unsigned long long bits, int n) {
    if (n <= 0) return;
    total += n;
    if (n < 64) bits &= (1ull << n) - 1ull;
    const int space = 64 - used;  // >= 33
    if (n <= space) {
      buf |= bits << (space - n);
      used += n;
    } else {  // n in (space, 64]: the top `space` bits fill the buffer
      const int rem = n - space;  // 1..31
      buf |= bits >> rem;
      emit((unsigned)(buf >> 32));
      emit((unsigned)buf);
      buf = bits << (64 - rem);
      used = rem;
    }
    while (used >= 32) {
      emit((unsigned)(buf >> 32));
      buf <<= 32;
      used -= 32;
    }
  }

  __device__ void finish() {
    if (used > 0) emit((unsigned)(buf >> 32));
  }
};

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

__global__ void __launch_bounds__(kThreads) pack_encode_kernel(
    const long long* __restrict__ ts, const long long* __restrict__ start,
    const int* __restrict__ n_valid, const unsigned long long* __restrict__ ctl_bits,
    const int* __restrict__ ctl_n, const unsigned long long* __restrict__ pay_bits,
    const int* __restrict__ pay_n, int L, int T, int W, long long unit,
    unsigned* __restrict__ words, int* __restrict__ nbits) {
  __shared__ int used_words[kThreads];
  const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
  int nw = 0;
  if (lane < L) {
    Writer w{words + lane * (long long)W, W, 0, 0, 0, 0ull};
    const long long row = lane * (long long)T;
    const int nv = n_valid[lane];
    const long long st = start[lane];
    if (nv > 0) w.put((unsigned long long)st, 64);
    unsigned long long prev_t = (unsigned long long)st, prev_delta = 0ull;
    for (int t = 0; t < T; ++t) {
      const unsigned long long tt = (unsigned long long)ts[row + t];
      const unsigned long long delta = tt - prev_t;  // wrapping, as XLA's int64
      const long long raw = (long long)(delta - prev_delta);
      prev_t = tt;
      prev_delta = delta;
      if (t < nv) {
        unsigned long long bits;
        int n;
        time_field(raw / unit, &bits, &n);  // '/' truncates toward zero
        w.put(bits, n);
      }
      w.put(ctl_bits[row + t], ctl_n[row + t]);
      w.put(pay_bits[row + t], pay_n[row + t]);
    }
    if (nv > 0) w.put(kEos, kEosBits);
    w.finish();
    nbits[lane] = (int)w.total;
    nw = w.nw < W ? w.nw : W;
  }
  used_words[threadIdx.x] = nw;
  __syncthreads();
  // zero-fill the tail of every row of this block, coalesced
  const long long first = (long long)blockIdx.x * kThreads;
  for (int r = 0; r < kThreads && first + r < L; ++r) {
    unsigned* out = words + (first + r) * (long long)W;
    for (int k = used_words[r] + threadIdx.x; k < W; k += kThreads) out[k] = 0u;
  }
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
  const int blocks = (L + kThreads - 1) / kThreads;
  pack_encode_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      ts, start, n_valid, ctl_bits, ctl_n, pay_bits, pay_n, L, T, W, unit, words, nbits);
  return (int)cudaGetLastError();
}

const char* m3_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
