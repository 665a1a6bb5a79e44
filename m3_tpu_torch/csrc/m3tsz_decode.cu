// Batched M3TSZ decode on Hopper: one thread per lane, the decoder state in
// registers.
//
// Replaces, from m3_tpu/ops/m3tsz_decode.py:
//   K1  _decode_step (+ _init_state, _window128, _parse_timestamp,
//       _parse_sig_mult, _parse_xor, _plan_value, _apply_value, _emit_value)
//       -> decode_step(), a __device__ function shared by K2, K3 and T1;
//   K2  decode_downsample_fused -> decode_downsample_fused_kernel<full_agg>;
//   K3  decode_batched          -> decode_batched_kernel;
// and, from m3_tpu/ops/tiles.py:
//   T1  aggregate_tiles_kernel  -> aggregate_tiles_kernel (decode inline,
//       then the per-(lane, tile) reduction, without the [L, n_steps] grid).
//
// The JAX kernel reads each lane's 128-bit window with a one-hot masked
// row-sum over all of [L, W] on every step, because the TPU has no fast
// gather.  Here each thread loads the five words at its cursor directly.
// Every select of the branchless JAX state machine becomes a branch of the
// thread's own control flow; the values committed are the same.
//
// What bounds it on an H100: the integer work of the state machine, some
// 44 64-bit operations per datapoint, run by one thread per lane (the bytes
// are small: the compressed words are ~4.5 bits per datapoint, the K2
// outputs 16-48 bytes per window).  The per-lane word loads are not
// coalesced across a warp.  The results leave the SM through per-warp staged
// tiles in shared memory, in whole sectors (see kPad below).
//
// Bit-exactness: build with --fmad=false so `ssq + vz * vz` is a multiply
// then an add, as in the plain PyTorch version.  Shifts by 64 or more are
// undefined in C++; every shift whose count can reach 64 is guarded the way
// the JAX code guards it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxMult = 6;  // m3tsz_scalar.MAX_MULT
constexpr int kThreads = 128;

struct Divisors {
  double d[kMaxMult + 1];  // MULT_DIVISORS, passed by value from the host
};

// The decoder's state: the JAX state's fields, and the lane's bit reader.
// The reader keeps the five words of the lane's row that hold the 128-bit
// window at the cursor in registers, words base .. base + 4 with base =
// cursor >> 5, and reads the window from them by funnel shifts
// (__funnelshift_l).  When a record carries the cursor into the next word,
// the words move down one register and one word is loaded: ~0.15 loads a
// point on 4.5-bit records, where the five-load design made 5.  (A sixth
// word loaded one word ahead gained nothing on an H100: the loads hit L1.)
struct State {
  int32_t cursor;  // bit position
  bool started, done, error, is_float;
  int64_t prev_time, prev_delta, int_val;
  uint64_t prev_float, prev_xor;
  int32_t sig, mult;
  uint32_t w0, w1, w2, w3, w4;  // words cursor / 32 + 0 .. 4 (0 past W)
};

// Logical shifts that yield 0 for a count outside [0, 63], as XLA's do.
__device__ __forceinline__ uint64_t shl(uint64_t x, int n) {
  return (unsigned)n >= 64u ? 0ull : x << n;
}
// Two's-complement wrap-around, as the JAX int64 arithmetic does.
__device__ __forceinline__ int64_t wadd(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}
__device__ __forceinline__ int64_t wmul(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a * (uint64_t)b);
}
__device__ __forceinline__ int clz64(uint64_t x) {  // clz64(0) == 64
  return __clzll((long long)x);
}
__device__ __forceinline__ int ctz64(uint64_t x) {  // ctz64(0) == 0
  return x == 0 ? 0 : __ffsll((long long)x) - 1;
}
// Bits of a 32-bit control word c, bit 0 its MSB.
__device__ __forceinline__ bool bit_at(uint32_t c, int pos) { return (c >> (31 - pos)) & 1u; }
__device__ __forceinline__ int field_at(uint32_t c, int pos, int width) {
  return (int)((c >> (32 - width - pos)) & ((1u << width) - 1u));
}
__device__ __forceinline__ uint32_t load_word(const uint32_t* row, int W, int idx) {
  return idx < W ? __ldg(row + idx) : 0u;  // idx >= 0
}

__device__ __forceinline__ State init_state(const uint32_t* row, int W, int32_t nbits) {
  State st;
  st.cursor = 64;
  st.started = false;
  // Streams too small for start + EOS marker are immediately done.
  st.done = nbits < 64 + 11;
  st.error = false;
  st.is_float = false;
  st.prev_time = (int64_t)(((uint64_t)load_word(row, W, 0) << 32) | load_word(row, W, 1));
  st.prev_delta = 0;
  st.int_val = 0;
  st.prev_float = 0;
  st.prev_xor = 0;
  st.sig = 0;
  st.mult = 0;
  st.w0 = load_word(row, W, 2);
  st.w1 = load_word(row, W, 3);
  st.w2 = load_word(row, W, 4);
  st.w3 = load_word(row, W, 5);
  st.w4 = load_word(row, W, 6);
  return st;
}

struct Plan {
  int ctrl, payload_len, trail, new_sig, new_mult;
  bool full_float, int_active, xor_active, xor_zero, add, set_float, sig_mult_active;
};

// sig/mult update block + sign bit at bit `base` of c (iterator.go:145-168).
__device__ __forceinline__ void parse_sig_mult(uint32_t c, int base, const State& st, Plan& p) {
  const bool s_upd = bit_at(c, base);
  const bool s_nonzero = bit_at(c, base + 1);
  const int sig_field = field_at(c, base + 2, 6);
  const int k = s_upd ? (s_nonzero ? 8 : 2) : 1;
  p.new_sig = s_upd ? (s_nonzero ? sig_field + 1 : 0) : st.sig;
  const bool m_upd = bit_at(c, base + k);
  const int mult_field = field_at(c, base + k + 1, 3);
  const int m = m_upd ? 4 : 1;
  p.new_mult = m_upd ? mult_field : st.mult;
  p.add = bit_at(c, base + k + m);
  p.ctrl = base + k + m + 1;
}

// Float XOR record with its opcode at bit 0 of x (float_encoder_iterator.go:117-166).
__device__ __forceinline__ void parse_xor(uint32_t x, uint64_t prev_xor, Plan& p) {
  const bool x0 = bit_at(x, 0);
  const bool x1 = bit_at(x, 1);
  p.xor_zero = !x0;
  if (!x0) {
    p.ctrl = 1;
    p.payload_len = 0;
    p.trail = 0;  // unused: a zero record XORs nothing
  } else if (!x1) {
    const int prev_trail = ctz64(prev_xor);
    p.ctrl = 2;
    p.payload_len = 64 - clz64(prev_xor) - prev_trail;
    p.trail = prev_trail;
  } else {
    const int u_lead = field_at(x, 2, 6);
    const int u_mlen = field_at(x, 8, 6) + 1;
    p.ctrl = 14;
    p.payload_len = u_mlen;
    p.trail = 64 - u_lead - u_mlen;
  }
}

// Value-record control bits (_plan_value).  c holds the 32 bits at the
// record; the longest control run is 16 bits (an int update: 3 + 8 + 4 + 1),
// so no field reaches past it.
__device__ __forceinline__ Plan plan_value(uint32_t c, const State& st, bool int_optimized) {
  Plan p;
  p.ctrl = 0;
  p.payload_len = 0;
  p.trail = 0;
  p.new_sig = st.sig;
  p.new_mult = st.mult;
  p.full_float = p.int_active = p.xor_active = p.xor_zero = p.add = false;
  p.sig_mult_active = false;
  p.set_float = st.is_float;
  if (!int_optimized) {
    p.set_float = true;
    if (!st.started) {
      p.payload_len = 64;
      p.full_float = true;
    } else {
      parse_xor(c, st.prev_xor, p);
      p.xor_active = true;
    }
    return p;
  }
  if (!st.started) {  // mode bit, then raw float or sig/mult + diff (iterator.go:88-106)
    if (bit_at(c, 0)) {
      p.ctrl = 1;
      p.payload_len = 64;
      p.full_float = true;
      p.set_float = true;
    } else {
      parse_sig_mult(c, 1, st, p);
      p.payload_len = p.new_sig;
      p.int_active = true;
      p.sig_mult_active = true;
      p.set_float = false;
    }
    return p;
  }
  // next value, int-optimized (iterator.go:108-143)
  if (!bit_at(c, 0)) {  // opcodeUpdate
    if (bit_at(c, 1)) {  // repeat: nothing changes
      p.ctrl = 2;
    } else if (bit_at(c, 2)) {  // switch to float
      p.ctrl = 3;
      p.payload_len = 64;
      p.full_float = true;
      p.set_float = true;
    } else {  // int state update
      parse_sig_mult(c, 3, st, p);
      p.payload_len = p.new_sig;
      p.int_active = true;
      p.sig_mult_active = true;
      p.set_float = false;
    }
  } else if (st.is_float) {  // XOR record after the no-update bit
    parse_xor(c << 1, st.prev_xor, p);
    p.ctrl += 1;
    p.xor_active = true;
  } else {  // int diff with the tracked sig
    p.ctrl = 2;
    p.payload_len = st.sig;
    p.int_active = true;
    p.add = bit_at(c, 1);
  }
  return p;
}

// The value: a float's bits, or the int over 10^mult, correctly rounded as
// the reference's int_val / MULT_DIVISORS[m]; at mult 0 the divisor is 1.0
// and the quotient the int itself, exactly, so no division is made.
__device__ __forceinline__ double emit_value(const State& st, const Divisors& div) {
  if (st.is_float) return __longlong_as_double((long long)st.prev_float);
  const int m = st.mult < 0 ? 0 : (st.mult > kMaxMult ? kMaxMult : st.mult);
  return m == 0 ? (double)st.int_val : (double)st.int_val / div.d[m];
}

// K1: decode one datapoint of one lane.  Returns `valid`.  A lane that is
// done or in error keeps its state unchanged, exactly as the masked JAX
// step leaves it, so it returns at once.
//
// The window's 32-bit words at the cursor (bit 0 = the cursor) come from
// the reader's registers: window word j = __funnelshift_l(w[j+1], w[j], off)
// with off = cursor & 31 (the JAX kernel's _window128, 128 bits from five
// words).  The timestamp header and dod read window word 0 (the 32-bit dod
// also word 1), the value's control bits the 32 bits at t_len, and the
// payload the <= 64 bits at t_len + ctrl: a record is at most 116 bits, so
// no read passes window word 3.
__device__ __forceinline__ bool decode_step(const uint32_t* row, int W, int32_t nbits, State& st,
                                            bool int_optimized, int64_t unit_nanos) {
  if (st.done || st.error) return false;
  const int base = st.cursor >> 5;
  const int off = st.cursor & 31;
  const uint32_t h0 = __funnelshift_l(st.w1, st.w0, off);
  const uint32_t h1 = __funnelshift_l(st.w2, st.w1, off);

  // delta-of-delta timestamp with marker look-ahead (timestamp_iterator.go:136-284)
  if ((h0 >> 23) == 0x100u) {  // the 9-bit marker opcode
    if (((h0 >> 21) & 3u) == 0) st.done = true;  // end of stream
    else st.error = true;                        // annotation or time-unit marker
    return false;
  }
  const int lead_ones = __clz(~h0);
  int32_t dod;
  int t_len;
  switch (lead_ones) {
    case 0: dod = 0; t_len = 1; break;
    case 1: dod = (int32_t)(h0 << 2) >> 25; t_len = 9; break;
    case 2: dod = (int32_t)(h0 << 3) >> 23; t_len = 12; break;
    case 3: dod = (int32_t)(h0 << 4) >> 20; t_len = 16; break;
    default: dod = (int32_t)__funnelshift_l(h1, h0, 4); t_len = 36; break;
  }
  if (dod != 0) st.prev_delta = wadd(st.prev_delta, wmul(dod, unit_nanos));
  st.prev_time = wadd(st.prev_time, st.prev_delta);

  const uint32_t h2 = __funnelshift_l(st.w3, st.w2, off);
  const uint32_t c = t_len < 32 ? __funnelshift_l(h1, h0, t_len) : __funnelshift_l(h2, h1, t_len);
  const Plan p = plan_value(c, st, int_optimized);
  // the payload: the top payload_len (<= 64) bits of the 64 at skip
  const int skip = t_len + p.ctrl;  // 1 .. 52
  uint64_t payload = 0;
  if (p.payload_len > 0) {
    const bool far = skip >= 32;
    const uint32_t x0 = far ? h1 : h0, x1 = far ? h2 : h1;
    const uint32_t m0 = __funnelshift_l(x1, x0, skip);
    if (p.payload_len <= 32) {
      payload = m0 >> (32 - p.payload_len);
    } else {
      const uint32_t x2 = far ? __funnelshift_l(st.w4, st.w3, off) : h2;
      const uint32_t m1 = __funnelshift_l(x2, x1, skip);
      payload = ((uint64_t)m0 << (p.payload_len - 32)) | ((uint64_t)m1 >> (64 - p.payload_len));
    }
  }

  // _apply_value
  if (p.int_active) {
    const int64_t diff = (int64_t)payload;
    st.int_val = wadd(st.int_val, p.add ? diff : (int64_t)(0ull - (uint64_t)diff));
  }
  if (p.full_float) {
    st.prev_float = payload;
    st.prev_xor = payload;
  } else if (p.xor_active) {
    const uint64_t x = p.xor_zero ? 0ull : shl(payload, p.trail > 0 ? p.trail : 0);
    st.prev_float ^= x;
    st.prev_xor = x;
  }
  if (p.sig_mult_active) {
    st.sig = p.new_sig;
    st.mult = p.new_mult;
  }
  st.is_float = p.set_float;
  st.cursor += t_len + p.ctrl + p.payload_len;
  st.started = true;
  if (st.cursor > nbits) {  // not done here: done only on EOS
    st.error = true;
    return false;
  }
  // refill: one word a word crossed (at most 4: off + 116 bits)
  for (int next = base + 5; next < (st.cursor >> 5) + 5; ++next) {
    st.w0 = st.w1;
    st.w1 = st.w2;
    st.w2 = st.w3;
    st.w3 = st.w4;
    st.w4 = load_word(row, W, next);
  }
  return true;
}

// IEEE-754 minimum/maximum on non-NaN operands: -0.0 orders below +0.0,
// as XLA's min/max (and so jnp.minimum/jnp.maximum) do.
__device__ __forceinline__ double min_ieee(double a, double b) {
  if (a < b) return a;
  if (b < a) return b;
  return signbit(a) ? a : b;
}
__device__ __forceinline__ double max_ieee(double a, double b) {
  if (a > b) return a;
  if (b > a) return b;
  return signbit(a) ? b : a;
}

// The staged kernels (K2, K3, T1) share one way of storing: a thread
// walks its own lane, but a thread storing its result cells at lane * n + i
// touches one 32-byte sector per lane and fills 8 bytes of it, so a warp's
// store is 32 partly written sectors, and at 1M lanes the open sectors do not
// fit in L2.  Instead each warp stages a few cells of its 32 lanes in shared
// memory ([cell][lane], rows padded to kPad elements: conflict-free both
// ways), then writes each lane's cells as one contiguous run, a whole warp on
// neighbouring addresses: whole sectors, but where a run's two ends are not
// sector-aligned, which the neighbouring runs of the same warp complete.  The
// staged width trades the tile's shared memory against the warps an SM
// holds: the state machine is latency-bound and wants them.
constexpr int kPad = 33;  // the staged rows' stride in elements

// K2: decode `window` datapoints per window inline and write only the
// per-window accumulators, [L, n_win] each.  Windows are fixed counts of
// points, so every lane of a warp closes window w at the same step and the
// loop over windows is warp-uniform: the warp stages a few windows of its
// lanes (sum and count, 12 bytes a cell, the count as int32: at most
// `window`; with full_agg also sum_sq, min, max and last, 44 bytes), then
// writes each lane's windows of each field as one run.  The tiles are
// static shared memory, at most 48 KB a block.  Widths as measured on an
// H100 (PERF.md): the MEAN form at 4 windows (6,336 bytes a block, 9 blocks
// an SM by its registers) ran 8% faster than at 8; full_agg at 8 (46,464
// bytes, 4 blocks an SM) 5% faster than at 4.
constexpr int kK2Windows = 4;      // MEAN form
constexpr int kK2FullWindows = 8;  // full_agg form
// The MEAN form's registers are capped for 9 blocks an SM (56 a thread):
// uncapped, the word reader took it to 59 and 8 blocks, 4% slower on an H100
// (PERF.md).  full_agg's tiles allow 4 blocks whatever its registers.
constexpr int kK2BlocksPerSM = 9;
static_assert(kK2Windows >= 1 && kK2FullWindows >= 1 &&
                  kK2FullWindows * kPad * 44 * (kThreads / 32) <= 48 * 1024,
              "K2's full_agg tiles must fit static shared memory");

template <bool kFull>
__global__ void __launch_bounds__(kThreads, kFull ? 1 : kK2BlocksPerSM) decode_downsample_fused_kernel(
    const uint32_t* __restrict__ words, const int32_t* __restrict__ nbits, int L, int W,
    int n_win, int window, bool int_optimized, int64_t unit_nanos, Divisors div,
    double* __restrict__ sum, int64_t* __restrict__ count, double* __restrict__ sum_sq,
    double* __restrict__ vmin_out, double* __restrict__ vmax_out, double* __restrict__ last_out,
    int32_t* __restrict__ total, bool* __restrict__ error) {
  constexpr int kFields = kFull ? 5 : 1;  // staged f64 fields: sum (sum_sq, min, max, last)
  constexpr int kW = kFull ? kK2FullWindows : kK2Windows;
  __shared__ double tile_f[kThreads / 32][kFields][kW * kPad];
  __shared__ int32_t tile_n[kThreads / 32][kW * kPad];
  const int warp = threadIdx.x >> 5, col = threadIdx.x & 31;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int first = lane - col;  // the warp's first lane
  if (first >= L) return;        // warp-uniform: the warp writes its tiles together
  const int n_lanes = L - first < 32 ? L - first : 32;
  const bool mine = lane < L;
  const uint32_t* row = words + (size_t)(mine ? lane : first) * W;
  const int32_t nb = mine ? nbits[lane] : 0;  // a lane past L is done at once
  State st = init_state(row, W, nb);
  double(*sf)[kW * kPad] = tile_f[warp];
  int32_t* sn = tile_n[warp];
  int64_t tot = 0;
  for (int w0 = 0; w0 < n_win; w0 += kW) {
    const int nw = n_win - w0 < kW ? n_win - w0 : kW;
    for (int j = 0; j < nw; ++j) {
      double s = 0.0, ssq = 0.0, mn = INFINITY, mx = -INFINITY, last = NAN;
      bool has_last = false;
      int32_t cnt = 0;
      for (int k = 0; k < window; ++k) {
        const bool valid = decode_step(row, W, nb, st, int_optimized, unit_nanos);
        if (!valid) continue;  // adds +0.0 and 0 in the reference: no change
        const double v = emit_value(st, div);
        const bool contrib = !isnan(v);
        const double vz = contrib ? v : 0.0;
        s = __dadd_rn(s, vz);
        cnt += 1;
        if constexpr (kFull) {
          ssq = __dadd_rn(ssq, __dmul_rn(vz, vz));
          if (contrib) {
            mn = min_ieee(mn, v);
            mx = max_ieee(mx, v);
          }
          last = v;
          has_last = true;
        }
      }
      const int c = j * kPad + col;
      sf[0][c] = s;
      sn[c] = cnt;
      if constexpr (kFull) {
        const bool any_c = mn != INFINITY;
        sf[1][c] = ssq;
        sf[2][c] = any_c ? mn : NAN;
        sf[3][c] = any_c ? mx : NAN;
        sf[4][c] = has_last ? last : NAN;
      }
      tot += cnt;
    }
    __syncwarp();
    // lane l's windows w0 .. w0 + nw - 1, contiguous at l * n_win + w0
    const int cells = n_lanes * nw;
    for (int i = col; i < cells; i += 32) {
      const int l = nw == kW ? i / kW : i / nw;
      const int j = i - l * nw;
      const int c = j * kPad + l;
      const size_t o = (size_t)(first + l) * n_win + w0 + j;
      sum[o] = sf[0][c];
      count[o] = sn[c];
      if constexpr (kFull) {
        sum_sq[o] = sf[1][c];
        vmin_out[o] = sf[2][c];
        vmax_out[o] = sf[3][c];
        last_out[o] = sf[4][c];
      }
    }
    __syncwarp();  // the tile is restaged by the next windows
  }
  if (!mine) return;
  total[lane] = (int32_t)tot;
  error[lane] = st.error;
}

// K3: decode up to n_steps datapoints per lane into [L, n_steps] grids.
// scan_len == n_steps + 1 with flag_truncation: the extra step lets a
// stream holding exactly n_steps records reach its EOS marker.  Each warp
// stages kK3Steps steps of its 32 lanes, then writes each lane's steps as
// one run (128 bytes of ts and of vs, a lane's run of valid bytes): ~8.4 KB
// of tiles a warp, static shared memory, 17 bytes a step and lane.
constexpr int kK3Steps = 16;
static_assert(kK3Steps >= 1 && kK3Steps <= 16, "a tile holds 1-16 steps");

__global__ void __launch_bounds__(kThreads) decode_batched_kernel(
    const uint32_t* __restrict__ words, const int32_t* __restrict__ nbits, int L, int W,
    int n_steps, int scan_len, bool int_optimized, int64_t unit_nanos, bool flag_truncation,
    Divisors div, int64_t* __restrict__ ts, double* __restrict__ vs, bool* __restrict__ valid,
    int32_t* __restrict__ count, bool* __restrict__ error) {
  __shared__ int64_t tile_ts[kThreads / 32][kK3Steps * kPad];
  __shared__ double tile_vs[kThreads / 32][kK3Steps * kPad];
  __shared__ bool tile_ok[kThreads / 32][kK3Steps * kPad];
  const int warp = threadIdx.x >> 5, col = threadIdx.x & 31;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int first = lane - col;  // the warp's first lane
  if (first >= L) return;        // warp-uniform: the warp writes its tiles together
  const int n_lanes = L - first < 32 ? L - first : 32;
  const bool mine = lane < L;
  const uint32_t* row = words + (size_t)(mine ? lane : first) * W;
  const int32_t nb = mine ? nbits[lane] : 0;  // a lane past L is done at once
  State st = init_state(row, W, nb);
  int64_t* sts = tile_ts[warp];
  double* svs = tile_vs[warp];
  bool* sok = tile_ok[warp];
  int32_t cnt = 0;
  for (int t0 = 0; t0 < scan_len; t0 += kK3Steps) {
    const int nt = n_steps - t0 < kK3Steps ? n_steps - t0 : kK3Steps;  // steps of the tile to write
    const int nd = scan_len - t0 < kK3Steps ? scan_len - t0 : kK3Steps;
    for (int j = 0; j < nd; ++j) {
      const bool ok = decode_step(row, W, nb, st, int_optimized, unit_nanos);
      if (j < nt) {
        sts[j * kPad + col] = st.prev_time;
        svs[j * kPad + col] = emit_value(st, div);
        sok[j * kPad + col] = ok;
        cnt += ok;
      }
    }
    if (nt <= 0) break;  // the truncation step alone
    __syncwarp();
    // lane l's steps t0 .. t0 + nt - 1, contiguous at l * n_steps + t0
    const int total = n_lanes * nt;
    for (int i = col; i < total; i += 32) {
      const int l = nt == kK3Steps ? i / kK3Steps : i / nt;
      const int j = i - l * nt;
      const size_t o = (size_t)(first + l) * n_steps + t0 + j;
      ts[o] = sts[j * kPad + l];
      vs[o] = svs[j * kPad + l];
      valid[o] = sok[j * kPad + l];
    }
    __syncwarp();  // the tile is restaged by the next steps
  }
  if (!mine) return;
  count[lane] = cnt;
  error[lane] = st.error || (flag_truncation && !st.done);
}

// T1: a tile's six accumulators, in registers while the lane is in it.
struct Tile {
  double sum, sum_sq, vmin, vmax, last;
  int64_t count, last_t;
  bool has_last;
};

__device__ __forceinline__ Tile empty_tile() {
  Tile a;
  a.sum = 0.0;
  a.sum_sq = 0.0;
  a.vmin = INFINITY;
  a.vmax = -INFINITY;
  a.last = NAN;
  a.count = 0;
  a.last_t = 0;
  a.has_last = false;
  return a;
}

// One in-range point, as the reference's scatters take it: count every
// point; sum, sum_sq, min and max only non-NaN values (in stream order,
// min/max with -0.0 below +0.0); last = the value at the greatest
// timestamp, the last such point in stream order (XLA:CPU's scatter
// `.set` keeps the last of duplicate indices).
__device__ __forceinline__ void tile_add(Tile& a, int64_t t, double v) {
  a.count += 1;
  if (!isnan(v)) {
    a.sum = __dadd_rn(a.sum, v);
    a.sum_sq = __dadd_rn(a.sum_sq, __dmul_rn(v, v));
    a.vmin = min_ieee(a.vmin, v);
    a.vmax = max_ieee(a.vmax, v);
  }
  if (!a.has_last || t >= a.last_t) {
    a.last_t = t;
    a.last = v;
    a.has_last = true;
  }
}

// A min or max that is +-Inf (no contribution, or a real +-Inf sample)
// comes out NaN, as the reference's final where(isinf(..)) has it.
__device__ __forceinline__ void tile_store(const Tile& a, size_t o, double* sum,
                                           double* sum_sq, int64_t* count, double* vmin,
                                           double* vmax, double* last) {
  sum[o] = a.sum;
  sum_sq[o] = a.sum_sq;
  count[o] = a.count;
  vmin[o] = isinf(a.vmin) ? NAN : a.vmin;
  vmax[o] = isinf(a.vmax) ? NAN : a.vmax;
  last[o] = a.last;
}

// T1's staged group: 4 tiles of a warp's 32 lanes, 44 bytes a cell, 23,232
// bytes of static shared memory a block of 4 warps.  The decode is latency-
// bound, so resident warps set T1's rate: 8 tiles (46,464 bytes) allow 4
// blocks an SM and ran 1.3x slower at 5m tiles on an H100 (PERF.md); at 4
// tiles the kernel's registers are capped for 6 blocks (80, no spill).
constexpr int kT1Tiles = 4;
constexpr int kT1BlocksPerSM = 6;
static_assert(kT1Tiles >= 1 && kT1Tiles * kPad * 44 * (kThreads / 32) <= 48 * 1024,
              "T1's tiles must fit static shared memory");

// The same, finalised into a warp's staged tile: cell c of each field row
// (sum, sum_sq, min, max, last; the count as int32, at most n_steps).
__device__ __forceinline__ void tile_stage(const Tile& a, int c, double (*f)[kT1Tiles * kPad],
                                           int32_t* n) {
  f[0][c] = a.sum;
  f[1][c] = a.sum_sq;
  f[2][c] = isinf(a.vmin) ? NAN : a.vmin;
  f[3][c] = isinf(a.vmax) ? NAN : a.vmax;
  f[4][c] = a.last;
  n[c] = (int32_t)a.count;
}

// Tile index of a point, or -1 when it falls outside [0, n_tiles): the
// floor of d / tile_nanos, d = t - block_start on wrapping int64, as jnp's `//`.
__device__ __forceinline__ int64_t offset_of(int64_t t, int64_t block_start) {
  return (int64_t)((uint64_t)t - (uint64_t)block_start);
}
__device__ __forceinline__ int tile_at(int64_t d, int64_t tile_nanos, int n_tiles) {
  int64_t q = d / tile_nanos;  // truncates toward zero
  if (d % tile_nanos != 0 && d < 0) q -= 1;
  return (q >= 0 && q < n_tiles) ? (int)q : -1;
}
__device__ __forceinline__ int tile_of(int64_t t, int64_t block_start, int64_t tile_nanos,
                                       int n_tiles) {
  return tile_at(offset_of(t, block_start), tile_nanos, n_tiles);
}

// T1: decode up to n_steps points of a lane and reduce them into its
// tiles.  One thread per lane walks its stream once, keeping the current
// tile in registers.  Lanes leave tiles at data-dependent steps, so the unit
// a warp stages is a group of kT1Tiles tiles, and the loop over groups is
// warp-uniform: in group g a thread walks until its next in-range point
// lands at or past the group's end (that point waits in registers, decoded
// once, and opens its tile when its group does), its stream ends, or its
// tile index goes backwards.  Each tile it closes or skips goes into the
// warp's staged group (skipped tiles stay empty); then the warp writes each
// lane's tiles of the group as runs, as K2 does.
//
// A stream whose tile index goes backwards (timestamps out of order across
// tiles) cannot be reduced that way without reloading a closed tile's
// running state, which the outputs do not keep (min/max are finalised, the
// last timestamp is not stored); such a lane stops walking, still takes part
// in the group loop (its staged cells are overwritten), and after the loop
// is redone tile by tile: one walk per tile it touches, each accumulating
// only that tile's points in stream order and finding the next tile, storing
// directly.  The warp's staged writes of its row were made by other threads;
// the __syncwarp that ends the group loop orders them before these.  Both
// orders add a tile's points in stream order, so the sums are the
// reference's sequential scatter-add bit for bit.
__global__ void __launch_bounds__(kThreads, kT1BlocksPerSM) aggregate_tiles_kernel(
    const uint32_t* __restrict__ words, const int32_t* __restrict__ nbits, int L, int W,
    int n_steps, int n_tiles, long long tile_nanos, long long block_start, bool int_optimized,
    int64_t unit_nanos, Divisors div, double* __restrict__ sum, double* __restrict__ sum_sq,
    int64_t* __restrict__ count, double* __restrict__ vmin, double* __restrict__ vmax,
    double* __restrict__ last, int32_t* __restrict__ decoded, bool* __restrict__ error) {
  __shared__ double tile_f[kThreads / 32][5][kT1Tiles * kPad];
  __shared__ int32_t tile_n[kThreads / 32][kT1Tiles * kPad];
  const int warp = threadIdx.x >> 5, col = threadIdx.x & 31;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int first = lane - col;  // the warp's first lane
  if (first >= L) return;        // warp-uniform: the warp writes its groups together
  const int n_lanes = L - first < 32 ? L - first : 32;
  const bool mine = lane < L;
  const uint32_t* row = words + (size_t)(mine ? lane : first) * W;
  const int32_t nb = mine ? nbits[lane] : 0;  // a lane past L is done at once
  const size_t base = (size_t)lane * n_tiles;
  double(*sf)[kT1Tiles * kPad] = tile_f[warp];
  int32_t* sn = tile_n[warp];
  const Tile none = empty_tile();

  State st = init_state(row, W, nb);
  Tile a = none;
  int cur = -1;  // the last in-range tile seen; `a` holds it while it is in the group
  // cur's first offset: a point with lo <= d < lo + tile_nanos is in cur,
  // one below lo + 2 * tile_nanos in the next tile, with no 64-bit division
  // (lo = cur * tile_nanos <= d cannot overflow); skipping the division
  // inside a tile took T1 at 5m tiles from 14.0 to 10.5 ms on an H100
  // (PERF.md)
  int64_t lo = 0;
  int32_t cnt = 0;  // steps decoded
  bool ended = false, backwards = false, pending = false;
  int64_t pt = 0;  // the pending point: time, value, tile
  double pv = 0.0;
  int pk = 0;
  // one group at least: with no tiles the walk still counts the points
  const int n_groups = n_tiles > kT1Tiles ? (n_tiles + kT1Tiles - 1) / kT1Tiles : 1;
  for (int g0 = 0; g0 < n_groups * kT1Tiles; g0 += kT1Tiles) {
    const int nt = n_tiles - g0 < kT1Tiles ? n_tiles - g0 : kT1Tiles;  // tiles of the group
    const int g1 = g0 + nt;
    for (int j = 0; j < nt; ++j) tile_stage(none, j * kPad + col, sf, sn);
    if (pending && pk < g1) {  // pk >= g0: it was at or past the last group's end
      cur = pk;
      lo = (int64_t)cur * tile_nanos;
      a = none;
      tile_add(a, pt, pv);
      pending = false;
    }
    while (!ended && !pending && !backwards) {
      if (cnt == n_steps || !decode_step(row, W, nb, st, int_optimized, unit_nanos)) {
        ended = true;  // n_steps reached, done or error: for good
        break;
      }
      ++cnt;
      const int64_t t = st.prev_time;
      const int64_t d = offset_of(t, block_start);
      // cur itself, or the tile after it (a lane's usual next tile), with no
      // 64-bit division: lo <= d < lo + 2 * tile_nanos, lo = cur * tile_nanos
      const uint64_t into = (uint64_t)d - (uint64_t)lo;
      const bool near = cur >= 0 && d >= lo && into < 2 * (uint64_t)tile_nanos;
      const int k = !near ? tile_at(d, tile_nanos, n_tiles)
                          : into < (uint64_t)tile_nanos ? cur : (cur + 1 < n_tiles ? cur + 1 : -1);
      if (k < 0) continue;
      if (k != cur) {
        if (k < cur) {
          backwards = true;
          break;
        }
        if (k >= g1) {
          pending = true;
          pt = t;
          pv = emit_value(st, div);
          pk = k;
          break;
        }
        if (cur >= g0) tile_stage(a, (cur - g0) * kPad + col, sf, sn);
        cur = k;
        lo = (int64_t)cur * tile_nanos;
        a = none;
      }
      tile_add(a, t, emit_value(st, div));
    }
    if (cur >= g0 && !backwards) tile_stage(a, (cur - g0) * kPad + col, sf, sn);
    __syncwarp();
    // lane l's tiles g0 .. g1 - 1, contiguous at l * n_tiles + g0
    const int cells = n_lanes * nt;
    for (int i = col; i < cells; i += 32) {
      const int l = nt == kT1Tiles ? i / kT1Tiles : i / nt;
      const int j = i - l * nt;
      const int c = j * kPad + l;
      const size_t o = (size_t)(first + l) * n_tiles + g0 + j;
      sum[o] = sf[0][c];
      sum_sq[o] = sf[1][c];
      count[o] = sn[c];
      vmin[o] = sf[2][c];
      vmax[o] = sf[3][c];
      last[o] = sf[4][c];
    }
    __syncwarp();  // the group is restaged next, and orders the slow path's stores
  }
  if (!mine) return;
  if (!backwards) {
    decoded[lane] = cnt;
    error[lane] = st.error;
    return;
  }

  // tile-by-tile walks: `target` = the tile accumulated in this walk (-1:
  // none, the first walk only finds the lowest tile), `next` = the lowest
  // tile above it that the stream touches
  int target = -1, stored = 0;  // tiles [0, stored) are written
  while (true) {
    st = init_state(row, W, nb);
    a = none;
    cnt = 0;
    int next = n_tiles;
    for (int step = 0; step < n_steps; ++step) {
      if (!decode_step(row, W, nb, st, int_optimized, unit_nanos)) break;
      ++cnt;
      const int64_t t = st.prev_time;
      const int k = tile_of(t, block_start, tile_nanos, n_tiles);
      if (k < 0) continue;
      if (k == target) tile_add(a, t, emit_value(st, div));
      else if (k > target && k < next) next = k;
    }
    if (target >= 0) {
      tile_store(a, base + target, sum, sum_sq, count, vmin, vmax, last);
      stored = target + 1;
    }
    for (int e = stored; e < next; ++e) tile_store(none, base + e, sum, sum_sq, count, vmin, vmax, last);
    stored = next;
    if (next >= n_tiles) break;
    target = next;
  }
  decoded[lane] = cnt;
  error[lane] = st.error;
}

inline Divisors load_divisors(const double* host) {
  Divisors d;
  for (int i = 0; i <= kMaxMult; ++i) d.d[i] = host[i];
  return d;
}

inline int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError().
int m3_decode_downsample_fused(const uint32_t* words, const int32_t* nbits, int L, int W,
                               int n_win, int window, int int_optimized, long long unit_nanos,
                               int full_agg, const double* divisors_host, double* sum,
                               int64_t* count, double* sum_sq, double* vmin, double* vmax,
                               double* last, int32_t* total, bool* error, void* stream) {
  auto kernel = full_agg ? decode_downsample_fused_kernel<true>
                         : decode_downsample_fused_kernel<false>;
  kernel<<<blocks_for(L), kThreads, 0, (cudaStream_t)stream>>>(
      words, nbits, L, W, n_win, window, int_optimized != 0, unit_nanos,
      load_divisors(divisors_host), sum, count, sum_sq, vmin, vmax, last, total, error);
  return (int)cudaGetLastError();
}

int m3_decode_batched(const uint32_t* words, const int32_t* nbits, int L, int W, int n_steps,
                      int scan_len, int int_optimized, long long unit_nanos, int flag_truncation,
                      const double* divisors_host, int64_t* ts, double* vs, bool* valid,
                      int32_t* count, bool* error, void* stream) {
  decode_batched_kernel<<<blocks_for(L), kThreads, 0, (cudaStream_t)stream>>>(
      words, nbits, L, W, n_steps, scan_len, int_optimized != 0, unit_nanos,
      flag_truncation != 0, load_divisors(divisors_host), ts, vs, valid, count, error);
  return (int)cudaGetLastError();
}

int m3_aggregate_tiles(const uint32_t* words, const int32_t* nbits, int L, int W, int n_steps,
                       int n_tiles, long long tile_nanos, long long block_start,
                       int int_optimized, long long unit_nanos, const double* divisors_host,
                       double* sum, double* sum_sq, int64_t* count, double* vmin, double* vmax,
                       double* last, int32_t* decoded, bool* error, void* stream) {
  aggregate_tiles_kernel<<<blocks_for(L), kThreads, 0, (cudaStream_t)stream>>>(
      words, nbits, L, W, n_steps, n_tiles, tile_nanos, block_start, int_optimized != 0,
      unit_nanos, load_divisors(divisors_host), sum, sum_sq, count, vmin, vmax, last, decoded,
      error);
  return (int)cudaGetLastError();
}

// How a staged kernel sits on the card: kernel 0 K2, 1 K2 full_agg, 2 K3,
// 3 T1.  out = {staged width (windows, steps or tiles), static shared bytes
// a block, resident blocks per SM, registers a thread, threads a block}.
int m3_decode_layout(int kernel, int* out) {
  const void* fn;
  int width;
  switch (kernel) {
    case 0: fn = (const void*)decode_downsample_fused_kernel<false>; width = kK2Windows; break;
    case 1: fn = (const void*)decode_downsample_fused_kernel<true>; width = kK2FullWindows; break;
    case 2: fn = (const void*)decode_batched_kernel; width = kK3Steps; break;
    case 3: fn = (const void*)aggregate_tiles_kernel; width = kT1Tiles; break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, fn);
  int blocks = 0;
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, 0);
  if (rc != cudaSuccess) return (int)rc;
  out[0] = width;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = blocks;
  out[3] = attr.numRegs;
  out[4] = kThreads;
  return 0;
}

const char* m3_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
