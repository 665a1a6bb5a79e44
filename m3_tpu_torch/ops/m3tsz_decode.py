"""Batched M3TSZ decode: CUDA kernels and their plain PyTorch versions.

Port of ``m3_tpu/ops/m3tsz_decode.py``.  L series decode one datapoint per
step; the per-lane decoder state is the same ~12 integer registers the
reference iterator keeps (``DecodeState``).

- On a CUDA tensor, ``decode_batched`` and ``decode_downsample_fused``
  launch the hand-written kernels of ``csrc/m3tsz_decode.cu`` (one thread
  per lane, the state in registers, the step as a ``__device__``
  function).  They raise if the kernel cannot be built or launched.
- On a CPU tensor they run the plain versions below: the reference's
  branchless state machine step for step, on ``int64`` bit patterns
  (PyTorch has no ``uint64`` shifts on the CPU), looping over steps in
  Python.  The tests hold these against the JAX package, and the chip
  smoke test holds the kernels against these on the card.

The host entries ``decode_streams`` (one width), ``decode_streams_adaptive``
(the width sized by the native count pass) and ``decode_streams_merged``
(the native fused decode + merge of the warm read path, host only) keep
the reference's contracts.

Constructs that cannot appear in sealed numeric blocks written with a
fixed time unit — annotations, mid-stream time-unit changes — set a
per-lane ``error`` flag; ``decode_streams`` re-decodes those lanes with the
scalar oracle so behavior stays total.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from m3_tpu_torch.ops import _build, decode_counter, m3tsz_scalar
from m3_tpu_torch.ops.bitstream import (
    I32,
    I64,
    clz64,
    ctz64,
    pack_streams,
    srl,
    take_top,
)
from m3_tpu_torch.utils import xtime
from m3_tpu_torch.utils.device import resolve_device

MULT_DIVISORS = np.array([10.0**i for i in range(m3tsz_scalar.MAX_MULT + 1)])

F64 = torch.float64
BOOL = torch.bool


class DecodeState(NamedTuple):
    cursor: torch.Tensor  # i32[L] bit position
    started: torch.Tensor  # bool[L] first datapoint consumed
    done: torch.Tensor  # bool[L] saw end-of-stream
    error: torch.Tensor  # bool[L] unsupported construct / corrupt
    prev_time: torch.Tensor  # i64[L] unix nanos
    prev_delta: torch.Tensor  # i64[L] nanos
    prev_float: torch.Tensor  # i64[L] float64 bit pattern
    prev_xor: torch.Tensor  # i64[L] 64-bit pattern
    int_val: torch.Tensor  # i64[L]
    sig: torch.Tensor  # i32[L]
    mult: torch.Tensor  # i32[L]
    is_float: torch.Tensor  # bool[L]


class ValuePlan(NamedTuple):
    """Geometry + routing of one value record, before its payload is read
    (small integers are int64 here)."""

    ctrl: torch.Tensor  # control bits (incl. sign bit for int diffs)
    payload_len: torch.Tensor
    full_float: torch.Tensor  # bool: payload is a raw 64-bit float
    int_active: torch.Tensor  # bool: payload is an int diff
    xor_active: torch.Tensor  # bool: payload is XOR meaningful bits
    xor_zero: torch.Tensor  # bool: XOR == 0 record
    add: torch.Tensor  # bool: int diff sign (True = add)
    trail: torch.Tensor  # XOR trailing-zero shift
    new_sig: torch.Tensor
    new_mult: torch.Tensor
    set_float: torch.Tensor  # bool: is_float after this record
    sig_mult_active: torch.Tensor  # bool: commit new_sig/new_mult


# --- the plain version of the step (K1) ---------------------------------


def _bit_at(win: torch.Tensor, pos) -> torch.Tensor:
    """Bit at per-lane position `pos` (0 = MSB) of each 64-bit window."""
    return ((win >> (63 - pos)) & 1).to(BOOL)


def _field_at(win: torch.Tensor, pos, width: int) -> torch.Tensor:
    """`width` bits starting at per-lane position `pos` (0 = MSB)."""
    return (win >> (64 - width - pos)) & ((1 << width) - 1)


def _sext(win: torch.Tensor, skip: int, nbits: int) -> torch.Tensor:
    """Sign-extended nbits field after `skip` bits from the window top."""
    return (win << skip) >> (64 - nbits)


def _window128(words64: torch.Tensor, cursor: torch.Tensor):
    """(hi, lo) 64-bit pair: 128 stream bits starting at each lane's cursor.

    Reads the five words from the cursor's base word; words past the end of
    the row read as zero, as the reference's one-hot row-sum does."""
    W = words64.shape[1]
    base = (cursor >> 5).to(I64)
    off = (cursor & 31).to(I64)
    idx = base[:, None] + torch.arange(5, device=cursor.device)[None, :]
    inb = (idx >= 0) & (idx < W)
    g = torch.gather(words64, 1, idx.clamp(0, max(W - 1, 0)))
    g = torch.where(inb, g, 0)
    w01 = (g[:, 0] << 32) | g[:, 1]
    w23 = (g[:, 2] << 32) | g[:, 3]
    w45 = g[:, 4] << 32
    aligned = off == 0
    inv = 64 - torch.where(aligned, 1, off)  # dodge shift-by-64
    hi = torch.where(aligned, w01, (w01 << off) | srl(w23, inv))
    lo = torch.where(aligned, w23, (w23 << off) | srl(w45, inv))
    return hi, lo


def _mid_window(hi, lo, skip):
    """64 bits starting `skip` (1..63) bits into the 128-bit (hi, lo) pair."""
    s = skip.to(I64)
    safe = torch.where(s == 0, 1, s)
    return torch.where(s == 0, hi, (hi << safe) | srl(lo, 64 - safe))


def _parse_timestamp(hi, st: DecodeState, unit_nanos: int):
    """One delta-of-delta timestamp record incl. marker look-ahead.

    Returns (new_time, new_delta, consumed_bits, eos, bad_marker).
    Grammar: docs/m3tsz_format.md; ref: timestamp_iterator.go:136-284.
    """
    is_marker = srl(hi, 55) == 0x100
    marker_val = (hi >> 53) & 3
    eos = is_marker & (marker_val == 0)
    bad_marker = is_marker & (marker_val != 0)

    lead_ones = clz64(~hi)
    dod_units = torch.where(
        lead_ones == 0, 0,
        torch.where(lead_ones == 1, _sext(hi, 2, 7),
                    torch.where(lead_ones == 2, _sext(hi, 3, 9),
                                torch.where(lead_ones == 3, _sext(hi, 4, 12),
                                            _sext(hi, 4, 32)))))
    consumed = torch.where(
        lead_ones == 0, 1,
        torch.where(lead_ones == 1, 9,
                    torch.where(lead_ones == 2, 12,
                                torch.where(lead_ones == 3, 16, 36))))
    dod_units = torch.where(is_marker, 0, dod_units)
    consumed = torch.where(is_marker, 0, consumed)

    new_delta = st.prev_delta + dod_units * unit_nanos
    new_time = st.prev_time + new_delta
    return new_time, new_delta, consumed, eos, bad_marker


def _parse_sig_mult(cwin, base, sig, mult):
    """sig/mult update block + sign bit (ref: iterator.go:145-168).
    Returns (new_sig, new_mult, add_flag, total_len_including_sign)."""
    s_upd = _bit_at(cwin, base)
    s_nonzero = _bit_at(cwin, base + 1)
    sig_field = _field_at(cwin, base + 2, m3tsz_scalar.NUM_SIG_BITS_FIELD)
    k = torch.where(s_upd, torch.where(s_nonzero, 8, 2), 1)
    new_sig = torch.where(s_upd, torch.where(s_nonzero, sig_field + 1, 0), sig.to(I64))
    m_upd = _bit_at(cwin, base + k)
    mult_field = _field_at(cwin, base + k + 1, m3tsz_scalar.NUM_MULT_BITS)
    m = torch.where(m_upd, 4, 1)
    new_mult = torch.where(m_upd, mult_field, mult.to(I64))
    add = _bit_at(cwin, base + k + m)
    return new_sig, new_mult, add, base + k + m + 1


def _parse_xor(xwin, prev_xor):
    """Float XOR record geometry, opcode at window bit 0.
    Returns (ctrl_len, payload_len, trail, is_zero).
    Ref: float_encoder_iterator.go:117-166."""
    x0 = _bit_at(xwin, 0)
    x1 = _bit_at(xwin, 1)
    prev_lead = clz64(prev_xor).to(I64)
    prev_trail = ctz64(prev_xor).to(I64)
    contained_len = 64 - prev_lead - prev_trail
    u_lead = _field_at(xwin, 2, 6)
    u_mlen = _field_at(xwin, 8, 6) + 1
    u_trail = 64 - u_lead - u_mlen

    is_zero = ~x0
    is_contained = x0 & ~x1
    ctrl = torch.where(is_zero, 1, torch.where(is_contained, 2, 14))
    payload = torch.where(is_zero, 0, torch.where(is_contained, contained_len, u_mlen))
    trail = torch.where(is_contained, prev_trail, u_trail)
    return ctrl, payload, trail, is_zero


def _plan_value(cwin, st: DecodeState, int_optimized: bool, first: bool) -> ValuePlan:
    """Parse a value record's control bits (cwin top-aligned at the record)."""
    zero = torch.zeros_like(cwin)
    false = torch.zeros(cwin.shape, dtype=BOOL, device=cwin.device)
    sig, mult = st.sig.to(I64), st.mult.to(I64)

    if not int_optimized:
        if first:
            return ValuePlan(
                ctrl=zero, payload_len=zero + 64, full_float=~false,
                int_active=false, xor_active=false, xor_zero=false, add=false,
                trail=zero, new_sig=sig, new_mult=mult, set_float=~false,
                sig_mult_active=false)
        ctrl_x, payload_x, trail_x, x_zero = _parse_xor(cwin, st.prev_xor)
        return ValuePlan(
            ctrl=ctrl_x, payload_len=payload_x, full_float=false,
            int_active=false, xor_active=~false, xor_zero=x_zero, add=false,
            trail=trail_x, new_sig=sig, new_mult=mult, set_float=~false,
            sig_mult_active=false)

    if first:
        # mode bit, then raw float or sig/mult + signed diff
        # (ref: iterator.go:88-106)
        mode_float = _bit_at(cwin, zero)
        sig_a, mult_a, add_a, ctrl_a = _parse_sig_mult(cwin, zero + 1, sig, mult)
        return ValuePlan(
            ctrl=torch.where(mode_float, 1, ctrl_a),
            payload_len=torch.where(mode_float, 64, sig_a),
            full_float=mode_float, int_active=~mode_float, xor_active=false,
            xor_zero=false, add=add_a, trail=zero, new_sig=sig_a,
            new_mult=mult_a, set_float=mode_float, sig_mult_active=~mode_float)

    # --- next value, int-optimized (ref: iterator.go:108-143) ---
    c_update = ~_bit_at(cwin, zero)  # bit 0 == opcodeUpdate(0)
    c_repeat = _bit_at(cwin, zero + 1)
    c_float = _bit_at(cwin, zero + 2)

    a_repeat = c_update & c_repeat
    a_float = c_update & ~c_repeat & c_float
    a_int = c_update & ~c_repeat & ~c_float
    b_float = ~c_update & st.is_float
    b_int = ~c_update & ~st.is_float

    sig_a, mult_a, add_a, ctrl_a = _parse_sig_mult(cwin, zero + 3, sig, mult)

    xwin = cwin << 1  # XOR record starts after the no-update bit
    ctrl_x, payload_x, trail_x, x_zero = _parse_xor(xwin, st.prev_xor)
    ctrl_x = ctrl_x + 1

    add_b = _bit_at(cwin, zero + 1)

    ctrl = torch.where(a_repeat, 2, torch.where(a_float, 3, torch.where(
        a_int, ctrl_a, torch.where(b_float, ctrl_x, 2))))
    payload_len = torch.where(a_repeat, 0, torch.where(a_float, 64, torch.where(
        a_int, sig_a, torch.where(b_float, payload_x, sig))))
    return ValuePlan(
        ctrl=ctrl, payload_len=payload_len, full_float=a_float,
        int_active=a_int | b_int, xor_active=b_float, xor_zero=x_zero & b_float,
        add=torch.where(a_int, add_a, add_b), trail=trail_x, new_sig=sig_a,
        new_mult=mult_a,
        set_float=torch.where(a_float, True, torch.where(a_int, False, st.is_float)),
        sig_mult_active=a_int)


def _apply_value(st: DecodeState, plan: ValuePlan, payload) -> DecodeState:
    """Commit one value record given its payload bits."""
    diff = payload
    new_int = torch.where(plan.int_active,
                     st.int_val + torch.where(plan.add, diff, -diff), st.int_val)
    xor = torch.where(plan.xor_zero, 0, payload << plan.trail.clamp(min=0))
    new_float = torch.where(plan.full_float, payload,
                       torch.where(plan.xor_active, st.prev_float ^ xor, st.prev_float))
    new_xor = torch.where(plan.full_float, payload,
                     torch.where(plan.xor_active, xor, st.prev_xor))
    return st._replace(
        prev_float=new_float,
        prev_xor=new_xor,
        int_val=new_int,
        sig=torch.where(plan.sig_mult_active, plan.new_sig, st.sig).to(I32),
        mult=torch.where(plan.sig_mult_active, plan.new_mult, st.mult).to(I32),
        is_float=plan.set_float,
    )


def _emit_value(st: DecodeState, divisors: torch.Tensor) -> torch.Tensor:
    """Current datapoint value as float64 (ref: iterator.go:183-197);
    `divisors` is MULT_DIVISORS on the state's device."""
    float_val = st.prev_float.view(F64)
    divisor = divisors[st.mult.clamp(0, m3tsz_scalar.MAX_MULT).to(I64)]
    int_val = st.int_val.to(F64) / divisor
    return torch.where(st.is_float, float_val, int_val)


def _merge(st: DecodeState, new_st: DecodeState, emit) -> DecodeState:
    """Commit per-lane updates only on lanes that emitted a datapoint."""
    return DecodeState(*(torch.where(emit, n, o) for n, o in zip(new_st, st)))


def _words64(words: torch.Tensor) -> torch.Tensor:
    """uint32 (or int32-viewed) words, zero-extended into int64."""
    return words.view(I32).to(I64) & 0xFFFFFFFF


def _init_state(words64: torch.Tensor, nbits: torch.Tensor) -> DecodeState:
    """State before any datapoint: cursor past the raw 64-bit stream start."""
    L, W = words64.shape
    dev = words64.device
    if W >= 2:
        start = (words64[:, 0] << 32) | words64[:, 1]
    else:
        start = torch.zeros((L,), dtype=I64, device=dev)
    zeros64 = torch.zeros((L,), dtype=I64, device=dev)
    zeros32 = torch.zeros((L,), dtype=I32, device=dev)
    false = torch.zeros((L,), dtype=BOOL, device=dev)
    return DecodeState(
        cursor=torch.full((L,), 64, dtype=I32, device=dev),
        started=false,
        # Streams too small for start + EOS marker are immediately done.
        done=nbits < 64 + 11,
        error=false,
        prev_time=start,
        prev_delta=zeros64,
        prev_float=zeros64,
        prev_xor=zeros64,
        int_val=zeros64,
        sig=zeros32,
        mult=zeros32,
        is_float=false,
    )


def _decode_step(words64, nbits, st: DecodeState, int_optimized: bool,
                 unit_nanos: int, divisors: torch.Tensor):
    """Decode one datapoint on every lane.

    Returns (state', time i64[L], value f64[L], valid bool[L]).  The
    first-record layout (mode bit instead of update structure) is selected
    per lane by the `started` flag.
    """
    hi, lo = _window128(words64, st.cursor)
    t, d, t_len, eos, bad = _parse_timestamp(hi, st, unit_nanos)
    active = ~st.done & ~st.error
    emit = active & ~eos & ~bad
    st2 = st._replace(
        error=st.error | (bad & active),
        done=st.done | (eos & active),
        prev_time=torch.where(emit, t, st.prev_time),
        prev_delta=torch.where(emit, d, st.prev_delta),
    )
    cwin = hi << t_len.clamp(max=63)
    plan_next = _plan_value(cwin, st2, int_optimized, first=False)
    plan_first = _plan_value(cwin, st2, int_optimized, first=True)
    plan = ValuePlan(*(torch.where(st.started, n, f)
                       for n, f in zip(plan_next, plan_first)))
    payload = take_top(_mid_window(hi, lo, t_len + plan.ctrl), plan.payload_len)
    st3 = _merge(st2, _apply_value(st2, plan, payload), emit)
    step_bits = torch.where(emit, t_len + plan.ctrl + plan.payload_len, 0)
    st3 = st3._replace(
        cursor=(st2.cursor + step_bits).to(I32),
        started=st.started | emit,
    )
    st3 = st3._replace(error=st3.error | ((st3.cursor > nbits) & ~st3.done))
    valid = emit & ~st3.error
    return st3, st3.prev_time, _emit_value(st3, divisors), valid


# --- plain versions of K3 and K2 ----------------------------------------


def decode_batched_plain(words, nbits, n_steps: int, int_optimized: bool = True,
                         unit_nanos: int = xtime.SECOND,
                         flag_truncation: bool = False):
    """Plain PyTorch version of ``decode_batched`` (same arguments)."""
    words64 = _words64(words)
    divisors = torch.as_tensor(MULT_DIVISORS, device=words64.device)
    st = _init_state(words64, nbits)
    scan_len = n_steps + 1 if flag_truncation else n_steps
    ts, vs, valid = [], [], []
    for _ in range(scan_len):
        st, t, v, ok = _decode_step(words64, nbits, st, int_optimized,
                                     unit_nanos, divisors)
        ts.append(t)
        vs.append(v)
        valid.append(ok)
    L, dev = words64.shape[0], words64.device
    if scan_len:
        ts = torch.stack(ts, dim=1)[:, :n_steps]
        vs = torch.stack(vs, dim=1)[:, :n_steps]
        valid = torch.stack(valid, dim=1)[:, :n_steps]
    else:
        ts = torch.zeros((L, 0), dtype=I64, device=dev)
        vs = torch.zeros((L, 0), dtype=F64, device=dev)
        valid = torch.zeros((L, 0), dtype=BOOL, device=dev)
    count = valid.sum(dim=1, dtype=I32)
    error = st.error
    if flag_truncation:
        error = error | ~st.done
    return ts, vs, valid, count, error


def _min_ieee(a, b):
    """IEEE-754 minimum of non-NaN operands (-0.0 below +0.0), as XLA's
    min and so jnp.minimum compute it."""
    return torch.where(a < b, a, torch.where(b < a, b, torch.where(
        torch.signbit(a), a, b)))


def _max_ieee(a, b):
    return torch.where(a > b, a, torch.where(b > a, b, torch.where(
        torch.signbit(a), b, a)))


def decode_downsample_fused_plain(words, nbits, n_steps: int, window: int,
                                  int_optimized: bool = True,
                                  unit_nanos: int = xtime.SECOND,
                                  full_agg: bool = False):
    """Plain PyTorch version of ``decode_downsample_fused`` (same arguments)."""
    from m3_tpu_torch.ops.downsample import WindowedAgg

    words64 = _words64(words)
    L, dev = words64.shape[0], words64.device
    divisors = torch.as_tensor(MULT_DIVISORS, device=dev)
    st = _init_state(words64, nbits)
    outs = []
    for _ in range(n_steps // window):
        s = torch.zeros((L,), dtype=F64, device=dev)
        ssq = torch.zeros((L,), dtype=F64, device=dev)
        cnt = torch.zeros((L,), dtype=I64, device=dev)
        vmin = torch.full((L,), torch.inf, dtype=F64, device=dev)
        vmax = torch.full((L,), -torch.inf, dtype=F64, device=dev)
        last = torch.full((L,), torch.nan, dtype=F64, device=dev)
        has_last = torch.zeros((L,), dtype=BOOL, device=dev)
        for _ in range(window):
            st, _t, v, valid = _decode_step(words64, nbits, st, int_optimized,
                                            unit_nanos, divisors)
            contrib = valid & ~torch.isnan(v)
            vz = torch.where(contrib, v, 0.0)
            s = s + vz
            cnt = cnt + valid
            if full_agg:
                ssq = ssq + vz * vz
                vmin = torch.where(contrib, _min_ieee(vmin, v), vmin)
                vmax = torch.where(contrib, _max_ieee(vmax, v), vmax)
                last = torch.where(valid, v, last)
                has_last = has_last | valid
        if full_agg:
            any_c = vmin != torch.inf
            nan = torch.full_like(s, torch.nan)
            outs.append((s, ssq, cnt, torch.where(any_c, vmin, nan),
                         torch.where(any_c, vmax, nan),
                         torch.where(has_last, last, nan)))
        else:
            outs.append((s, cnt))
    n_win = n_steps // window

    def col(i, dtype):
        if not n_win:
            return torch.zeros((L, 0), dtype=dtype, device=dev)
        return torch.stack([o[i] for o in outs], dim=1)

    if full_agg:
        agg = WindowedAgg(sum=col(0, F64), sum_sq=col(1, F64), count=col(2, I64),
                          min=col(3, F64), max=col(4, F64), last=col(5, F64))
    else:
        s = col(0, F64)
        nan = torch.full_like(s, torch.nan)
        agg = WindowedAgg(sum=s, sum_sq=nan, count=col(1, I64), min=nan,
                          max=nan, last=nan)
    total = agg.count.sum(dim=1).to(I32)
    return agg, total, st.error


# --- wrappers: CUDA tensor -> kernel, CPU tensor -> plain version --------

_DECODE_SIGNATURES = {
    "m3_decode_downsample_fused": [
        _build.P, _build.P, _build.I, _build.I, _build.I, _build.I, _build.I,
        _build.LL, _build.I, _build.P, _build.P, _build.P, _build.P,
        _build.P, _build.P, _build.P, _build.P, _build.P, _build.P],
    "m3_decode_batched": [
        _build.P, _build.P, _build.I, _build.I, _build.I, _build.I, _build.I,
        _build.LL, _build.I, _build.P, _build.P, _build.P, _build.P,
        _build.P, _build.P, _build.P],
}


def _check_inputs(words: torch.Tensor, nbits: torch.Tensor, unit_nanos: int):
    if unit_nanos not in (xtime.SECOND, 1_000_000):
        raise ValueError("fast path supports second/millisecond units")
    if words.dim() != 2 or words.dtype not in (torch.uint32, torch.int32):
        raise ValueError(f"words must be [L, W] uint32, got {words.dtype} "
                         f"{tuple(words.shape)}")
    if nbits.shape != (words.shape[0],):
        raise ValueError(f"nbits must be [L], got {tuple(nbits.shape)}")
    if nbits.device != words.device:
        raise ValueError("words and nbits must be on the same device")
    if words.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {words.device}")
    return words.view(I32).contiguous(), nbits.to(I32).contiguous()


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def decode_batched(words: torch.Tensor, nbits: torch.Tensor, n_steps: int,
                   int_optimized: bool = True, unit_nanos: int = xtime.SECOND,
                   flag_truncation: bool = False):
    """Decode up to n_steps datapoints from each of L streams.

    Returns (timestamps i64[L, n_steps], values f64[L, n_steps],
    valid bool[L, n_steps], count i32[L], error bool[L]).

    With `flag_truncation`, a stream that did NOT reach its end-of-
    stream marker within n_steps records is reported in `error`.
    """
    words, nbits = _check_inputs(words, nbits, unit_nanos)
    if not words.is_cuda:
        return decode_batched_plain(words, nbits, n_steps, int_optimized,
                                    unit_nanos, flag_truncation)
    L, W = words.shape
    dev = words.device
    ts = torch.empty((L, n_steps), dtype=I64, device=dev)
    vs = torch.empty((L, n_steps), dtype=F64, device=dev)
    valid = torch.empty((L, n_steps), dtype=BOOL, device=dev)
    count = torch.empty((L,), dtype=I32, device=dev)
    error = torch.empty((L,), dtype=BOOL, device=dev)
    if L == 0:
        return ts, vs, valid, count, error
    lib = _build.library("m3tsz_decode", _DECODE_SIGNATURES)
    rc = lib.m3_decode_batched(
        _ptr(words), _ptr(nbits), L, W, n_steps,
        n_steps + 1 if flag_truncation else n_steps, int(int_optimized),
        unit_nanos, int(flag_truncation), MULT_DIVISORS.ctypes.data,
        _ptr(ts), _ptr(vs), _ptr(valid), _ptr(count), _ptr(error),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "decode_batched")
    _build.count_launch("decode_batched")
    return ts, vs, valid, count, error


def decode_downsample_fused(words: torch.Tensor, nbits: torch.Tensor,
                            n_steps: int, window: int,
                            int_optimized: bool = True,
                            unit_nanos: int = xtime.SECOND,
                            full_agg: bool = False):
    """Fused decode + windowed aggregation: never materializes the
    [L, n_steps] grid — `window` datapoints are decoded inline per window
    and only the accumulators are written.

    Returns (agg: WindowedAgg of [L, n_windows] — sum/count always
    populated; min/max/sum_sq/last only when full_agg, NaN otherwise —
    count i32[L], error bool[L]).
    """
    from m3_tpu_torch.ops.downsample import WindowedAgg

    if n_steps % window:
        raise ValueError(f"n_steps {n_steps} not divisible by window {window}")
    words, nbits = _check_inputs(words, nbits, unit_nanos)
    if not words.is_cuda:
        return decode_downsample_fused_plain(words, nbits, n_steps, window,
                                             int_optimized, unit_nanos, full_agg)
    L, W = words.shape
    n_win = n_steps // window
    dev = words.device

    def grid(dtype):
        return torch.empty((L, n_win), dtype=dtype, device=dev)

    s, count = grid(F64), grid(I64)
    if full_agg:
        ssq, vmin, vmax, last = grid(F64), grid(F64), grid(F64), grid(F64)
    else:
        # Fields not computed in the cheap mode are NaN, preserving
        # WindowedAgg's NaN-for-unset invariant (rollup/value_of key on it).
        ssq = vmin = vmax = last = torch.full((L, n_win), torch.nan,
                                              dtype=F64, device=dev)
    total = torch.empty((L,), dtype=I32, device=dev)
    error = torch.empty((L,), dtype=BOOL, device=dev)
    if L:
        lib = _build.library("m3tsz_decode", _DECODE_SIGNATURES)
        rc = lib.m3_decode_downsample_fused(
            _ptr(words), _ptr(nbits), L, W, n_win, window, int(int_optimized),
            unit_nanos, int(full_agg), MULT_DIVISORS.ctypes.data, _ptr(s),
            _ptr(count), *(_ptr(x) if full_agg else None
                           for x in (ssq, vmin, vmax, last)),
            _ptr(total), _ptr(error), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, rc, "decode_downsample_fused")
        _build.count_launch("decode_downsample_fused")
    agg = WindowedAgg(sum=s, sum_sq=ssq, count=count, min=vmin, max=vmax,
                      last=last)
    return agg, total, error


# --- host entry ---------------------------------------------------------


def _scalar_decode(stream: bytes, int_optimized: bool, unit: xtime.Unit):
    """Scalar-oracle decode of one stream -> (times, values) lists.
    A truncated or corrupt tail keeps the clean prefix (the shared
    fallback for lanes the fast paths flag)."""
    got_t: list[int] = []
    got_v: list[float] = []
    try:
        for dp in m3tsz_scalar.Decoder(
                bytes(stream), int_optimized=int_optimized,
                default_unit=unit):
            got_t.append(dp.t_nanos)
            got_v.append(dp.value)
    except (EOFError, ValueError):
        pass
    return got_t, got_v


def decode_streams(
    streams: list[bytes],
    max_datapoints: int,
    int_optimized: bool = True,
    unit: xtime.Unit = xtime.Unit.SECOND,
    device=None,
):
    """Host entry: pack → device decode → scalar-oracle fallback for lanes
    the fast path flagged (annotations, time-unit changes, corruption).

    Returns numpy (timestamps i64[L, T], values f64[L, T], valid bool[L, T]).
    Runs on the CUDA device unless ``device="cpu"``.
    """
    decode_counter.bump(len(streams))
    dev = resolve_device(device)
    words, nbits = pack_streams(streams)
    ts, vs, valid, _count, error = decode_batched(
        torch.from_numpy(words).to(dev),
        torch.from_numpy(nbits).to(dev),
        max_datapoints,
        int_optimized=int_optimized,
        unit_nanos=unit.nanos,
    )
    ts, vs, valid = ts.cpu().numpy(), vs.cpu().numpy(), valid.cpu().numpy()
    for lane in np.nonzero(error.cpu().numpy())[0]:
        got_t, got_v = _scalar_decode(streams[lane], int_optimized, unit)
        n = min(len(got_t), max_datapoints)
        ts[lane, :n] = got_t[:n]
        vs[lane, :n] = got_v[:n]
        valid[lane, :] = False
        valid[lane, :n] = True
    return ts, vs, valid


def decode_streams_adaptive(
    streams: list[bytes],
    int_optimized: bool = True,
    unit: xtime.Unit = xtime.Unit.SECOND,
    counts: np.ndarray | None = None,
    device=None,
):
    """``decode_streams`` at a width that holds every stream.

    A stream's datapoint count is not recoverable from its byte length
    (int-optimized walks compress to ~4.5 bits a point, float-mode streams
    to 12-26), so: with stored (v2-fileset) ``counts`` decode at their
    maximum + 1, and if any lane disagrees, retry without them; else size
    the grid with the native count pass; without a host toolchain, start
    at 12 bits a point and re-decode the lanes that filled the grid 4x
    wider, down to the grammar's 2 bits a point.  Every decode runs on
    ``device`` (default ``cuda``); the ``except`` below covers only the
    host count pass.  Returns numpy (ts [L, T], vs [L, T], valid [L, T])
    with T the widest round's width.
    """
    if not streams:
        return (np.zeros((0, 1), dtype=np.int64),
                np.zeros((0, 1)), np.zeros((0, 1), dtype=bool))
    dev = resolve_device(device)
    max_len = max(len(s) for s in streams)
    hard_cap = 1 + max_len * 8 // 2  # grammar floor: 1b time + 1b value
    if counts is not None:
        # the extra column catches a stale or understated stored count
        counts = np.asarray(counts, dtype=np.int64)
        width = int(counts.max(initial=0)) + 1
        ts, vs, valid = decode_streams(streams, max(width, 1),
                                       int_optimized=int_optimized,
                                       unit=unit, device=dev)
        if bool((valid.sum(axis=1) == counts).all()):
            return ts, vs, valid
        return decode_streams_adaptive(streams, int_optimized=int_optimized,
                                       unit=unit, device=dev)
    if int_optimized:
        width = None
        try:
            from m3_tpu_torch.utils.native import count_batch_native

            counts = count_batch_native(streams, unit_nanos=unit.nanos)
            width = int(counts.max(initial=0))
            for lane in np.nonzero(counts < 0)[0]:
                # unsupported constructs: the scalar oracle counts here
                # and re-decodes inside decode_streams below
                got_t, _ = _scalar_decode(streams[lane], int_optimized, unit)
                width = max(width, len(got_t))
        except Exception:  # host toolchain unavailable: escalation below
            width = None
        if width is not None:
            return decode_streams(streams, max(width, 1),
                                  int_optimized=int_optimized, unit=unit,
                                  device=dev)
    est = min(1 + max_len * 8 // 12, hard_cap)
    todo = np.arange(len(streams))
    rounds: list[tuple[np.ndarray, tuple]] = []
    while True:
        sub = [streams[i] for i in todo]
        ts, vs, valid = decode_streams(sub, est, int_optimized=int_optimized,
                                       unit=unit, device=dev)
        if est >= hard_cap:
            rounds.append((todo, (ts, vs, valid)))
            break
        sat = valid[:, -1]  # grid filled: may be truncated
        done = ~sat
        if done.any():
            rounds.append((todo[done], (ts[done], vs[done], valid[done])))
        if not sat.any():
            break
        todo = todo[sat]
        est = min(est * 4, hard_cap)
    width = max(r[1][0].shape[1] for r in rounds)
    L = len(streams)
    out_t = np.zeros((L, width), dtype=np.int64)
    out_v = np.zeros((L, width))
    out_m = np.zeros((L, width), dtype=bool)
    for idx, (ts, vs, valid) in rounds:
        w = ts.shape[1]
        out_t[idx, :w] = ts
        out_v[idx, :w] = vs
        out_m[idx, :w] = valid
    return out_t, out_v, out_m


def decode_streams_merged(
    streams: list[bytes],
    slots: np.ndarray,
    n_lanes: int,
    int_optimized: bool = True,
    unit: xtime.Unit = xtime.Unit.SECOND,
    counts: np.ndarray | None = None,
):
    """Fused decode + merge of the warm read path, on the host: count
    pass, exact per-lane sizing, each block stream decoded directly into
    its packed [n_lanes, N] position (``native/m3tsz_ref.cc``), then the
    tail padding.

    Contract: streams of one lane (``slots``) come in ascending time
    order.  Returns (times [n_lanes, N] with INT64_MAX padding, values
    [n_lanes, N] with NaN padding, lane_counts [n_lanes]), or None when
    the preconditions do not hold (out-of-order timestamps inside or
    across streams, slots not grouped, no native toolchain, the
    float-only grammar): callers then take the general decode and a
    sorting merge."""
    if not int_optimized or not len(streams):
        return None
    decode_counter.bump(len(streams))
    try:
        from m3_tpu_torch.utils.native import (blob_offsets,
                                               count_batch_native,
                                               decode_merged_native,
                                               pad_lane_tails_native)

        packed = blob_offsets(streams)  # shared by the count and decode passes
        if counts is not None:
            # v2 filesets store per-stream counts: no count pass
            counts = np.ascontiguousarray(counts, dtype=np.int64)
        else:
            counts = count_batch_native(streams, unit_nanos=unit.nanos,
                                        packed=packed)
    except Exception:  # host toolchain unavailable
        return None
    slots = np.ascontiguousarray(slots, dtype=np.int64)
    if len(slots) > 1 and not bool(np.all(slots[1:] >= slots[:-1])):
        return None  # not grouped: the adjacency order check would not cover
    bad = np.nonzero(counts < 0)[0]
    bad_data: dict[int, tuple[list, list]] = {}
    for lane in bad:
        got_t, got_v = _scalar_decode(streams[lane], int_optimized, unit)
        bad_data[int(lane)] = (got_t, got_v)
        counts[lane] = len(got_t)
    lane_counts = np.bincount(slots, weights=counts,
                              minlength=n_lanes).astype(np.int64)
    n_cap = max(int(lane_counts.max(initial=0)), 1)
    # flat destination offsets: a global cumsum re-based at each group
    # start gives each row's position within its lane
    cum = np.concatenate(([0], np.cumsum(counts)[:-1]))
    first = np.concatenate(([True], slots[1:] != slots[:-1]))
    group_idx = np.cumsum(first) - 1
    pos_in_lane = cum - cum[np.nonzero(first)[0]][group_idx]
    row_dst = slots * n_cap + pos_in_lane
    out_t = np.empty((n_lanes, n_cap), dtype=np.int64)
    out_v = np.empty((n_lanes, n_cap), dtype=np.float64)
    row_n, row_first, row_last, row_sorted = decode_merged_native(
        streams, row_dst, counts, out_t.reshape(-1), out_v.reshape(-1),
        unit_nanos=unit.nanos, packed=packed)
    for lane, (got_t, got_v) in bad_data.items():
        dst = row_dst[lane]
        flat_t, flat_v = out_t.reshape(-1), out_v.reshape(-1)
        flat_t[dst:dst + len(got_t)] = got_t
        flat_v[dst:dst + len(got_v)] = got_v
        row_n[lane] = len(got_t)
        row_first[lane] = got_t[0] if got_t else np.iinfo(np.int64).max
        row_last[lane] = got_t[-1] if got_t else np.iinfo(np.int64).min
        row_sorted[lane] = int(all(a <= b for a, b in zip(got_t, got_t[1:])))
    # every row sorted, adjacent rows of one lane not overlapping in time
    if not row_sorted.all():
        return None
    if len(streams) > 1:
        same = slots[1:] == slots[:-1]
        if not bool(np.all(~same | (row_last[:-1] <= row_first[1:]))):
            return None
    if not bool((row_n == counts).all()):
        return None  # count/decode disagreement
    pad_lane_tails_native(out_t, out_v, lane_counts)
    return out_t, out_v, lane_counts
