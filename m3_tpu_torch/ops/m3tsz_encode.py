"""Batched M3TSZ encode: the host value grammar, kernel E1 and its plain version.

Port of ``m3_tpu/ops/m3tsz_encode.py``.  The encoder is split as in the
reference: the value grammar (int/float conversion, significant-bit
tracker, XOR control) runs on the host over exact IEEE f64 and emits one
(control, payload) field pair per datapoint; ``pack_encode`` builds the
delta-of-delta timestamp fields and bit-packs the ``[L, 2 + 3T]`` field
matrix (stream start, then time/control/payload per step, then the EOS
marker) into big-endian uint32 words.  The reference split the work this
way because the TPU's emulated f64 loses bits in transfer; the H100's f64
is IEEE, so moving the grammar onto the card is later work (ROADMAP.md).

- On a CUDA tensor ``pack_encode`` launches kernel E1 of
  ``csrc/m3tsz_encode.cu`` (one thread per lane, a 64-bit bit buffer, each
  finished word written once, the row's tail zero-filled).  It raises if
  the kernel cannot be built or launched.
- On a CPU tensor it runs ``pack_encode_plain``: the reference's
  elementwise time fields and exclusive-prefix-sum + three-word
  scatter-add packing, on int64 bit patterns (PyTorch has no uint64 shifts
  on the CPU).  Fields never overlap, so the integer scatter-add is a
  bitwise OR and its order does not matter.

Scope, as the reference's: int-optimized streams at one fixed second
unit with no annotations, the production block-seal shape.  Streams with
sub-second timestamps take the scalar encoder (``storage/shard.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from m3_tpu_torch.ops import _build
from m3_tpu_torch.ops import m3tsz_scalar as tsz
from m3_tpu_torch.ops.bitstream import I32, I64, PAD_WORDS, srl, unpack_stream
from m3_tpu_torch.utils import xtime
from m3_tpu_torch.utils.device import resolve_device
from m3_tpu_torch.utils.native import prepare_value_fields_native

_SECOND = xtime.Unit.SECOND.nanos
_MAX_BITS_FIRST = 64 + 36 + 17 + 64  # start64 + t + ctl + pay
_MAX_BITS_NEXT = 36 + 17 + 64
_EOS_BITS = tsz.MARKER_OPCODE_BITS + tsz.MARKER_VALUE_BITS  # 11
_EOS = (tsz.MARKER_OPCODE << tsz.MARKER_VALUE_BITS) | tsz.MARKER_EOS

_U = np.uint64
_ONE = _U(1)


# ---------------------------------------------------------------------------
# host-side vectorized bit helpers (numpy, exact)
# ---------------------------------------------------------------------------


def _np_popcount64(x: np.ndarray) -> np.ndarray:
    x = x - ((x >> _U(1)) & _U(0x5555555555555555))
    x = (x & _U(0x3333333333333333)) + ((x >> _U(2)) & _U(0x3333333333333333))
    x = (x + (x >> _U(4))) & _U(0x0F0F0F0F0F0F0F0F)
    return ((x * _U(0x0101010101010101)) >> _U(56)).astype(np.int32)


def _np_clz64(x: np.ndarray) -> np.ndarray:
    y = x.copy()
    for s in (1, 2, 4, 8, 16, 32):
        y |= y >> _U(s)
    return 64 - _np_popcount64(y)


def _np_ctz64(x: np.ndarray) -> np.ndarray:
    """ctz(0) == 0, matching the reference's LeadingAndTrailingZeros
    (ref: src/dbnode/encoding/encoding.go:35-43)."""
    lsb = x & (~x + _ONE)
    return np.where(x == 0, 0, 63 - _np_clz64(lsb)).astype(np.int32)


def _np_nsb64(x: np.ndarray) -> np.ndarray:
    """Significant bits of uint64 (0 for 0) — ref: encoding.go:29."""
    return (64 - _np_clz64(x)).astype(np.int32)


def _np_float_bits(v: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(v, dtype=np.float64).view(np.uint64)


# ---------------------------------------------------------------------------
# convert_to_int_float, vectorized numpy (ref: m3tsz.go:78-118)
# ---------------------------------------------------------------------------

_MULTIPLIERS = np.asarray(tsz.MULTIPLIERS, dtype=np.float64)


def _np_convert_to_int_float(v: np.ndarray, cur_max_mult: np.ndarray):
    """Elementwise (val, mult, is_float).  NaN/huge values go float."""
    with np.errstate(invalid="ignore", over="ignore"):
        tr = np.trunc(v)
        fast = (cur_max_mult == 0) & (v < tsz.MAX_INT64) & (v - tr == 0)

        sign = np.where(v < 0, -1.0, 1.0)
        mult_pow = _MULTIPLIERS[np.clip(cur_max_mult, 0, tsz.MAX_MULT)]
        val = np.abs(v) * mult_pow
        mult = cur_max_mult.astype(np.int32)

        found = fast.copy()
        res_val = np.where(fast, tr, 0.0)
        res_mult = np.zeros_like(mult)
        for _ in range(tsz.MAX_MULT + 1):
            active = (~found) & (mult <= tsz.MAX_MULT) & (val < tsz.MAX_OPT_INT)
            ip = np.trunc(val)
            frac = val - ip
            nxt = ip + 1
            c1 = frac == 0
            c2 = (frac < 0.1) & (np.nextafter(val, 0.0) <= ip)
            c3 = (frac > 0.9) & (np.nextafter(val, np.inf) >= nxt)
            hit = active & (c1 | c2 | c3)
            hit_val = np.where(c1 | c2, sign * ip, sign * nxt)
            res_val = np.where(hit, hit_val, res_val)
            res_mult = np.where(hit, mult, res_mult)
            found |= hit
            step = active & ~hit
            val = np.where(step, val * 10.0, val)
            mult = np.where(step, mult + 1, mult)

    is_float = ~found
    res_val = np.where(is_float, v, res_val)
    res_mult = np.where(is_float, 0, res_mult)
    return res_val, res_mult.astype(np.int32), is_float


# ---------------------------------------------------------------------------
# host-side field builders (numpy mirrors of the wire grammar)
# ---------------------------------------------------------------------------


def _np_sig_mult_fields(num_sig, sig, max_mult, mult, float_changed):
    """Sig-bit + multiplier update prefix (ref: encoder.go:206-238)."""
    sig_changed = num_sig != sig
    s6 = (sig - 1).astype(_U) & _U(0x3F)
    f1_bits = np.where(
        sig_changed, np.where(sig == 0, _U(0b10), (_U(0b11) << _U(6)) | s6), _U(0)
    )
    f1_n = np.where(sig_changed, np.where(sig == 0, 2, 8), 1).astype(np.int32)

    up = mult > max_mult
    rewrite = (~up) & (max_mult == mult) & float_changed
    f2_bits = np.where(
        up,
        _U(0b1000) | mult.astype(_U),
        np.where(rewrite, _U(0b1000) | max_mult.astype(_U), _U(0)),
    )
    f2_n = np.where(up | rewrite, 4, 1).astype(np.int32)
    new_max_mult = np.where(up, mult, max_mult)

    bits = (f1_bits << f2_n.astype(_U)) | f2_bits
    return bits, f1_n + f2_n, new_max_mult


def _np_track_sig(num_sig, chl, nlow, nsb):
    """Hysteresis tracker step (ref: int_sig_bits_tracker.go:68-91)."""
    gt = nsb > num_sig
    dropbig = (~gt) & (num_sig - nsb >= tsz.SIG_DIFF_THRESHOLD)
    new_chl = np.where(dropbig & ((nlow == 0) | (nsb > chl)), nsb, chl)
    nlow1 = np.where(dropbig, nlow + 1, np.where(gt, nlow, 0)).astype(np.int32)
    fire = dropbig & (nlow1 >= tsz.SIG_REPEAT_THRESHOLD)
    tracked = np.where(gt, nsb, np.where(fire, new_chl, num_sig)).astype(np.int32)
    new_nlow = np.where(fire, 0, nlow1).astype(np.int32)
    return tracked, new_chl.astype(np.int32), new_nlow


def _np_xor_fields(prev_xor, xor):
    """Float XOR control + payload (ref: float_encoder_iterator.go:63-113)."""
    xz = xor == 0
    pl, pt = _np_clz64(prev_xor), _np_ctz64(prev_xor)
    lead, trail = _np_clz64(xor), _np_ctz64(xor)
    contained = (lead >= pl) & (trail >= pt)
    m_prev = (64 - pl - pt).astype(np.int32)
    m_cur = (64 - lead - trail).astype(np.int32)
    ctl_bits = np.where(
        xz,
        _U(0),
        np.where(
            contained,
            _U(0b10),
            (_U(0b11) << _U(12)) | (lead.astype(_U) << _U(6)) | (m_cur - 1).astype(_U),
        ),
    )
    ctl_n = np.where(xz, 1, np.where(contained, 2, 14)).astype(np.int32)
    pay_bits = np.where(
        xz, _U(0), np.where(contained, xor >> pt.astype(_U), xor >> trail.astype(_U))
    )
    pay_n = np.where(xz, 0, np.where(contained, m_prev, m_cur)).astype(np.int32)
    return ctl_bits, ctl_n, pay_bits, pay_n


# ---------------------------------------------------------------------------
# host value-grammar state machine (the plain version of the native prepare)
# ---------------------------------------------------------------------------


def prepare_value_fields(values: np.ndarray, n_valid: np.ndarray):
    """Run the value grammar for L series over T steps on the host.

    values:  [L, T] float64 (host numpy)
    n_valid: [L] int32

    Returns (ctl_bits, ctl_n, pay_bits, pay_n), each [L, T]
    (uint64/int32): the per-step value control + payload fields that
    ``pack_encode`` interleaves with the time fields and bit-packs.
    ``native/m3tsz_prepare.cc`` (``utils/native.py``) computes the same
    fields and is what ``encode_batched`` runs.
    """
    values = np.asarray(values, dtype=np.float64)
    n_valid = np.asarray(n_valid, dtype=np.int32)
    L, T = values.shape

    prev_float = np.zeros(L, _U)
    prev_xor = np.zeros(L, _U)
    int_val = np.zeros(L, np.float64)
    num_sig = np.zeros(L, np.int32)
    chl = np.zeros(L, np.int32)
    nlow = np.zeros(L, np.int32)
    max_mult = np.zeros(L, np.int32)
    is_float = np.zeros(L, bool)

    ctl_bits = np.zeros((L, T), _U)
    ctl_n = np.zeros((L, T), np.int32)
    pay_bits = np.zeros((L, T), _U)
    pay_n = np.zeros((L, T), np.int32)
    if T == 0:
        return ctl_bits, ctl_n, pay_bits, pay_n

    def put(t, valid, cb, cn, pb, pn):
        ctl_bits[:, t] = np.where(valid, cb, _U(0))
        ctl_n[:, t] = np.where(valid, cn, 0)
        pay_bits[:, t] = np.where(valid, pb, _U(0))
        pay_n[:, t] = np.where(valid, pn, 0)

    def merge(valid, new, old):
        return np.where(valid, new, old)

    # --- first datapoint (ref: encoder.go:111-145) ---
    v = values[:, 0]
    valid = n_valid > 0
    val, mult, go_float = _np_convert_to_int_float(v, np.zeros_like(max_mult))
    fb = _np_float_bits(v)
    with np.errstate(invalid="ignore"):
        mag = np.minimum(np.abs(val), 2.0**63)
        mag = np.where(np.isnan(mag), 2.0**63, mag).astype(_U)
    sig_first = _np_nsb64(mag)
    sm_bits, sm_n, mm_int = _np_sig_mult_fields(
        num_sig, sig_first, max_mult, mult, np.zeros_like(go_float)
    )
    with np.errstate(invalid="ignore"):
        add = (val >= 0).astype(_U)
    ctl_int = (sm_bits << _ONE) | add  # '0' mode bit + sig/mult + sign
    n_ctl_int = 1 + sm_n + 1
    put(
        0,
        valid,
        np.where(go_float, _U(1), ctl_int),
        np.where(go_float, 1, n_ctl_int),
        np.where(go_float, fb, mag),
        np.where(go_float, 64, sig_first),
    )
    prev_float = merge(valid & go_float, fb, prev_float)
    prev_xor = merge(valid & go_float, fb, prev_xor)
    int_val = merge(valid & ~go_float, val, int_val)
    num_sig = merge(valid & ~go_float, sig_first, num_sig)
    max_mult = merge(valid & ~go_float, mm_int, max_mult)
    is_float = merge(valid, go_float, is_float)

    # --- remaining datapoints (ref: encoder.go:147-204) ---
    for t in range(1, T):
        v = values[:, t]
        valid = t < n_valid
        val, mult, isf = _np_convert_to_int_float(v, max_mult)
        with np.errstate(invalid="ignore"):
            diff = int_val - val
            go_float = isf | (diff >= tsz.MAX_INT64) | (diff <= -tsz.MAX_INT64)
            go_float |= np.isnan(diff)

        fb = _np_float_bits(val)
        b_trans = go_float & ~is_float  # int -> float: '001' + raw64
        same_bits = fb == prev_float
        b_frep = go_float & is_float & same_bits  # '01'
        b_fxor = go_float & is_float & ~same_bits  # '1' + xor
        xor = prev_float ^ fb
        xc_bits, xc_n, xp_bits, xp_n = _np_xor_fields(prev_xor, xor)

        b_int = ~go_float
        rep_i = b_int & (diff == 0) & ~is_float & (mult == max_mult)  # '01'
        with np.errstate(invalid="ignore"):
            add = (diff < 0).astype(_U)
            mag = np.where(np.isnan(diff), 0.0, np.abs(diff)).astype(_U)
        nsb = _np_nsb64(mag)
        tracked, chl2, nlow2 = _np_track_sig(num_sig, chl, nlow, nsb)
        float_changed = is_float
        need_up = (mult > max_mult) | (num_sig != tracked) | float_changed
        sm_bits, sm_n, mm_up = _np_sig_mult_fields(
            num_sig, tracked, max_mult, mult, float_changed
        )
        ctl_up = (sm_bits << _ONE) | add  # '000' + sigmult + sign
        n_up = 3 + sm_n + 1
        ctl_nu = _U(0b10) | add  # '1' + sign
        b_iup = b_int & ~rep_i & need_up
        b_inu = b_int & ~rep_i & ~need_up

        cb = np.where(
            b_trans,
            _U(0b001),
            np.where(
                b_frep | rep_i,
                _U(0b01),
                np.where(
                    b_fxor,
                    (_ONE << xc_n.astype(_U)) | xc_bits,
                    np.where(b_iup, ctl_up, ctl_nu),
                ),
            ),
        )
        cn = np.where(
            b_trans,
            3,
            np.where(
                b_frep | rep_i, 2, np.where(b_fxor, 1 + xc_n, np.where(b_iup, n_up, 2))
            ),
        )
        pb = np.where(b_trans, fb, np.where(b_fxor, xp_bits, mag))
        pn = np.where(
            b_trans,
            64,
            np.where(
                b_fxor, xp_n, np.where(b_iup, tracked, np.where(b_inu, num_sig, 0))
            ),
        )
        put(t, valid, cb, cn, pb, pn)

        int_emit = b_iup | b_inu | rep_i
        prev_float = merge(valid & (b_trans | b_fxor), fb, prev_float)
        prev_xor = merge(valid & b_trans, fb, merge(valid & b_fxor, xor, prev_xor))
        int_val = merge(valid & int_emit, val, int_val)
        num_sig = merge(valid & (b_iup | b_inu), tracked, num_sig)
        chl = merge(valid & (b_iup | b_inu), chl2, chl)
        nlow = merge(valid & (b_iup | b_inu), nlow2, nlow)
        max_mult = merge(
            valid & b_trans, mult, merge(valid & b_iup, mm_up, max_mult)
        )
        is_float = merge(valid & b_trans, True, merge(valid & (b_iup | b_inu), False, is_float))

    return ctl_bits, ctl_n, pay_bits, pay_n


# ---------------------------------------------------------------------------
# the plain version of E1: time fields + bit packing (int64 bit patterns)
# ---------------------------------------------------------------------------


def _time_fields(timestamps: torch.Tensor, start: torch.Tensor, n_valid: torch.Tensor):
    """[L, T] delta-of-delta records (bits, nbits), elementwise.

    ref: timestamp_encoder.go:174-213, scheme.go:42-52 (second default
    bucket = 32 bits).  Steps at or past ``n_valid`` give empty fields."""
    L, T = timestamps.shape
    prev_t = torch.cat([start[:, None], timestamps[:, :-1]], dim=1)
    delta = timestamps - prev_t
    prev_delta = torch.cat([torch.zeros((L, 1), dtype=I64, device=delta.device),
                            delta[:, :-1]], dim=1)
    raw_dod = delta - prev_delta
    dod = torch.where(raw_dod < 0, -((-raw_dod) // _SECOND), raw_dod // _SECOND)

    z = dod == 0
    in7 = (dod >= -64) & (dod <= 63)
    in9 = (dod >= -256) & (dod <= 255)
    in12 = (dod >= -2048) & (dod <= 2047)
    bits = torch.where(z, 0, torch.where(
        in7, (0b10 << 7) | (dod & 0x7F), torch.where(
            in9, (0b110 << 9) | (dod & 0x1FF), torch.where(
                in12, (0b1110 << 12) | (dod & 0xFFF), (0b1111 << 32) | (dod & 0xFFFFFFFF)))))
    nbits = torch.where(z, 1, torch.where(in7, 9, torch.where(in9, 12, torch.where(in12, 16, 36))))
    valid = torch.arange(T, device=dod.device)[None, :] < n_valid[:, None]
    return torch.where(valid, bits, 0), torch.where(valid, nbits, 0).to(I32)


def _pack_fields(bits: torch.Tensor, nbits: torch.Tensor, n_words: int):
    """Pack [L, F] (bits int64, nbits int32) fields into [L, n_words] uint32
    words (big-endian bit order) and the [L] int32 bit totals.

    The vectorized OStream (ref: src/dbnode/encoding/ostream.go:180
    WriteBits): an exclusive prefix sum gives each field its bit offset;
    each field touches at most three consecutive 32-bit words."""
    L, F = bits.shape
    dev = bits.device
    n = nbits.to(I64)
    offs = torch.cumsum(n, dim=1) - n
    total = (offs[:, -1] + n[:, -1]).to(I32) if F else torch.zeros(L, dtype=I32, device=dev)

    aligned = torch.where(n > 0, bits << torch.where(n > 0, 64 - n, 0), 0)
    b = offs & 31
    w0 = offs >> 5
    main = srl(aligned, b)
    spill = torch.where(b > 0, aligned << torch.where(b > 0, 64 - b, 0), 0)
    base = (torch.arange(L, dtype=I64, device=dev)[:, None] * n_words + w0).reshape(-1)
    flat = torch.zeros(L * n_words, dtype=I64, device=dev)
    flat.index_add_(0, base, srl(main, 32).reshape(-1))
    flat.index_add_(0, base + 1, (main & 0xFFFFFFFF).reshape(-1))
    flat.index_add_(0, base + 2, srl(spill, 32).reshape(-1))
    # each word is < 2**32: reinterpret its low 32 bits as uint32
    words = torch.where(flat >= 1 << 31, flat - (1 << 32), flat).to(I32).view(torch.uint32)
    return words.reshape(L, n_words), total


def _as_i64(x: torch.Tensor) -> torch.Tensor:
    """uint64 bit patterns viewed as int64 (other integer types converted)."""
    return x.view(I64) if x.dtype == torch.uint64 else x.to(I64)


def pack_encode_plain(timestamps, start, n_valid, ctl_bits, ctl_n, pay_bits, pay_n):
    """Plain PyTorch version of ``pack_encode`` (same arguments and results)."""
    ts = timestamps.to(I64)
    L, T = ts.shape
    dev = ts.device
    has_any = n_valid > 0
    t_bits, t_n = _time_fields(ts, start.to(I64), n_valid.to(I64))
    cb, pb = _as_i64(ctl_bits), _as_i64(pay_bits)
    rec_bits = torch.stack([t_bits, cb, pb], dim=2).reshape(L, 3 * T)
    rec_n = torch.stack([t_n, ctl_n.to(I32), pay_n.to(I32)], dim=2).reshape(L, 3 * T)
    fields = torch.cat([start.to(I64)[:, None], rec_bits,
                        torch.full((L, 1), _EOS, dtype=I64, device=dev)], dim=1)
    fields_n = torch.cat([torch.where(has_any, 64, 0).to(I32)[:, None], rec_n,
                          torch.where(has_any, _EOS_BITS, 0).to(I32)[:, None]], dim=1)
    return _pack_fields(fields, fields_n, n_words_for(T))


# ---------------------------------------------------------------------------
# the wrapper: CUDA tensor -> kernel E1, CPU tensor -> plain version
# ---------------------------------------------------------------------------

_SIGNATURES = {
    "m3_pack_encode": [_build.P] * 7 + [_build.I, _build.I, _build.I, _build.LL,
                                        _build.P, _build.P, _build.P],
}


def pack_encode(timestamps: torch.Tensor, start: torch.Tensor, n_valid: torch.Tensor,
                ctl_bits: torch.Tensor, ctl_n: torch.Tensor, pay_bits: torch.Tensor,
                pay_n: torch.Tensor):
    """Time fields + wire packing of L series.

    timestamps i64[L, T] unix nanos, start i64[L] stream start, n_valid
    i32[L], and the value fields of ``prepare_value_fields``: ctl_bits and
    pay_bits u64 (or int64 bit patterns) [L, T], ctl_n and pay_n i32[L, T].

    Returns (words u32[L, n_words_for(T)] big-endian, nbits i32[L]: the
    exact bit length including the EOS marker; 0 for an empty lane).
    """
    if timestamps.dim() != 2:
        raise ValueError(f"timestamps must be [L, T], got {tuple(timestamps.shape)}")
    L, T = timestamps.shape
    args = (timestamps, start, n_valid, ctl_bits, ctl_n, pay_bits, pay_n)
    for name, x, shape in zip(("start", "n_valid", "ctl_bits", "ctl_n", "pay_bits", "pay_n"),
                              args[1:], ((L,), (L,)) + ((L, T),) * 4):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.device != timestamps.device:
            raise ValueError(f"{name} is on {x.device}, timestamps on {timestamps.device}")
    if timestamps.device.type == "cpu":
        return pack_encode_plain(*args)
    if not timestamps.is_cuda:
        raise ValueError(f"unsupported device {timestamps.device}")
    return _launch(timestamps.to(I64).contiguous(), start.to(I64).contiguous(),
                   n_valid.to(I32).contiguous(), _as_i64(ctl_bits).contiguous(),
                   ctl_n.to(I32).contiguous(), _as_i64(pay_bits).contiguous(),
                   pay_n.to(I32).contiguous())


def _launch(ts, st, nv, cb, cn, pb, pn):
    """E1 on contiguous tensors of the card, in ``pack_encode``'s types."""
    L, T = ts.shape
    W = n_words_for(T)
    dev = ts.device
    words = torch.empty((L, W), dtype=torch.uint32, device=dev)
    nbits = torch.empty((L,), dtype=I32, device=dev)
    if L:
        lib = _build.library("m3tsz_encode", _SIGNATURES)
        rc = lib.m3_pack_encode(ts.data_ptr(), st.data_ptr(), nv.data_ptr(), cb.data_ptr(),
                                cn.data_ptr(), pb.data_ptr(), pn.data_ptr(), L, T, W, _SECOND,
                                words.data_ptr(), nbits.data_ptr(),
                                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, rc, "pack_encode")
        _build.count_launch("pack_encode")
    return words, nbits


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def n_words_for(n_dp: int) -> int:
    max_bits = _MAX_BITS_FIRST + max(n_dp - 1, 0) * _MAX_BITS_NEXT + _EOS_BITS
    return (max_bits + 31) // 32 + PAD_WORDS + 1


def encode_batched(timestamps, values, start, n_valid, device=None):
    """Encode L series in parallel into M3TSZ wire streams.

    timestamps: [L, T] int64 unix-nanos (second-aligned, ascending)
    values:     [L, T] float64; the value grammar runs on the host
                (``native/m3tsz_prepare.cc``)
    start:      [L] int64 stream (block) start unix-nanos
    n_valid:    [L] int32 datapoints per lane (left-aligned ragged)

    Host arrays in; runs kernel E1 on the CUDA device unless
    ``device="cpu"``.  Returns (words u32[L, W] big-endian, nbits i32[L])
    on that device.
    """
    dev = resolve_device(device)
    n_valid = np.ascontiguousarray(n_valid, dtype=np.int32)
    cb, cn, pb, pn = prepare_value_fields_native(np.asarray(values, dtype=np.float64), n_valid)
    host = (np.asarray(timestamps, dtype=np.int64), np.asarray(start, dtype=np.int64), n_valid,
            cb.view(np.int64), cn, pb.view(np.int64), pn)
    return pack_encode(*(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in host))


def encode_to_streams(timestamps, values, start, n_valid, device=None) -> list[bytes]:
    """Host convenience: batched encode -> per-lane wire bytes."""
    words, nbits = encode_batched(timestamps, values, start, n_valid, device=device)
    words = words.cpu().numpy()
    nbits = nbits.cpu().numpy()
    capacity = (words.shape[1] - PAD_WORDS - 1) * 32
    if nbits.size and int(nbits.max()) > capacity:
        raise ValueError(f"encoded stream of {int(nbits.max())} bits exceeds the word "
                         f"capacity of {capacity}")
    return [unpack_stream(words[i], ((int(nbits[i]) + 7) // 8) * 8)
            for i in range(words.shape[0])]
