"""Scalar, wire-compatible M3TSZ codec — the host-side oracle.

This is the reference semantics for the device codecs in
``m3tsz_decode.py`` / ``m3tsz_encode.py`` and the wire-compat edge for
files and RPC.  The bit grammar is documented in ``docs/m3tsz_format.md``
and was derived from the reference implementation
(ref: src/dbnode/encoding/m3tsz/{encoder.go,iterator.go,
timestamp_encoder.go:67-213, timestamp_iterator.go:70-284,
float_encoder_iterator.go:47-166, int_sig_bits_tracker.go:35-91,
m3tsz.go:28-139} and src/dbnode/encoding/scheme.go:28-63).

Grammar summary (int-optimized stream, the production default):

    stream   := start64 first_dp dp* eos pad
    start64  := 64-bit unix-nanos of the stream (block) start
    dp       := [ann_marker] [tu_marker] dod value
    dod      := '0'                                    (delta-of-delta == 0)
              | '10'   s7                              (7-bit signed dod)
              | '110'  s9
              | '1110' s12
              | '1111' s32           (s64 for us/ns units; raw s64 after a
                                      time-unit change)
    marker   := '100000000' v2       (9-bit opcode 0x100 + 2-bit value:
                                      0 eos, 1 annotation, 2 time-unit)
    value    := first: mode_bit ('1' raw64 | '0' sigmult intdiff)
              | next:  '0' ('1'                        (repeat)
                           |'0' ('1' raw64             (switch to float)
                                |'0' sigmult intdiff)) (int state update)
              | next:  '1' (float? xor : intdiff)      (no state update)
    sigmult  := sig_update mult_update
    intdiff  := sign_bit  uN          (N = tracked significant bits;
                                       sign '1' means add, '0' subtract)
    xor      := '0' | '10' meaningful(prev L/T) | '11' L6 (M-1)6 meaningful
"""

from __future__ import annotations

import dataclasses
import math
import struct

from m3_tpu_torch.utils import xtime
from m3_tpu_torch.utils.bitio import (
    BitReader,
    BitWriter,
    leading_trailing_zeros64,
    num_sig_bits,
    sign_extend,
    zigzag_varint_decode,
    zigzag_varint_encode,
)

# --- scheme constants (ref: src/dbnode/encoding/scheme.go:28-63) ---
MARKER_OPCODE = 0x100
MARKER_OPCODE_BITS = 9
MARKER_VALUE_BITS = 2
MARKER_EOS = 0
MARKER_ANNOTATION = 1
MARKER_TIME_UNIT = 2

# (opcode, opcode_bits, value_bits) smallest-first; constructed per
# scheme.go:145-164: opcodes 10, 110, 1110; default 1111.
TIME_BUCKETS = ((0b10, 2, 7), (0b110, 3, 9), (0b1110, 4, 12))
DEFAULT_VALUE_BITS = {  # default catch-all bucket width per unit
    xtime.Unit.SECOND: 32,
    xtime.Unit.MILLISECOND: 32,
    xtime.Unit.MICROSECOND: 64,
    xtime.Unit.NANOSECOND: 64,
}

# --- value-stream opcodes (ref: m3tsz.go:32-55) ---
OP_FLOAT_MODE = 1
OP_INT_MODE = 0
OP_UPDATE = 0  # note: "update" branch is bit 0, "no update" is bit 1
OP_NO_UPDATE = 1
OP_REPEAT = 1
OP_NO_REPEAT = 0
OP_UPDATE_SIG = 1
OP_UPDATE_MULT = 1
OP_ADD = 1  # opcodeNegative on the wire; decoder adds when set
NUM_SIG_BITS_FIELD = 6
NUM_MULT_BITS = 3

SIG_DIFF_THRESHOLD = 3  # ref: m3tsz.go:57
SIG_REPEAT_THRESHOLD = 5  # ref: m3tsz.go:58
MAX_MULT = 6
MAX_OPT_INT = 10.0**13  # ref: m3tsz.go:67
MAX_INT64 = float(2**63)
MULTIPLIERS = [10.0**i for i in range(MAX_MULT + 1)]


def float_bits(v: float) -> int:
    return struct.unpack("<Q", struct.pack("<d", v))[0]


def bits_float(b: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", b & (2**64 - 1)))[0]


def convert_to_int_float(v: float, cur_max_mult: int) -> tuple[float, int, bool]:
    """Try to express v as (int value, decimal multiplier); returns
    (value, mult, is_float).  Ref: m3tsz.go:78-118."""
    # Go's math.Modf(-Inf) yields a NaN fraction so the reference never
    # takes the quick int path for infinities (ref: m3tsz.go:81-86);
    # Python's modf(-inf) returns frac -0.0, so gate explicitly.
    if cur_max_mult == 0 and v < MAX_INT64 and not math.isinf(v):
        frac, intpart = math.modf(v)
        if frac == 0:
            return intpart, 0, False

    if cur_max_mult > MAX_MULT:
        raise ValueError("invalid multiplier")

    val = v * MULTIPLIERS[cur_max_mult]
    sign = 1.0
    if v < 0:
        sign = -1.0
        val = -val

    mult = cur_max_mult
    while mult <= MAX_MULT and val < MAX_OPT_INT:
        frac, intpart = math.modf(val)
        if frac == 0:
            return sign * intpart, mult, False
        if frac < 0.1:
            # On the knife's edge below an integer: accept if the previous
            # representable float crosses it.
            if math.nextafter(val, 0.0) <= intpart:
                return sign * intpart, mult, False
        elif frac > 0.9:
            nxt = intpart + 1
            if math.nextafter(val, nxt) >= nxt:
                return sign * nxt, mult, False
        val *= 10.0
        mult += 1

    return v, 0, True


def convert_from_int_float(val: float, mult: int) -> float:
    return val if mult == 0 else val / MULTIPLIERS[mult]


@dataclasses.dataclass
class _SigTracker:
    """Hysteresis tracker for the int-diff significant-bit width
    (ref: int_sig_bits_tracker.go:68-91)."""

    num_sig: int = 0
    cur_highest_lower: int = 0
    num_lower: int = 0

    def track(self, num_sig: int) -> int:
        new_sig = self.num_sig
        if num_sig > self.num_sig:
            new_sig = num_sig
        elif self.num_sig - num_sig >= SIG_DIFF_THRESHOLD:
            if self.num_lower == 0 or num_sig > self.cur_highest_lower:
                self.cur_highest_lower = num_sig
            self.num_lower += 1
            if self.num_lower >= SIG_REPEAT_THRESHOLD:
                new_sig = self.cur_highest_lower
                self.num_lower = 0
        else:
            self.num_lower = 0
        return new_sig


class Encoder:
    """Streaming M3TSZ encoder, wire-compatible with the reference."""

    def __init__(
        self,
        start_nanos: int,
        int_optimized: bool = True,
        default_unit: xtime.Unit = xtime.Unit.SECOND,
    ) -> None:
        self.w = BitWriter()
        self.int_optimized = int_optimized
        self.default_unit = default_unit
        # timestamp state
        self.prev_time = start_nanos
        self.prev_delta = 0
        self.time_unit = xtime.initial_time_unit(start_nanos, default_unit)
        self.prev_annotation: bytes = b""
        # value state
        self.num_encoded = 0
        self.prev_float_bits = 0
        self.prev_xor = 0
        self.int_val = 0.0
        self.max_mult = 0
        self.is_float = False
        self.sig = _SigTracker()

    # --- timestamps ---

    def _write_marker(self, marker: int) -> None:
        self.w.write_bits(MARKER_OPCODE, MARKER_OPCODE_BITS)
        self.w.write_bits(marker, MARKER_VALUE_BITS)

    def _write_annotation(self, annotation: bytes) -> None:
        if not annotation or annotation == self.prev_annotation:
            return
        self._write_marker(MARKER_ANNOTATION)
        self.w.write_bytes(zigzag_varint_encode(len(annotation) - 1))
        self.w.write_bytes(annotation)
        self.prev_annotation = annotation

    def _write_time(self, t_nanos: int, annotation: bytes, unit: xtime.Unit) -> None:
        if self.num_encoded == 0:
            # First ever record: raw 64-bit stream start, then the first
            # datapoint encoded as a regular delta record.
            self.w.write_bits(self.prev_time & (2**64 - 1), 64)
        self._write_annotation(annotation)
        tu_changed = False
        if unit.is_valid() and unit != self.time_unit:
            self._write_marker(MARKER_TIME_UNIT)
            self.w.write_byte(int(unit))
            self.time_unit = unit
            tu_changed = True
        delta = t_nanos - self.prev_time
        self.prev_time = t_nanos
        if tu_changed:
            # Deltas can no longer be assumed unit-multiples: emit a raw
            # 64-bit nano dod and restart the delta chain.
            dod = delta - self.prev_delta
            self.w.write_bits(dod & (2**64 - 1), 64)
            self.prev_delta = 0
            return
        if self.time_unit not in DEFAULT_VALUE_BITS:
            # Same failure mode as the reference, which refuses units with
            # no time-encoding scheme at encode time
            # (ref: timestamp_encoder.go:190-193).
            raise ValueError(f"no time encoding scheme for time unit {self.time_unit}")
        unit_nanos = self.time_unit.nanos
        raw_dod = delta - self.prev_delta
        # Truncate toward zero like Go integer division (x/time ToNormalizedDuration).
        dod = -((-raw_dod) // unit_nanos) if raw_dod < 0 else raw_dod // unit_nanos
        self.prev_delta = delta
        if dod == 0:
            self.w.write_bit(0)
            return
        for opcode, opcode_bits, value_bits in TIME_BUCKETS:
            lo = -(1 << (value_bits - 1))
            hi = (1 << (value_bits - 1)) - 1
            if lo <= dod <= hi:
                self.w.write_bits(opcode, opcode_bits)
                self.w.write_bits(dod & ((1 << value_bits) - 1), value_bits)
                return
        value_bits = DEFAULT_VALUE_BITS[self.time_unit]
        self.w.write_bits(0b1111, 4)
        self.w.write_bits(dod & ((1 << value_bits) - 1), value_bits)

    # --- float values ---

    def _write_full_float(self, bits: int) -> None:
        self.w.write_bits(bits, 64)
        self.prev_float_bits = bits
        self.prev_xor = bits

    def _write_float_xor(self, bits: int) -> None:
        xor = self.prev_float_bits ^ bits
        if xor == 0:
            self.w.write_bit(0)
        else:
            prev_lead, prev_trail = leading_trailing_zeros64(self.prev_xor)
            lead, trail = leading_trailing_zeros64(xor)
            if lead >= prev_lead and trail >= prev_trail:
                self.w.write_bits(0b10, 2)
                self.w.write_bits(xor >> prev_trail, 64 - prev_lead - prev_trail)
            else:
                meaningful = 64 - lead - trail
                self.w.write_bits(0b11, 2)
                self.w.write_bits(lead, 6)
                self.w.write_bits(meaningful - 1, 6)
                self.w.write_bits(xor >> trail, meaningful)
        self.prev_xor = xor
        self.prev_float_bits = bits

    # --- int-optimized values ---

    def _write_int_sig_mult(self, sig: int, mult: int, float_changed: bool) -> None:
        if self.sig.num_sig != sig:
            self.w.write_bit(OP_UPDATE_SIG)
            if sig == 0:
                self.w.write_bit(0)
            else:
                self.w.write_bit(1)
                self.w.write_bits(sig - 1, NUM_SIG_BITS_FIELD)
        else:
            self.w.write_bit(1 - OP_UPDATE_SIG)
        self.sig.num_sig = sig

        if mult > self.max_mult:
            self.w.write_bit(OP_UPDATE_MULT)
            self.w.write_bits(mult, NUM_MULT_BITS)
            self.max_mult = mult
        elif self.sig.num_sig == sig and self.max_mult == mult and float_changed:
            # Mode flip with no sig/mult change still re-writes the mult so a
            # decoder can re-sync state after an annotation peek.
            self.w.write_bit(OP_UPDATE_MULT)
            self.w.write_bits(self.max_mult, NUM_MULT_BITS)
        else:
            self.w.write_bit(1 - OP_UPDATE_MULT)

    def _write_int_diff(self, diff_abs: int, add: bool) -> None:
        self.w.write_bit(OP_ADD if add else 1 - OP_ADD)
        self.w.write_bits(diff_abs, self.sig.num_sig)

    def _write_first_value(self, v: float) -> None:
        if not self.int_optimized:
            self._write_full_float(float_bits(v))
            return
        val, mult, is_float = convert_to_int_float(v, 0)
        if is_float:
            self.w.write_bit(OP_FLOAT_MODE)
            self._write_full_float(float_bits(v))
            self.is_float = True
            self.max_mult = mult
            return
        self.w.write_bit(OP_INT_MODE)
        self.int_val = val
        add = val >= 0
        # Cap magnitude at 64 bits like the Go uint64(int64(val)) conversion
        # (huge integral floats slip past convertToIntFloat's quick check);
        # an uncapped width would overflow the 6-bit sig field and produce
        # an undecodable stream.
        mag = min(int(abs(val)), 2**63)
        self._write_int_sig_mult(num_sig_bits(mag), mult, False)
        self._write_int_diff(mag, add)

    def _write_next_value(self, v: float) -> None:
        if not self.int_optimized:
            self._write_float_xor(float_bits(v))
            return
        val, mult, is_float = convert_to_int_float(v, self.max_mult)
        diff = 0.0 if is_float else self.int_val - val
        if is_float or diff >= MAX_INT64 or diff <= -MAX_INT64:
            self._write_float_transition(float_bits(val), mult)
            return
        self._write_int_val(val, mult, is_float, diff)

    def _write_float_transition(self, bits: int, mult: int) -> None:
        if not self.is_float:
            self.w.write_bit(OP_UPDATE)
            self.w.write_bit(OP_NO_REPEAT)
            self.w.write_bit(OP_FLOAT_MODE)
            self._write_full_float(bits)
            self.is_float = True
            self.max_mult = mult
            return
        if bits == self.prev_float_bits:
            self.w.write_bit(OP_UPDATE)
            self.w.write_bit(OP_REPEAT)
            return
        self.w.write_bit(OP_NO_UPDATE)
        self._write_float_xor(bits)

    def _write_int_val(self, val: float, mult: int, is_float: bool, diff: float) -> None:
        if diff == 0 and is_float == self.is_float and mult == self.max_mult:
            self.w.write_bit(OP_UPDATE)
            self.w.write_bit(OP_REPEAT)
            return
        add = diff < 0  # encoder stores prev-new; "add" bit set when new > prev
        mag = int(abs(diff))
        new_sig = self.sig.track(num_sig_bits(mag))
        float_changed = is_float != self.is_float
        if mult > self.max_mult or self.sig.num_sig != new_sig or float_changed:
            self.w.write_bit(OP_UPDATE)
            self.w.write_bit(OP_NO_REPEAT)
            self.w.write_bit(OP_INT_MODE)
            self._write_int_sig_mult(new_sig, mult, float_changed)
            self._write_int_diff(mag, add)
            self.is_float = False
        else:
            self.w.write_bit(OP_NO_UPDATE)
            self._write_int_diff(mag, add)
        self.int_val = val

    # --- public API ---

    def encode(
        self,
        t_nanos: int,
        value: float,
        annotation: bytes = b"",
        unit: xtime.Unit | None = None,
    ) -> None:
        unit = unit if unit is not None else self.default_unit
        self._write_time(t_nanos, annotation, unit)
        if self.num_encoded == 0:
            self._write_first_value(value)
        else:
            self._write_next_value(value)
        self.num_encoded += 1

    def finalize(self) -> bytes:
        """Cap the stream with an end-of-stream marker and byte padding.

        Equivalent to the reference's head+precomputed-tail construction
        (ref: scheme.go:243-258, encoder.go:381-416).
        """
        if self.num_encoded == 0:
            return b""
        w = BitWriter()
        w.buf = bytearray(self.w.buf)
        w.bitpos = self.w.bitpos
        w.write_bits(MARKER_OPCODE, MARKER_OPCODE_BITS)
        w.write_bits(MARKER_EOS, MARKER_VALUE_BITS)
        return bytes(w.buf)


@dataclasses.dataclass
class Datapoint:
    t_nanos: int
    value: float
    annotation: bytes = b""
    unit: xtime.Unit = xtime.Unit.SECOND


class Decoder:
    """Streaming M3TSZ decoder, wire-compatible with the reference."""

    def __init__(
        self,
        data: bytes,
        int_optimized: bool = True,
        default_unit: xtime.Unit = xtime.Unit.SECOND,
    ) -> None:
        self.r = BitReader(data)
        self.int_optimized = int_optimized
        self.default_unit = default_unit
        self.first = True
        self.done = False
        # timestamp state
        self.prev_time = 0
        self.prev_delta = 0
        self.time_unit = xtime.Unit.NONE
        self.time_unit_changed = False
        self.annotation: bytes = b""
        # value state
        self.prev_float_bits = 0
        self.prev_xor = 0
        self.int_val = 0.0
        self.sig = 0
        self.mult = 0
        self.is_float = False

    # --- timestamps ---

    def _try_marker(self) -> tuple[int | None, bool]:
        """Peek for a marker; returns (dod, handled).  Mirrors the
        reference's look-ahead (ref: timestamp_iterator.go:147-201)."""
        total = MARKER_OPCODE_BITS + MARKER_VALUE_BITS
        try:
            peeked = self.r.peek_bits(total)
        except EOFError:
            return None, False
        if peeked >> MARKER_VALUE_BITS != MARKER_OPCODE:
            return None, False
        marker = peeked & ((1 << MARKER_VALUE_BITS) - 1)
        if marker == MARKER_EOS:
            self.r.read_bits(total)
            self.done = True
            return 0, True
        if marker == MARKER_ANNOTATION:
            self.r.read_bits(total)
            n = zigzag_varint_decode(self.r) + 1
            self.annotation = self.r.read_bytes(n)
            return self._read_marker_or_dod(), True
        if marker == MARKER_TIME_UNIT:
            self.r.read_bits(total)
            try:
                unit = xtime.Unit(self.r.read_byte())
            except ValueError as e:
                raise ValueError(f"corrupt stream: {e}") from None
            if unit.is_valid() and unit != self.time_unit:
                self.time_unit_changed = True
            self.time_unit = unit
            return self._read_marker_or_dod(), True
        return None, False

    def _read_marker_or_dod(self) -> int:
        dod, handled = self._try_marker()
        if self.done:
            return 0
        if handled:
            return dod
        return self._read_dod()

    def _read_dod(self) -> int:
        if self.time_unit_changed:
            return sign_extend(self.r.read_bits(64), 64)
        if self.time_unit not in DEFAULT_VALUE_BITS:
            # Same failure the reference reports for a corrupt/unit-less
            # stream (ref: timestamp_iterator.go:218-221).
            raise ValueError(f"no time encoding scheme for time unit {self.time_unit}")
        cb = self.r.read_bit()
        if cb == 0:
            return 0
        for opcode, opcode_bits, value_bits in TIME_BUCKETS:
            cb = (cb << 1) | self.r.read_bit()
            if cb == opcode:
                return sign_extend(self.r.read_bits(value_bits), value_bits) * self.time_unit.nanos
        value_bits = DEFAULT_VALUE_BITS[self.time_unit]
        return sign_extend(self.r.read_bits(value_bits), value_bits) * self.time_unit.nanos

    def _read_time(self) -> bool:
        """Advance timestamp state; returns True while not EOS."""
        self.annotation = b""
        if self.first:
            if self.r.remaining_bits == 0:
                self.done = True
                return False
            nt = self.r.read_bits(64)
            if self.time_unit == xtime.Unit.NONE:
                self.time_unit = xtime.initial_time_unit(nt, self.default_unit)
            dod = self._read_marker_or_dod()
            if self.done:
                return False
            self.prev_delta += dod
            self.prev_time = nt + self.prev_delta
            self.first = False
        else:
            dod = self._read_marker_or_dod()
            if self.done:
                return False
            self.prev_delta += dod
            self.prev_time += self.prev_delta
        if self.time_unit_changed:
            self.prev_delta = 0
            self.time_unit_changed = False
        return True

    # --- values ---

    def _read_full_float(self) -> None:
        self.prev_float_bits = self.r.read_bits(64)
        self.prev_xor = self.prev_float_bits

    def _read_float_xor(self) -> None:
        if self.r.read_bit() == 0:
            self.prev_xor = 0
            return
        if self.r.read_bit() == 0:  # contained: reuse prev leading/trailing
            lead, trail = leading_trailing_zeros64(self.prev_xor)
            meaningful = 64 - lead - trail
            self.prev_xor = self.r.read_bits(meaningful) << trail
        else:
            lead = self.r.read_bits(6)
            meaningful = self.r.read_bits(6) + 1
            trail = 64 - lead - meaningful
            self.prev_xor = self.r.read_bits(meaningful) << trail
        self.prev_float_bits ^= self.prev_xor

    def _read_int_sig_mult(self) -> None:
        if self.r.read_bit() == OP_UPDATE_SIG:
            if self.r.read_bit() == 0:
                self.sig = 0
            else:
                self.sig = self.r.read_bits(NUM_SIG_BITS_FIELD) + 1
        if self.r.read_bit() == OP_UPDATE_MULT:
            self.mult = self.r.read_bits(NUM_MULT_BITS)
            if self.mult > MAX_MULT:
                raise ValueError("invalid multiplier")

    def _read_int_diff(self) -> None:
        sign = 1.0 if self.r.read_bit() == OP_ADD else -1.0
        self.int_val += sign * float(self.r.read_bits(self.sig))

    def _read_first_value(self) -> None:
        if not self.int_optimized:
            self._read_full_float()
            return
        if self.r.read_bit() == OP_FLOAT_MODE:
            self._read_full_float()
            self.is_float = True
            return
        self._read_int_sig_mult()
        self._read_int_diff()

    def _read_next_value(self) -> None:
        if not self.int_optimized:
            self._read_float_xor()
            return
        if self.r.read_bit() == OP_UPDATE:
            if self.r.read_bit() == OP_REPEAT:
                return
            if self.r.read_bit() == OP_FLOAT_MODE:
                self._read_full_float()
                self.is_float = True
                return
            self._read_int_sig_mult()
            self._read_int_diff()
            self.is_float = False
            return
        if self.is_float:
            self._read_float_xor()
        else:
            self._read_int_diff()

    # --- public API ---

    def __iter__(self):
        while True:
            first = self.first
            if not self._read_time():
                return
            if first:
                self._read_first_value()
            else:
                self._read_next_value()
            if not self.int_optimized or self.is_float:
                value = bits_float(self.prev_float_bits)
            else:
                value = convert_from_int_float(self.int_val, self.mult)
            yield Datapoint(self.prev_time, value, self.annotation, self.time_unit)


def finest_time_unit(timestamps_nanos) -> xtime.Unit:
    """Coarsest unit that represents every timestamp exactly.

    The dod stream truncates to unit multiples (``raw_dod //
    unit_nanos``), so encoding sub-unit stamps at a coarse unit SHIFTS
    them — a snapshot/flush of millisecond-spaced samples re-read as
    second-spaced ones (and consolidation then drops the collapsed
    duplicates).  Ref: the reference encoder derives the unit from each
    datapoint's Timestamp (timestamp_encoder.go:67) rather than
    assuming seconds.  (A misaligned stream START needs no finer unit:
    the NONE->unit transition emits a raw 64-bit first dod and restarts
    the delta chain, so only inter-stamp deltas see the unit.)"""
    g = xtime.SECOND
    for t in timestamps_nanos:
        r = int(t) % xtime.SECOND
        if r:
            g = math.gcd(g, r)
    for u in (xtime.Unit.SECOND, xtime.Unit.MILLISECOND,
              xtime.Unit.MICROSECOND):
        if g % u.nanos == 0:
            return u
    return xtime.Unit.NANOSECOND


def encode_series(
    timestamps_nanos: list[int],
    values: list[float],
    start_nanos: int,
    int_optimized: bool = True,
    unit: xtime.Unit = xtime.Unit.SECOND,
) -> bytes:
    # Honor an explicit caller unit; for the SECOND default, pick the
    # finest unit the stamps need so encode->decode is lossless (the
    # unit rides the stream as a MARKER_TIME_UNIT, which every decode
    # path — scalar, native, device-with-scalar-fallback — handles).
    use = unit
    if unit == xtime.Unit.SECOND:
        use = finest_time_unit(timestamps_nanos)
    enc = Encoder(start_nanos, int_optimized=int_optimized, default_unit=unit)
    for t, v in zip(timestamps_nanos, values):
        enc.encode(t, v, unit=use)
    return enc.finalize()


def decode_series(
    data: bytes,
    int_optimized: bool = True,
    unit: xtime.Unit = xtime.Unit.SECOND,
) -> tuple[list[int], list[float]]:
    from m3_tpu_torch.ops import decode_counter

    decode_counter.bump()
    dec = Decoder(data, int_optimized=int_optimized, default_unit=unit)
    ts, vs = [], []
    for dp in dec:
        ts.append(dp.t_nanos)
        vs.append(dp.value)
    return ts, vs
