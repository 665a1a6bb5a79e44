"""Bit-level stream IO for the host-side (oracle) codecs.

Behavioral parity target: src/dbnode/encoding/ostream.go (WriteBits writes
the lowest `n` bits of a value MSB-first into the byte stream) and
src/dbnode/encoding/istream.go (ReadBits / PeekBits).  The implementation
is a simple Python bytearray bit cursor — the device codecs in
m3_tpu_torch/ops/ do not use this; it exists as the wire-compat reference and
for file metadata.
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit writer onto a growable bytearray."""

    def __init__(self) -> None:
        self.buf = bytearray()
        self.bitpos = 0  # bits used in the last byte, 0 == byte-aligned

    def write_bit(self, bit: int) -> None:
        self.write_bits(bit & 1, 1)

    def write_bits(self, value: int, nbits: int) -> None:
        """Write the low `nbits` of value, most-significant bit first."""
        if nbits == 0:
            return
        value &= (1 << nbits) - 1
        remaining = nbits
        while remaining > 0:
            if self.bitpos == 0:
                self.buf.append(0)
            free = 8 - self.bitpos
            take = min(free, remaining)
            chunk = (value >> (remaining - take)) & ((1 << take) - 1)
            self.buf[-1] |= chunk << (free - take)
            self.bitpos = (self.bitpos + take) % 8
            remaining -= take

    def write_byte(self, b: int) -> None:
        self.write_bits(b & 0xFF, 8)

    def write_bytes(self, bs: bytes) -> None:
        for b in bs:
            self.write_bits(b, 8)

    def __len__(self) -> int:
        return len(self.buf)

    def raw(self) -> tuple[bytes, int]:
        """(bytes so far, bit position within last byte; 0 means aligned/full)."""
        return bytes(self.buf), self.bitpos


class BitReader:
    """MSB-first bit reader over bytes with peek support."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0  # absolute bit cursor

    @property
    def remaining_bits(self) -> int:
        return len(self.data) * 8 - self.pos

    def read_bits(self, nbits: int) -> int:
        v = self.peek_bits(nbits)
        self.pos += nbits
        return v

    def peek_bits(self, nbits: int) -> int:
        if nbits > self.remaining_bits:
            raise EOFError(f"need {nbits} bits, have {self.remaining_bits}")
        out = 0
        pos = self.pos
        remaining = nbits
        while remaining > 0:
            byte = self.data[pos // 8]
            off = pos % 8
            take = min(8 - off, remaining)
            chunk = (byte >> (8 - off - take)) & ((1 << take) - 1)
            out = (out << take) | chunk
            pos += take
            remaining -= take
        return out

    def read_bit(self) -> int:
        return self.read_bits(1)

    def read_byte(self) -> int:
        return self.read_bits(8)

    def read_bytes(self, n: int) -> bytes:
        return bytes(self.read_byte() for _ in range(n))


def sign_extend(v: int, nbits: int) -> int:
    """Interpret the low `nbits` of v as two's complement (ref: encoding.go:46)."""
    v &= (1 << nbits) - 1
    if v & (1 << (nbits - 1)):
        v -= 1 << nbits
    return v


def num_sig_bits(v: int) -> int:
    """Number of significant bits of a non-negative int (ref: encoding.go:29)."""
    return v.bit_length()


def leading_trailing_zeros64(v: int) -> tuple[int, int]:
    """(leading, trailing) zero counts of a uint64 (ref: encoding.go:35-43)."""
    if v == 0:
        return 64, 0
    return 64 - v.bit_length(), (v & -v).bit_length() - 1


def zigzag_varint_encode(v: int) -> bytes:
    """Go binary.PutVarint: zigzag then uvarint (used for annotation lengths)."""
    u = (v << 1) if v >= 0 else ((-v) << 1) - 1
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def zigzag_varint_decode(reader: BitReader) -> int:
    """Go binary.ReadVarint over a bit stream."""
    u = 0
    shift = 0
    while True:
        b = reader.read_byte()
        u |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return (u >> 1) ^ -(u & 1)
