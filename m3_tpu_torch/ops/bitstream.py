"""Batched bitstream layout + the plain versions of the 64-bit bit primitives.

A batch of L compressed series is a ``[L, W]`` uint32 tensor: stream bit 0
is the MSB of word 0 (big-endian byte packing).  Two zero words of tail
padding let every window read past the end of the shortest stream.

PyTorch has no shifts, adds or compares for ``uint64`` on the CPU, so the
plain versions below hold 64-bit words as ``int64`` bit patterns: a
logical right shift is an arithmetic one followed by a mask (``srl``), and
``clz64`` is a branchless binary search.  The CUDA kernels use the
hardware's unsigned 64-bit arithmetic and ``__clzll``/``__ffsll`` instead.
"""

from __future__ import annotations

import numpy as np
import torch

PAD_WORDS = 2

I64 = torch.int64
I32 = torch.int32


def pack_streams(streams: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Pack byte streams into ``([L, W] uint32 big-endian words, [L] bit lengths)``.

    Vectorized: one concatenation + one fancy-index scatter instead of a
    per-stream Python loop — fan-out reads pack tens of thousands of
    block streams per query and the loop was a measured host-side
    hotspot."""
    lens = np.asarray([len(s) for s in streams], dtype=np.int64)
    nbits = (lens * 8).astype(np.int32)
    max_words = int((lens.max() + 3) // 4) if len(lens) else 0
    out = np.zeros((len(streams), (max_words + PAD_WORDS) * 4),
                   dtype=np.uint8)
    total = int(lens.sum())
    if total:
        flat = np.frombuffer(b"".join(streams), dtype=np.uint8)
        row = np.repeat(np.arange(len(streams)), lens)
        starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
        col = np.arange(total) - np.repeat(starts, lens)
        out[row, col] = flat
    words = out.view(">u4").astype(np.uint32)
    return words, nbits


def unpack_stream(words: np.ndarray, nbits: int) -> bytes:
    """Inverse of pack_streams for one lane."""
    nbytes = (int(nbits) + 7) // 8
    return np.asarray(words, dtype=">u4").tobytes()[:nbytes]


def bitcast_i64(x: torch.Tensor) -> torch.Tensor:
    """Unsigned words as int64 bit patterns (uint32 zero-extends)."""
    if x.dtype == torch.uint64:
        return x.view(I64)
    if x.dtype == torch.uint32:
        return x.view(I32).to(I64) & 0xFFFFFFFF
    return x.to(I64)


def srl(x: torch.Tensor, n) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by ``n`` in [0, 63].

    The mask ``~((-1 << (63 - n)) << 1)`` keeps the low ``64 - n`` bits
    without ever shifting by 64."""
    return (x >> n) & ~((-1 << (63 - n)) << 1) if isinstance(n, int) else (
        (x >> n) & ~((torch.full_like(x, -1) << (63 - n)) << 1))


def clz64(x: torch.Tensor) -> torch.Tensor:
    """Leading-zero count of 64-bit patterns (clz(0) == 64), as int32."""
    n = torch.zeros(x.shape, dtype=I32, device=x.device)
    y = x
    for s in (32, 16, 8, 4, 2, 1):
        top_zero = srl(y, 64 - s) == 0
        n = n + torch.where(top_zero, s, 0).to(I32)
        y = torch.where(top_zero, y << s, y)
    return torch.where(x == 0, 64, n).to(I32)


def ctz64(x: torch.Tensor) -> torch.Tensor:
    """Trailing-zero count of 64-bit patterns (ctz(0) == 0, matching the
    reference's LeadingAndTrailingZeros which reports (64, 0) for zero —
    ref: src/dbnode/encoding/encoding.go:35-43)."""
    lsb = x & (~x + 1)
    return torch.where(x == 0, 0, 63 - clz64(lsb)).to(I32)


def take_top(window: torch.Tensor, n) -> torch.Tensor:
    """Top ``n`` bits of a 64-bit window, right-aligned; n == 0 yields 0.

    ``n`` may be a per-lane tensor (0..64)."""
    n = torch.as_tensor(n, dtype=I64, device=window.device)
    shift = torch.where(n == 0, 0, 64 - n)
    return torch.where(n == 0, 0, srl(window, shift))
