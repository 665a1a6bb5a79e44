"""Containerized bitmap postings over the series-ordinal universe.

The reference's postings lists are roaring bitmaps (ref:
src/m3ninx/postings/roaring/roaring.go:82; Chambi et al., "Better
bitmap performance with Roaring bitmaps"): containerized so that dense
sets pay O(universe/64) words and sparse sets pay O(n) entries, with
set algebra running as vectorized word ops instead of per-element
merges.  This module is the numpy rendering of that idea for the
index's ordinal universe (ordinal == device lane id, dense from 0):

* a term's postings are ONE container — either a sorted ``int64``
  ordinal array (sparse) or packed ``uint64`` bitset words covering
  the term's ordinal span (dense); the container is chosen per term
  by density at freeze time (:meth:`Postings.from_sorted`);
* query-time set algebra materializes each matcher into a
  universe-width word array and folds the whole matcher tree in one
  fused bitwise pass (``np.bitwise_and.reduce`` over stacked words) —
  see ``TagIndex.query_conjunction``;
* results decode back to sorted ordinals ONCE at the end, with
  cumulative-popcount truncation so a series limit never pays for
  ordinals it will drop.

Bit layout: bit ``k`` of the word array is ordinal ``k`` — word
``k >> 6``, bit ``k & 63``.  Word arrays are little-endian-viewed as
bytes for numpy's ``packbits``/``unpackbits`` (``bitorder="little"``),
which matches the native uint64 layout on every platform this runs on
(x86-64 / aarch64); persisted ``.npy`` files carry the dtype byte
order, so v2 segments are mmap-able without conversion.
"""

from __future__ import annotations

import numpy as np

WORD_BITS = 64

# byte-wise popcount table; uint16 so row sums of 8 bytes never wrap
_POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint16)

_U64_1 = np.uint64(1)


def n_words(universe: int) -> int:
    """Words needed to cover ordinals ``[0, universe)``."""
    return (int(universe) + 63) >> 6


def set_bits(words: np.ndarray, ordinals: np.ndarray, base: int = 0) -> None:
    """Set ``ordinals - base`` in ``words`` in place (dedup-safe).

    Two regimes: a scatter via ``np.bitwise_or.at`` for sparse
    batches, and a bool-unpack/packbits pass when the batch is large
    relative to the span (the per-element scatter would dominate).
    """
    o = np.asarray(ordinals, dtype=np.int64)
    if base:
        o = o - base
    if not len(o):
        return
    if len(o) >= len(words) * 8:
        bits = np.zeros(len(words) * WORD_BITS, dtype=bool)
        bits[o] = True
        words |= np.packbits(bits, bitorder="little").view(np.uint64)
    else:
        np.bitwise_or.at(words, o >> 6, _U64_1 << (o & 63).astype(np.uint64))


def words_from_ordinals(ordinals: np.ndarray, nw: int,
                        base: int = 0) -> np.ndarray:
    """Fresh word array of ``nw`` words with ``ordinals - base`` set."""
    w = np.zeros(nw, dtype=np.uint64)
    set_bits(w, ordinals, base)
    return w


def popcount(words: np.ndarray) -> int:
    """Total set bits."""
    if not len(words):
        return 0
    return int(_POP8[np.asarray(words).view(np.uint8)].sum(dtype=np.int64))


def popcount_per_word(words: np.ndarray) -> np.ndarray:
    """Set bits per word, ``int64[len(words)]``."""
    if not len(words):
        return np.zeros(0, dtype=np.int64)
    return _POP8[np.ascontiguousarray(words).view(np.uint8)] \
        .reshape(-1, 8).sum(axis=1, dtype=np.int64)


def ordinals_from_words(words: np.ndarray, base: int = 0,
                        limit: int | None = None) -> np.ndarray:
    """Decode set bits to sorted absolute ordinals.

    Sparse-aware: only nonzero words are unpacked (a narrow
    conjunction result over a 10M universe touches a handful of
    words, not 1.25MB of zeros).  With ``limit``, a cumulative
    popcount over the nonzero words finds the cut word so decode
    never materializes ordinals past the truncation point
    (``limits.enforce_series``).
    """
    words = np.asarray(words)
    nz = np.flatnonzero(words)
    if not len(nz):
        return np.zeros(0, dtype=np.int64)
    sub = words[nz]  # gather -> fresh contiguous array
    if limit is not None:
        cum = np.cumsum(popcount_per_word(sub))
        cut = int(np.searchsorted(cum, limit, side="left")) + 1
        nz, sub = nz[:cut], sub[:cut]
    bits = np.unpackbits(sub.view(np.uint8), bitorder="little") \
        .reshape(len(nz), WORD_BITS)
    rows, cols = np.nonzero(bits)  # row-major -> ascending ordinals
    out = (nz[rows].astype(np.int64) << 6) + cols
    if base:
        out += base
    if limit is not None and len(out) > limit:
        out = out[:limit]
    return out


class Postings:
    """One term's immutable postings container.

    ``arr`` — sorted absolute ``int64`` ordinals (sparse container) —
    or ``words`` + ``base_word`` — packed ``uint64`` bitset whose bit
    ``k`` is ordinal ``base_word * 64 + k`` (dense container).  The
    base is word-aligned so universe materialization is a pure slice
    OR with no bit shifting.
    """

    __slots__ = ("arr", "words", "base_word", "_n")

    def __init__(self, arr: np.ndarray | None = None,
                 words: np.ndarray | None = None,
                 base_word: int = 0, n: int | None = None):
        self.arr = arr
        self.words = words
        self.base_word = int(base_word)
        self._n = n if n is None else int(n)

    @property
    def is_bitmap(self) -> bool:
        return self.words is not None

    @property
    def n(self) -> int:
        # lazy for bitmap containers: or_into/to_ordinals never need it
        if self._n is None:
            self._n = (len(self.arr) if self.arr is not None
                       else popcount(self.words))
        return self._n

    def __len__(self) -> int:
        return self.n

    @property
    def nbytes(self) -> int:
        data = self.words if self.words is not None else self.arr
        return int(data.nbytes)

    @classmethod
    def from_sorted(cls, ordinals: np.ndarray) -> "Postings":
        """Container choice by density: bitmap when its word span is
        strictly smaller than the 8-bytes-per-ordinal array (i.e. the
        term is dense over its own ordinal range)."""
        o = np.asarray(ordinals, dtype=np.int64)
        if not len(o):
            return cls(arr=o)
        base_word = int(o[0]) >> 6
        span_words = (int(o[-1]) >> 6) - base_word + 1
        if span_words < len(o):
            w = words_from_ordinals(o, span_words, base=base_word << 6)
            w.setflags(write=False)
            return cls(words=w, base_word=base_word, n=len(o))
        return cls(arr=o)

    def to_ordinals(self) -> np.ndarray:
        """Sorted absolute ordinals (fresh array for bitmaps; the
        array container is returned by reference — callers treat it
        as immutable, and frozen-segment arrays are read-only)."""
        if self.words is None:
            return self.arr
        return ordinals_from_words(self.words, base=self.base_word << 6)

    def or_into(self, universe: np.ndarray) -> None:
        """OR this container into a universe-width word array."""
        if self.words is not None:
            lo = self.base_word
            hi = min(lo + len(self.words), len(universe))
            if hi > lo:
                universe[lo:hi] |= self.words[: hi - lo]
        elif self.arr is not None and len(self.arr):
            set_bits(universe, self.arr)


class MutableBitmap:
    """Growable bitmap for per-block activity tracking.

    ``mark_active_batch`` is a vectorized bit-set (dedup is free:
    setting a bit twice is idempotent, so no frozen-membership probe
    is needed on the write path); capacity grows geometrically with
    the highest ordinal touched.
    """

    __slots__ = ("words",)

    def __init__(self, nw: int = 16):
        self.words = np.zeros(max(int(nw), 1), dtype=np.uint64)

    def _ensure(self, max_ordinal: int) -> None:
        need = (int(max_ordinal) >> 6) + 1
        if need > len(self.words):
            grown = np.zeros(max(need, 2 * len(self.words)),
                             dtype=np.uint64)
            grown[: len(self.words)] = self.words
            self.words = grown

    def add(self, ordinal: int) -> None:
        self._ensure(ordinal)
        self.words[ordinal >> 6] |= _U64_1 << np.uint64(ordinal & 63)

    def add_batch(self, ordinals: np.ndarray) -> None:
        o = np.asarray(ordinals, dtype=np.int64)
        if not len(o):
            return
        self._ensure(int(o.max()))
        set_bits(self.words, o)

    def or_into(self, universe: np.ndarray) -> None:
        k = min(len(self.words), len(universe))
        universe[:k] |= self.words[:k]

    @property
    def count(self) -> int:
        return popcount(self.words)

    def to_frozen(self) -> np.ndarray | None:
        """Trimmed read-only word array, or None when no bit is set."""
        nz = np.flatnonzero(self.words)
        if not len(nz):
            return None
        w = self.words[: int(nz[-1]) + 1].copy()
        w.setflags(write=False)
        return w
