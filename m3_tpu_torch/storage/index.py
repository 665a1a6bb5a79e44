"""Reverse index — series metadata -> postings (the m3ninx equivalent).

Redesigned for scale + persistence (the reference's index stack is
immutable FST segments w/ roaring postings, time-sliced blocks with
mutable->immutable compaction, and a postings cache —
ref: src/m3ninx/index/segment/fst/segment.go:114,
src/m3ninx/postings/roaring/roaring.go:82,
src/dbnode/storage/index.go:582, src/dbnode/storage/index/
mutable_segments.go, src/dbnode/storage/index/postings_list_cache.go).

The TPU-framework design replaces FST+roaring with flat numpy columns —
mmap-able, vectorized set algebra, binary-search term lookup:

* ``SeriesRegistry`` — ordinal <-> (series id, tags).  Ordinals are the
  device lane ids, so they are global and append-only.  The mutable
  tail (python dicts) seals into ``_FrozenRegistry`` segments: byte
  blobs + offset arrays + a sorted-hash lookup column.
* global postings — one term dictionary (not per-block: tags are
  immutable per series, so per-block duplication would buy nothing).
  Mutable tail (dict[(name, value)] -> set) seals into
  ``_FrozenPostings`` segments: lexicographically sorted term keys over
  a byte blob; each term's postings are ONE roaring-style container
  (:mod:`m3_tpu_torch.storage.postings`) — a sorted ordinal array when
  sparse, packed ``uint64`` bitset words when dense, chosen per term
  by density at freeze time.
* fused set algebra — ``query_conjunction`` materializes every matcher
  (eq/neq/re/nre incl. Prometheus absent-label semantics, plus the
  time-range activity prune) into universe-width bitmaps and folds
  the whole matcher tree in ONE vectorized bitwise pass
  (``np.bitwise_and.reduce`` over stacked word rows), decoding back
  to sorted ordinals once at the end — with cumulative-popcount
  truncation so a series limit never materializes ordinals it drops.
* off-write-path compaction — ``seal()`` only builds + APPENDS the new
  frozen segment and publishes an immutable ``(generation, segments)``
  snapshot; geometric segment merging runs in a background daemon
  thread that merges outside the lock and CAS-publishes the new
  segment list (generation bump + postings-cache invalidation), so
  the per-65k-series merge stall is off the insert path entirely.
* per-block activity — time-slicing.  Each retention block tracks the
  bitmap of ordinals active in it (``MutableBitmap`` tail -> frozen
  trimmed word arrays); the time-range prune is an OR over the
  overlapping blocks' bitmaps.  Expired blocks are dropped wholesale.
* postings cache — LRU over frozen-segment query results, invalidated
  by segment generation (the mutable tail is always consulted fresh).

Persistence: ``persist()`` writes every frozen array as its own
``.npy`` (so ``load()`` can mmap), a per-segment MANIFEST with sha256
digests, and an index-level checkpoint written last via tmp+rename —
the reference's checkpoint-last atomicity (ref: persist/fs/write.go:640).
Postings segments persist as format v2 (``post2-``/``blk2-`` dirs with
bitmap-container columns); v1 array-only segments still load.
Restart = mmap segments + replay only the WAL tail; no full rebuild.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import re
import shutil
import struct
import threading
import time
import weakref
from collections import OrderedDict, defaultdict

import numpy as np

from m3_tpu_torch.storage.postings import (
    MutableBitmap,
    Postings,
    _U64_1,
    n_words,
    ordinals_from_words,
    popcount,
    set_bits,
    words_from_ordinals,
)
from m3_tpu_torch.utils import instrument

_log = instrument.logger("storage.index")

_U32 = struct.Struct("<I")


def _ser_tags(tags: dict[bytes, bytes]) -> bytes:
    parts = []
    for name in sorted(tags):
        value = tags[name]
        parts.append(_U32.pack(len(name)) + name + _U32.pack(len(value)) + value)
    return b"".join(parts)


def _deser_tags(blob: bytes) -> dict[bytes, bytes]:
    out: dict[bytes, bytes] = {}
    i, n = 0, len(blob)
    while i < n:
        (ln,) = _U32.unpack_from(blob, i)
        i += 4
        name = bytes(blob[i : i + ln])
        i += ln
        (lv,) = _U32.unpack_from(blob, i)
        i += 4
        out[name] = bytes(blob[i : i + lv])
        i += lv
    return out


def _id_hash(series_id: bytes) -> int:
    return int.from_bytes(
        hashlib.blake2b(series_id, digest_size=8).digest(), "little"
    )


def _pack_blob(items: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    offsets = np.zeros(len(items) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in items], out=offsets[1:])
    blob = np.frombuffer(b"".join(items), dtype=np.uint8).copy()
    return blob, offsets


def _blob_item(blob: np.ndarray, offsets: np.ndarray, i: int) -> bytes:
    return bytes(blob[int(offsets[i]) : int(offsets[i + 1])].tobytes())


try:  # the private sre modules moved in 3.11; both spellings work here
    from re import _constants as _sre_c, _parser as _sre_p
except ImportError:  # pragma: no cover - older interpreters
    import sre_constants as _sre_c
    import sre_parse as _sre_p


def _literal_prefix(pattern: bytes) -> tuple[bytes, bool]:
    """(prefix, exact): the longest literal prefix a fullmatch of
    `pattern` must start with; exact=True when the whole pattern is
    that literal (Go regexp's LiteralPrefix, which the reference's
    FST regexp search uses for prefix pruning)."""
    if not isinstance(pattern, bytes):
        return b"", False
    try:
        parsed = _sre_p.parse(pattern)
    except Exception:  # noqa: BLE001 - invalid patterns fall back to scan
        return b"", False
    if parsed.state.flags & re.IGNORECASE:
        return b"", False  # case folding breaks byte-order bisection
    out = bytearray()
    exact = True
    for op, arg in parsed:
        if op is _sre_c.LITERAL and arg < 256:
            out.append(arg)
        else:
            exact = False
            break
    return bytes(out), exact and len(out) > 0


def _prefix_successor(prefix: bytes) -> bytes | None:
    """Smallest bytes value greater than every value with `prefix`;
    None when no upper bound exists (prefix is all 0xff)."""
    p = bytearray(prefix)
    while p:
        if p[-1] < 0xFF:
            p[-1] += 1
            return bytes(p)
        p.pop()
    return None


# Bounded compiled-regexp memo shared by query_regexp and every
# empty-match probe in query_conjunction: a hot matcher pattern
# compiles once per process, not once per call (and not TWICE per
# conjunction, as the pre-memo code did for re/nre matchers).
_RX_MEMO_CAPACITY = 512
_rx_memo = None  # lazily an m3_tpu_torch.cache.LRUCache (bounded, instrumented)


def _compile_rx(pattern: bytes) -> "re.Pattern[bytes]":
    global _rx_memo
    memo = _rx_memo
    if memo is None:
        from m3_tpu_torch.cache import LRUCache

        memo = _rx_memo = LRUCache("regexp", capacity=_RX_MEMO_CAPACITY)
    rx = memo.get(pattern)
    if rx is None:
        rx = re.compile(pattern)
        memo.put(pattern, rx)
    return rx


def _save_arrays(seg_dir: pathlib.Path, arrays: dict[str, np.ndarray]) -> None:
    """Write one array per .npy + MANIFEST w/ digests + checkpoint-last."""
    seg_dir.mkdir(parents=True, exist_ok=True)
    manifest = {}
    for name, arr in arrays.items():
        path = seg_dir / f"{name}.npy"
        np.save(path, np.ascontiguousarray(arr))
        manifest[name] = hashlib.sha256(path.read_bytes()).hexdigest()
    (seg_dir / "MANIFEST.json").write_text(json.dumps(manifest))
    (seg_dir / "checkpoint").write_bytes(b"ok")


def _load_arrays(seg_dir: pathlib.Path) -> dict[str, np.ndarray] | None:
    """mmap a segment's arrays; digests are verified against MANIFEST
    (the reference verifies fileset digests on bootstrap — ref:
    persist/fs digests)."""
    if not (seg_dir / "checkpoint").exists():
        return None
    manifest = json.loads((seg_dir / "MANIFEST.json").read_text())
    out = {}
    for name, digest in manifest.items():
        path = seg_dir / f"{name}.npy"
        if not path.exists() or hashlib.sha256(path.read_bytes()).hexdigest() != digest:
            return None
        out[name] = np.load(path, mmap_mode="r")
    return out


# ---------------------------------------------------------------------------
# options + metrics
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IndexOptions:
    """TagIndex tuning knobs (services/config.py ``index:`` section).

    ``background_compaction`` — merge frozen segments in a daemon
    thread (default); False merges inline at the seal that exceeded
    the bound (the pre-PR write-path behavior, for single-threaded
    embedding).  ``max_frozen_segments`` / ``max_registry_segments``
    bound read fan-out; ``compaction_poll_s`` is the daemon's idle
    wake interval."""

    background_compaction: bool = True
    max_frozen_segments: int = 4
    max_registry_segments: int = 8
    compaction_poll_s: float = 0.5


# live indexes for the process-wide callback gauges: per-instance
# gauges would churn label sets as namespaces come and go (the
# cache/lru.py aggregation pattern)
_live_indexes: "weakref.WeakSet[TagIndex]" = weakref.WeakSet()
_metrics_lock = threading.Lock()
_metrics: dict | None = None


def _sum_over_live(fn) -> float:
    return float(sum(fn(ix) for ix in list(_live_indexes)))


def _density_ratio() -> float:
    dense = total = 0
    for ix in list(_live_indexes):
        for seg in ix._frozen:
            dense += seg.n_dense
            total += seg.n_terms
    return (dense / total) if total else 0.0


def _index_metrics() -> dict:
    global _metrics
    if _metrics is None:
        with _metrics_lock:
            if _metrics is None:
                instrument.gauge_fn(
                    "m3_index_segments",
                    lambda: _sum_over_live(
                        lambda ix: len(ix._frozen) + len(ix._registry._frozen)))
                instrument.gauge_fn(
                    "m3_index_postings_bytes",
                    lambda: _sum_over_live(
                        lambda ix: sum(s.postings_nbytes for s in ix._frozen)))
                instrument.gauge_fn(
                    "m3_index_bitmap_density_ratio", _density_ratio)
                _metrics = {
                    "compactions": instrument.counter(
                        "m3_index_compactions_total"),
                    "compaction_seconds": instrument.histogram(
                        "m3_index_compaction_seconds"),
                }
    return _metrics


# ---------------------------------------------------------------------------
# series registry
# ---------------------------------------------------------------------------


class _FrozenRegistry:
    """Immutable ordinal range [base, base+n): ids, tags, id->ordinal."""

    def __init__(self, base: int, arrays: dict[str, np.ndarray]):
        self.base = base
        self.ids_blob = arrays["ids_blob"]
        self.ids_off = arrays["ids_off"]
        self.tags_blob = arrays["tags_blob"]
        self.tags_off = arrays["tags_off"]
        self.hash_sorted = arrays["hash_sorted"]
        self.hash_ord = arrays["hash_ord"]  # base-relative, hash-sorted order
        self.n = len(self.ids_off) - 1
        for arr in arrays.values():
            if isinstance(arr, np.ndarray):
                arr.setflags(write=False)

    @classmethod
    def build(cls, base: int, ids: list[bytes], tags_ser: list[bytes]):
        ids_blob, ids_off = _pack_blob(ids)
        tags_blob, tags_off = _pack_blob(tags_ser)
        hashes = np.asarray([_id_hash(s) for s in ids], dtype=np.uint64)
        order = np.argsort(hashes, kind="stable").astype(np.int64)
        return cls(
            base,
            {
                "ids_blob": ids_blob,
                "ids_off": ids_off,
                "tags_blob": tags_blob,
                "tags_off": tags_off,
                "hash_sorted": hashes[order],
                "hash_ord": order,
            },
        )

    def arrays(self) -> dict[str, np.ndarray]:
        return {
            "ids_blob": self.ids_blob,
            "ids_off": self.ids_off,
            "tags_blob": self.tags_blob,
            "tags_off": self.tags_off,
            "hash_sorted": self.hash_sorted,
            "hash_ord": self.hash_ord,
        }

    @classmethod
    def merge(cls, segs: list["_FrozenRegistry"]) -> "_FrozenRegistry":
        """Vectorized compaction of contiguous-range segments."""
        segs = sorted(segs, key=lambda s: s.base)
        base = segs[0].base
        total = sum(s.n for s in segs)

        def cat_blob(blob_of, off_of):
            blob = np.concatenate([np.asarray(blob_of(s)) for s in segs])
            parts = [np.zeros(1, dtype=np.int64)]
            shift = 0
            for s in segs:
                off = np.asarray(off_of(s), dtype=np.int64)
                parts.append(off[1:] + shift)
                shift += int(off[-1])
            return blob, np.concatenate(parts)

        ids_blob, ids_off = cat_blob(lambda s: s.ids_blob, lambda s: s.ids_off)
        tags_blob, tags_off = cat_blob(lambda s: s.tags_blob, lambda s: s.tags_off)
        hashes = np.empty(total, dtype=np.uint64)
        for s in segs:
            rel = np.asarray(s.hash_ord) + (s.base - base)
            hashes[rel] = np.asarray(s.hash_sorted)
        order = np.argsort(hashes, kind="stable").astype(np.int64)
        return cls(
            base,
            {
                "ids_blob": ids_blob,
                "ids_off": ids_off,
                "tags_blob": tags_blob,
                "tags_off": tags_off,
                "hash_sorted": hashes[order],
                "hash_ord": order,
            },
        )

    def id_of(self, ordinal: int) -> bytes:
        return _blob_item(self.ids_blob, self.ids_off, ordinal - self.base)

    def tags_raw(self, ordinal: int) -> bytes:
        return _blob_item(self.tags_blob, self.tags_off, ordinal - self.base)

    def find(self, series_id: bytes) -> int | None:
        h = np.uint64(_id_hash(series_id))
        lo = int(np.searchsorted(self.hash_sorted, h, side="left"))
        hi = int(np.searchsorted(self.hash_sorted, h, side="right"))
        for k in range(lo, hi):
            rel = int(self.hash_ord[k])
            if _blob_item(self.ids_blob, self.ids_off, rel) == series_id:
                return self.base + rel
        return None


class SeriesRegistry:
    """Global ordinal (device lane) table: frozen segments + mutable tail.

    ``_frozen`` is an immutable tuple replaced wholesale under
    ``_lock`` — readers take one attribute read and iterate a
    consistent snapshot while the background compactor swaps in merged
    segments."""

    MAX_SEGMENTS = 8

    def __init__(self, seal_threshold: int = 65536):
        self.seal_threshold = seal_threshold
        self.max_segments = self.MAX_SEGMENTS
        self._frozen: tuple[_FrozenRegistry, ...] = ()
        self._lock = threading.Lock()
        self._mut_ids: list[bytes] = []
        self._mut_tags: list[bytes] = []
        self._mut_base = 0
        # Hot-path accelerator (not persisted): id -> ordinal for every
        # series seen this process — O(1) steady-state lookups; after a
        # restart it refills lazily from the frozen segments.
        self._lookup: dict[bytes, int] = {}
        # True once any frozen segment holds ids NOT in _lookup (i.e.
        # mmap-loaded from disk).  While False, a _lookup miss PROVES
        # absence and skips the per-segment hash + binary search that
        # otherwise taxes every brand-new series at ingest
        self._has_loaded_segments = False

    def __len__(self) -> int:
        return self._mut_base + len(self._mut_ids)

    def insert(self, series_id: bytes, tags: dict[bytes, bytes]) -> tuple[int, bool]:
        """Idempotent; returns (ordinal, inserted_new)."""
        o = self.ordinal(series_id)
        if o is not None:
            return o, False
        o = self._mut_base + len(self._mut_ids)
        self._mut_ids.append(series_id)
        self._mut_tags.append(_ser_tags(tags))
        self._lookup[series_id] = o
        if len(self._mut_ids) >= self.seal_threshold:
            self.seal()
        return o, True

    def ordinal(self, series_id: bytes) -> int | None:
        o = self._lookup.get(series_id)
        if o is not None:
            return o
        if not self._has_loaded_segments:
            return None  # every in-process id is in _lookup
        for seg in self._frozen:
            o = seg.find(series_id)
            if o is not None:
                self._lookup[series_id] = o
                return o
        return None

    def id_of(self, ordinal: int) -> bytes:
        if ordinal >= self._mut_base:
            return self._mut_ids[ordinal - self._mut_base]
        for seg in self._frozen:
            if seg.base <= ordinal < seg.base + seg.n:
                return seg.id_of(ordinal)
        raise IndexError(ordinal)

    def tags_raw(self, ordinal: int) -> bytes:
        if ordinal >= self._mut_base:
            return self._mut_tags[ordinal - self._mut_base]
        for seg in self._frozen:
            if seg.base <= ordinal < seg.base + seg.n:
                return seg.tags_raw(ordinal)
        raise IndexError(ordinal)

    def tags_of(self, ordinal: int) -> dict[bytes, bytes]:
        return _deser_tags(self.tags_raw(ordinal))

    def seal(self) -> None:
        """Freeze the mutable tail into a new segment.  APPEND ONLY:
        geometric merging happens off the write path (TagIndex's
        compaction daemon), so sealing is O(tail) with no merge
        stall."""
        if not self._mut_ids:
            return
        seg = _FrozenRegistry.build(self._mut_base, self._mut_ids, self._mut_tags)
        self._mut_base += len(self._mut_ids)
        self._mut_ids, self._mut_tags = [], []
        with self._lock:
            self._frozen = self._frozen + (seg,)


# ---------------------------------------------------------------------------
# postings segments
# ---------------------------------------------------------------------------


def _term_key(name: bytes, value: bytes) -> bytes:
    return _U32.pack(len(name)) + name + value


class _FrozenPostings:
    """Immutable term dictionary: sorted (field, value) keys -> postings.

    Terms are grouped by field; fields are sorted; values sorted within
    a field — so field iteration is a contiguous range and term lookup
    is two binary searches.  Each term's postings are ONE container
    (:class:`m3_tpu_torch.storage.postings.Postings`): sparse terms keep a
    sorted absolute-ordinal slice of the flat ``postings`` column (the
    v1 layout), dense terms keep a packed ``uint64`` word slice of the
    ``words`` column with a word-aligned ``word_base`` (format v2).
    ``term_kind[t]`` selects (0 = array, 1 = bitmap); a v1 segment
    (no ``term_kind`` column on disk) loads as all-array.

    All arrays are marked read-only — query results may alias segment
    storage by reference, and a mutating caller must fault rather
    than corrupt the segment/cache.
    """

    def __init__(self, arrays: dict[str, np.ndarray]):
        self.names_blob = arrays["names_blob"]
        self.names_off = arrays["names_off"]
        self.field_term_start = arrays["field_term_start"]  # [F+1]
        self.vals_blob = arrays["vals_blob"]
        self.vals_off = arrays["vals_off"]
        self.post_off = arrays["post_off"]  # [T+1] into the flat array col
        self.postings = arrays["postings"]
        self.ord_lo = int(arrays["ord_range"][0])
        self.ord_hi = int(arrays["ord_range"][1])
        self.n_fields = len(self.names_off) - 1
        self.n_terms = len(self.vals_off) - 1
        if "term_kind" in arrays:  # format v2: bitmap containers
            self.format_version = 2
            self.term_kind = arrays["term_kind"]  # uint8[T]
            self.word_off = arrays["word_off"]  # [T+1] into words col
            self.words = arrays["words"]  # uint64, dense containers
            self.word_base = arrays["word_base"]  # int64[T]
        else:  # format v1: every term is an array container
            self.format_version = 1
            self.term_kind = np.zeros(self.n_terms, dtype=np.uint8)
            self.word_off = np.zeros(self.n_terms + 1, dtype=np.int64)
            self.words = np.zeros(0, dtype=np.uint64)
            self.word_base = np.zeros(self.n_terms, dtype=np.int64)
        for arr in (self.names_blob, self.names_off, self.field_term_start,
                    self.vals_blob, self.vals_off, self.post_off,
                    self.postings, self.term_kind, self.word_off,
                    self.words, self.word_base):
            if isinstance(arr, np.ndarray):
                arr.setflags(write=False)

    @classmethod
    def build(cls, postings: dict[tuple[bytes, bytes], np.ndarray]):
        """postings values must be sorted unique int64 arrays."""
        by_field: dict[bytes, list[bytes]] = defaultdict(list)
        for name, value in postings:
            by_field[name].append(value)
        names = sorted(by_field)
        vals: list[bytes] = []
        field_term_start = np.zeros(len(names) + 1, dtype=np.int64)
        term_kind: list[int] = []
        arr_parts: list[np.ndarray] = []
        word_parts: list[np.ndarray] = []
        word_bases: list[int] = []
        post_counts: list[int] = []
        word_counts: list[int] = []
        lo: int | None = None
        hi = 0
        for f, name in enumerate(names):
            values = sorted(by_field[name])
            field_term_start[f + 1] = field_term_start[f] + len(values)
            for value in values:
                vals.append(value)
                o = np.asarray(postings[(name, value)], dtype=np.int64)
                if len(o):
                    first = int(o[0])
                    lo = first if lo is None else min(lo, first)
                    hi = max(hi, int(o[-1]) + 1)
                c = Postings.from_sorted(o)
                if c.is_bitmap:
                    term_kind.append(1)
                    word_parts.append(c.words)
                    word_bases.append(c.base_word)
                    post_counts.append(0)
                    word_counts.append(len(c.words))
                else:
                    term_kind.append(0)
                    arr_parts.append(c.arr)
                    word_bases.append(0)
                    post_counts.append(len(c.arr))
                    word_counts.append(0)
        names_blob, names_off = _pack_blob(names)
        vals_blob, vals_off = _pack_blob(vals)
        post_off = np.zeros(len(vals) + 1, dtype=np.int64)
        word_off = np.zeros(len(vals) + 1, dtype=np.int64)
        if vals:
            np.cumsum(post_counts, out=post_off[1:])
            np.cumsum(word_counts, out=word_off[1:])
        flat = (np.concatenate(arr_parts) if arr_parts
                else np.zeros(0, dtype=np.int64))
        words = (np.concatenate(word_parts) if word_parts
                 else np.zeros(0, dtype=np.uint64))
        return cls(
            {
                "names_blob": names_blob,
                "names_off": names_off,
                "field_term_start": field_term_start,
                "vals_blob": vals_blob,
                "vals_off": vals_off,
                "post_off": post_off,
                "postings": flat,
                "ord_range": np.asarray([lo or 0, hi], dtype=np.int64),
                "term_kind": np.asarray(term_kind, dtype=np.uint8),
                "word_off": word_off,
                "words": words,
                "word_base": np.asarray(word_bases, dtype=np.int64),
            }
        )

    def arrays(self) -> dict[str, np.ndarray]:
        return {
            "names_blob": self.names_blob,
            "names_off": self.names_off,
            "field_term_start": self.field_term_start,
            "vals_blob": self.vals_blob,
            "vals_off": self.vals_off,
            "post_off": self.post_off,
            "postings": self.postings,
            "ord_range": np.asarray([self.ord_lo, self.ord_hi], dtype=np.int64),
            "term_kind": self.term_kind,
            "word_off": self.word_off,
            "words": self.words,
            "word_base": self.word_base,
        }

    @property
    def postings_nbytes(self) -> int:
        """Bytes of postings payload (both container columns) — the
        compaction cost model and m3_index_postings_bytes."""
        return int(self.postings.nbytes) + int(self.words.nbytes)

    @property
    def n_dense(self) -> int:
        """Terms stored as bitmap containers."""
        return int(np.asarray(self.term_kind, dtype=np.int64).sum())

    # binary search over variable-length byte items
    def _bisect(self, blob, off, n, want: bytes, lo: int = 0) -> int:
        hi = n
        while lo < hi:
            mid = (lo + hi) // 2
            if _blob_item(blob, off, mid) < want:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def _field_range(self, name: bytes) -> tuple[int, int] | None:
        f = self._bisect(self.names_blob, self.names_off, self.n_fields, name)
        if f >= self.n_fields or _blob_item(self.names_blob, self.names_off, f) != name:
            return None
        return int(self.field_term_start[f]), int(self.field_term_start[f + 1])

    def _term_index(self, name: bytes, value: bytes) -> int | None:
        rng = self._field_range(name)
        if rng is None:
            return None
        lo, hi = rng
        t = self._bisect(self.vals_blob, self.vals_off, hi, value, lo)
        if t >= hi or _blob_item(self.vals_blob, self.vals_off, t) != value:
            return None
        return t

    def container(self, t: int) -> Postings:
        if int(self.term_kind[t]):
            w = np.asarray(
                self.words[int(self.word_off[t]) : int(self.word_off[t + 1])])
            return Postings(words=w, base_word=int(self.word_base[t]))
        return Postings(
            arr=np.asarray(
                self.postings[int(self.post_off[t]) : int(self.post_off[t + 1])]))

    def _decode_terms(self, ts) -> np.ndarray:
        """Sorted union of the given terms' postings (terms of one
        field are disjoint, so OR-into-bitmap + decode is exact)."""
        uni = np.zeros(n_words(self.ord_hi), dtype=np.uint64)
        for t in ts:
            self.container(t).or_into(uni)
        return ordinals_from_words(uni)

    def term(self, name: bytes, value: bytes) -> np.ndarray:
        t = self._term_index(name, value)
        if t is None:
            return np.zeros(0, dtype=np.int64)
        return self.container(t).to_ordinals()

    def field(self, name: bytes) -> np.ndarray:
        rng = self._field_range(name)
        if rng is None:
            return np.zeros(0, dtype=np.int64)
        return self._decode_terms(range(*rng))

    def _regexp_terms(self, name: bytes, rx: re.Pattern):
        """Term indices whose value fullmatches ``rx``.  Values are
        sorted within the field, so the pattern's literal prefix
        narrows the scan to a bisected subrange BEFORE any
        Python-speed re matching — a 1M-unique-value tag with an
        anchored pattern touches only its prefix neighborhood (the
        FST-walk prefix pruning of the reference's m3ninx segments,
        ref: src/m3ninx/index/segment/fst/segment.go regexp search)."""
        rng = self._field_range(name)
        if rng is None:
            return []
        lo, hi = rng
        prefix, exact = _literal_prefix(rx.pattern)
        if exact:
            t = self._bisect(self.vals_blob, self.vals_off, hi, prefix, lo)
            if t < hi and _blob_item(self.vals_blob, self.vals_off, t) == prefix:
                return [t]
            return []
        if rx.pattern == b".*":
            # `.` excludes newline (Go RE2 parity too) — the whole-field
            # shortcut is only sound under DOTALL or when no value in
            # the field contains one (a vectorized byte check)
            seg = self.vals_blob[
                int(self.vals_off[lo]):int(self.vals_off[hi])]
            if rx.flags & re.DOTALL or not (np.asarray(seg) == 0x0A).any():
                return range(lo, hi)
        if prefix:
            lo = self._bisect(self.vals_blob, self.vals_off, hi, prefix, lo)
            upper = _prefix_successor(prefix)
            if upper is not None:
                hi = self._bisect(self.vals_blob, self.vals_off, hi, upper, lo)
        return [
            t for t in range(lo, hi)
            if rx.fullmatch(_blob_item(self.vals_blob, self.vals_off, t))
        ]

    def regexp(self, name: bytes, rx: re.Pattern) -> np.ndarray:
        ts = self._regexp_terms(name, rx)
        if not ts:
            return np.zeros(0, dtype=np.int64)
        if len(ts) == 1:
            return self.container(ts[0]).to_ordinals()
        return self._decode_terms(ts)

    # --- fused-query primitives: OR a matcher into a universe bitmap ---

    def term_into(self, uni: np.ndarray, name: bytes, value: bytes) -> None:
        t = self._term_index(name, value)
        if t is not None:
            self.container(t).or_into(uni)

    def field_into(self, uni: np.ndarray, name: bytes) -> None:
        rng = self._field_range(name)
        if rng is not None:
            for t in range(*rng):
                self.container(t).or_into(uni)

    def regexp_into(self, uni: np.ndarray, name: bytes, rx: re.Pattern) -> None:
        for t in self._regexp_terms(name, rx):
            self.container(t).or_into(uni)

    def values_of(self, name: bytes) -> list[bytes]:
        rng = self._field_range(name)
        if rng is None:
            return []
        lo, hi = rng
        return [_blob_item(self.vals_blob, self.vals_off, t) for t in range(lo, hi)]

    def names(self) -> list[bytes]:
        return [
            _blob_item(self.names_blob, self.names_off, f)
            for f in range(self.n_fields)
        ]

    def iter_terms(self):
        """Yields ((name, value), postings) in sorted term order."""
        for f in range(self.n_fields):
            name = _blob_item(self.names_blob, self.names_off, f)
            for t in range(int(self.field_term_start[f]), int(self.field_term_start[f + 1])):
                yield (
                    (name, _blob_item(self.vals_blob, self.vals_off, t)),
                    self.container(t).to_ordinals(),
                )


def _merge_frozen_postings(segs: list[_FrozenPostings]) -> _FrozenPostings:
    """Compaction: k-way term merge; per-term postings concatenate in
    ordinal order (segments cover increasing disjoint ordinal ranges).
    ``build`` re-chooses each merged term's container by density."""
    segs = sorted(segs, key=lambda s: s.ord_lo)
    merged: dict[tuple[bytes, bytes], list[np.ndarray]] = defaultdict(list)
    for seg in segs:
        for key, post in seg.iter_terms():
            merged[key].append(np.asarray(post))
    return _FrozenPostings.build(
        {k: np.concatenate(v) if len(v) > 1 else v[0] for k, v in merged.items()}
    )


# ---------------------------------------------------------------------------
# the namespace index
# ---------------------------------------------------------------------------


class _IdsView:
    """lane -> series id view (Shard.seal maps present lanes to ids)."""

    def __init__(self, index: "TagIndex"):
        self._index = index

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, ordinal: int) -> bytes:
        return self._index.id_of(ordinal)


class TagIndex:
    """Namespace reverse index: registry + global postings + time slices.

    API-compatible with the round-1/2 dict index (insert/ordinal/id_of/
    tags_of/query_*/label_*), plus time-ranged queries, mutable->frozen
    compaction, a postings cache, and persist/load.

    Concurrency model: the index state queries touch lives in ONE
    immutable ``_snapshot = (generation, segments_tuple, mut,
    mut_names)`` attribute.  Queries read it once and work over a
    consistent (frozen segments, mutable tail) pair; every publish
    (seal append, compaction swap, load) replaces the whole tuple
    under ``_seg_lock`` with a generation bump + postings-cache clear.
    A seal swaps FRESH mut dicts in the same publish instead of
    clearing the old ones in place, so a query racing any number of
    seals/compactions sees either the old or the new view — never a
    mix that drops a sealed range.  The one writer keeps appending to
    the current mut dicts outside the lock; readers tolerate that via
    monotonicity (an in-flight insert is only ever missing from the
    top of the ordinal range) and a resize-retry when materializing
    sets.
    """

    MAX_FROZEN_SEGMENTS = 4
    CACHE_CAPACITY = 1024

    def __init__(self, seal_threshold: int = 65536,
                 postings_cache_capacity: int | None = None,
                 options: IndexOptions | None = None):
        self.seal_threshold = seal_threshold
        self._opts = options or IndexOptions(
            max_frozen_segments=self.MAX_FROZEN_SEGMENTS)
        self.max_frozen_segments = self._opts.max_frozen_segments
        self._registry = SeriesRegistry(seal_threshold)
        self._registry.max_segments = self._opts.max_registry_segments
        # ordinal -> deserialized tags dict.  Tags are first-writer-wins
        # per series (insert ignores tags for an existing sid), so
        # entries never invalidate; fan-out reads resolve every matched
        # series' labels per query and the per-call deserialization was
        # a measured cost.  Callers treat the shared dict as immutable.
        # LRU via OrderedDict: move_to_end on hit, popitem(last=False)
        # at capacity — O(1) incremental eviction (SmallOrderedLRU's
        # position renumbering is O(capacity) per touch, which at 262k
        # entries would cost more than the deserialization it saves).
        self._tags_memo: "OrderedDict[int, dict[bytes, bytes]]" = OrderedDict()
        self._seg_lock = threading.Lock()
        self._mut: dict[tuple[bytes, bytes], set[int]] = defaultdict(set)
        self._mut_names: dict[bytes, set[bytes]] = defaultdict(set)
        self._mut_count = 0  # series indexed since last postings seal
        # (generation, frozen segments, mutable postings, mutable
        # names) — ONE atomic read gives queries a consistent view.
        # The mut dicts ride in the snapshot because seal() moves
        # their contents into a frozen segment: swapping fresh dicts
        # in the same publish (instead of clearing in place) means a
        # reader holding an older snapshot still sees the tail in ITS
        # mut, never an (old segments, post-seal mut) mix that loses
        # the sealed range.
        self._snapshot: tuple = (0, (), self._mut, self._mut_names)
        # postings-list cache (m3_tpu_torch.cache): frozen-segment query
        # results keyed (kind, field, pattern, generation); the
        # generation in the key plus clear-on-bump keeps results from
        # a superseded segment set unreachable (ref: src/dbnode/
        # storage/index/postings_list_cache.go)
        from m3_tpu_torch.cache import PostingsListCache
        self._cache = PostingsListCache(
            postings_cache_capacity or self.CACHE_CAPACITY)
        # time slices: block_start -> (frozen word arrays, mutable bitmap)
        self._block_frozen: dict[int, list[np.ndarray]] = defaultdict(list)
        self._block_mut: dict[int, MutableBitmap] = defaultdict(MutableBitmap)
        # background compaction daemon: spawned lazily at the first
        # over-bound seal, exits when idle + bounded (so short-lived
        # indexes never pay a thread), re-spawned on demand
        self._closed = False
        self._compact_wake = threading.Event()
        self._compact_thread: threading.Thread | None = None
        _index_metrics()
        _live_indexes.add(self)

    # --- snapshot accessors (back-compat attribute names) ---

    @property
    def _frozen(self) -> tuple[_FrozenPostings, ...]:
        return self._snapshot[1]

    @property
    def _gen(self) -> int:
        return self._snapshot[0]

    # --- write path ---

    def __len__(self) -> int:
        return len(self._registry)

    @property
    def _ids(self) -> _IdsView:
        return _IdsView(self)

    def insert(self, series_id: bytes, tags: dict[bytes, bytes]) -> int:
        """Idempotent insert; returns the series ordinal (lane)."""
        ordinal, new = self._registry.insert(series_id, tags)
        if new:
            for name, value in tags.items():
                self._mut[(name, value)].add(ordinal)
                self._mut_names[name].add(value)
            self._mut_count += 1
            if self._mut_count >= self.seal_threshold:
                self.seal()
        return ordinal

    def insert_batch(self, series_ids, tags_list=None) -> np.ndarray:
        """Bulk idempotent insert: one call for a whole fileset/chunk
        of series, returning the int64 ordinal lane per id — pairs
        with :meth:`mark_active_batch` so bootstrap's fs index pass
        does one scatter per fileset instead of per-sid
        insert+mark_active round trips.  Per-SERIES work only; seal
        thresholds are honored mid-batch exactly as per-sid inserts
        would."""
        out = np.empty(len(series_ids), dtype=np.int64)
        for i, sid in enumerate(series_ids):
            out[i] = self.insert(
                sid, tags_list[i] if tags_list is not None else {})
        return out

    def mark_active(self, ordinal: int, block_start: int) -> None:
        """Record activity of a series in a retention block (the
        time-sliced index axis — ref: per-block index blocks,
        src/dbnode/storage/index.go nsIndex block map).  A bitmap
        bit-set: idempotent, so no frozen-membership probe is needed
        (re-marking a frozen-active ordinal just sets a duplicate bit
        that the query-time OR absorbs)."""
        self._block_mut[block_start].add(ordinal)

    def mark_active_batch(self, ordinals: np.ndarray,
                          block_start: int) -> None:
        """Vectorized mark_active for one block: one bit-scatter over
        the block's mutable bitmap — the ingest fast path calls this
        per (request, block) instead of per sample.  Duplicates (in
        the batch or vs already-marked ordinals) are free."""
        self._block_mut[block_start].add_batch(ordinals)

    def seal(self) -> None:
        """Freeze the mutable postings tail into a new segment.

        APPEND + PUBLISH only: the new segment is built from the tail
        and atomically appended to the ``(generation, segments)``
        snapshot.  Geometric segment merging is OFF the write path —
        ``_maybe_compact`` wakes the background daemon (or merges
        inline when ``background_compaction`` is disabled), so the
        per-65k-series merge stall the old inline compaction put on
        ``insert()`` is gone."""
        self._registry.seal()
        if self._mut:
            seg = _FrozenPostings.build(
                {
                    k: np.fromiter(sorted(v), dtype=np.int64, count=len(v))
                    for k, v in self._mut.items()
                }
            )
            # the old dicts are NEVER cleared in place: readers on an
            # older snapshot keep seeing the tail through their own
            # mut reference; the publish swaps fresh dicts atomically
            # with the segment append
            self._mut_count = 0
            self._publish(append=seg,
                          swap_mut=(defaultdict(set), defaultdict(set)))
        self._maybe_compact()

    def _publish(self, append: _FrozenPostings | None = None,
                 replace: tuple | None = None,
                 swap_mut: tuple | None = None) -> bool:
        """Atomically swap the postings snapshot (generation bump +
        postings-cache clear).  ``replace=(old_pair, merged)`` is the
        compactor's CAS: it only lands if every replaced segment is
        still in the current snapshot (a concurrent publish won the
        race otherwise — caller rescans).  ``swap_mut`` (seal only)
        installs fresh mutable dicts in the same publish."""
        with self._seg_lock:
            gen, segs, mut, mut_names = self._snapshot
            if append is not None:
                segs = segs + (append,)
            if replace is not None:
                old_pair, merged = replace
                if not all(any(s is o for s in segs) for o in old_pair):
                    return False
                segs = tuple(
                    s for s in segs if not any(s is o for o in old_pair))
                segs = tuple(sorted(segs + (merged,), key=lambda s: s.ord_lo))
            if swap_mut is not None:
                mut, mut_names = swap_mut
                self._mut = mut
                self._mut_names = mut_names
            self._snapshot = (gen + 1, segs, mut, mut_names)
        self._cache.clear()
        return True

    # --- compaction (off the write path) ---

    def _within_bounds(self) -> bool:
        return (len(self._frozen) <= self.max_frozen_segments
                and len(self._registry._frozen) <= self._registry.max_segments)

    def _maybe_compact(self) -> None:
        if self._within_bounds() or self._closed:
            return
        if not self._opts.background_compaction:
            self.compact()
            return
        self._compact_wake.set()
        self._ensure_compactor()

    def _ensure_compactor(self) -> None:
        t = self._compact_thread
        if t is not None and t.is_alive():
            return
        spawn = None
        with self._seg_lock:
            t = self._compact_thread
            if t is None or not t.is_alive():
                spawn = threading.Thread(
                    target=self._compactor_loop,
                    name="m3-index-compactor", daemon=True)
                self._compact_thread = spawn
        if spawn is not None:
            spawn.start()

    def _compactor_loop(self) -> None:
        from m3_tpu_torch import observe
        hb = observe.task_ledger().register_daemon(
            "index_compaction",
            interval_hint_s=max(float(self._opts.compaction_poll_s),
                                0.01))
        try:
            self._compactor_loop_inner(hb)
        finally:
            hb.close()

    def _compactor_loop_inner(self, hb) -> None:
        poll = max(float(self._opts.compaction_poll_s), 0.01)
        while True:
            fired = self._compact_wake.wait(timeout=poll)
            self._compact_wake.clear()
            hb.beat()
            if self._closed:
                return
            try:
                self.compact()
            except Exception as exc:  # noqa: BLE001 - daemon must survive
                _log.error("index compaction failed", error=exc)
            if self._closed:
                return
            if not fired:
                # idle tick: deregister-and-exit unless a wake slipped
                # in; _maybe_compact re-spawns on the next need.  The
                # handshake is under _seg_lock so a wake that lands
                # after this check sees _compact_thread None and spawns.
                with self._seg_lock:
                    if (not self._compact_wake.is_set()
                            and self._compact_thread is threading.current_thread()):
                        self._compact_thread = None
                        return

    def compact(self) -> None:
        """Merge frozen segments until both segment lists are within
        bounds.  Each round picks the cheapest ADJACENT pair (ordinal
        order keeps concatenated postings sorted; logarithmic
        amortized rewrite cost), merges OUTSIDE any lock over the
        immutable inputs, and CAS-publishes the swap — concurrent
        queries keep reading the pre-merge snapshot until the single
        atomic publish."""
        while self._compact_postings_once():
            pass
        while self._compact_registry_once():
            pass

    def _compact_postings_once(self) -> bool:
        segs = sorted(self._frozen, key=lambda s: s.ord_lo)
        if len(segs) <= self.max_frozen_segments:
            return False
        costs = [
            segs[i].postings_nbytes + segs[i + 1].postings_nbytes
            for i in range(len(segs) - 1)
        ]
        i = int(np.argmin(costs))
        pair = tuple(segs[i : i + 2])
        t0 = time.perf_counter()
        merged = _merge_frozen_postings(list(pair))
        m = _index_metrics()
        if self._publish(replace=(pair, merged)):
            m["compactions"].inc()
            m["compaction_seconds"].observe(time.perf_counter() - t0)
        return True  # rescan either way (CAS loss means segs changed)

    def _compact_registry_once(self) -> bool:
        reg = self._registry
        segs = sorted(reg._frozen, key=lambda s: s.base)
        if len(segs) <= reg.max_segments:
            return False
        costs = [segs[i].n + segs[i + 1].n for i in range(len(segs) - 1)]
        i = int(np.argmin(costs))
        pair = tuple(segs[i : i + 2])
        t0 = time.perf_counter()
        merged = _FrozenRegistry.merge(list(pair))
        with reg._lock:
            cur = reg._frozen
            if all(any(s is o for s in cur) for o in pair):
                kept = tuple(s for s in cur if not any(s is o for o in pair))
                reg._frozen = tuple(
                    sorted(kept + (merged,), key=lambda s: s.base))
                landed = True
            else:
                landed = False
        if landed:
            m = _index_metrics()
            m["compactions"].inc()
            m["compaction_seconds"].observe(time.perf_counter() - t0)
        return True

    def wait_compacted(self, timeout: float = 30.0) -> bool:
        """Block until segment counts are within bounds (tests/bench:
        deterministic state after a burst of seals).  Kicks the daemon
        first; returns False on timeout."""
        self._maybe_compact()
        deadline = time.monotonic() + timeout
        while not self._within_bounds():
            if self._closed or time.monotonic() >= deadline:
                return self._within_bounds()
            time.sleep(0.01)
        return True

    def close(self) -> None:
        """Stop the compaction daemon (Database.close tears down each
        namespace index).  Idempotent."""
        self._closed = True
        self._compact_wake.set()
        t = self._compact_thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)

    def freeze_block(self, block_start: int) -> None:
        """Seal a block's mutable activity bitmap into a trimmed
        read-only word array."""
        mut = self._block_mut.get(block_start)
        if mut is not None:
            w = mut.to_frozen()
            if w is not None:
                # publish-then-remove: a reader between the two steps
                # ORs the same bits twice, which is free; pop-first
                # would open a window where the block's activity is in
                # neither structure
                self._block_frozen[block_start].append(w)
            self._block_mut.pop(block_start, None)

    def drop_blocks_before(self, cutoff_nanos: int, block_size: int) -> list[int]:
        """Expire time slices past retention (bounded index memory).
        A block is dropped only once ALL its data is past the cutoff
        (bs + block_size <= cutoff), not when merely its start is."""
        dropped = [
            bs
            for bs in set(self._block_frozen) | set(self._block_mut)
            if bs + block_size <= cutoff_nanos
        ]
        for bs in dropped:
            self._block_frozen.pop(bs, None)
            self._block_mut.pop(bs, None)
        return dropped

    # --- registry pass-through ---

    def ordinal(self, series_id: bytes) -> int | None:
        return self._registry.ordinal(series_id)

    def id_of(self, ordinal: int) -> bytes:
        return self._registry.id_of(ordinal)

    TAGS_MEMO_CAPACITY = 262144

    def tags_of(self, ordinal: int) -> dict[bytes, bytes]:
        """Labels for a series ordinal.  The returned dict is CACHED and
        shared — treat it as immutable (copy before mutating).  The memo
        is a bounded LRU: at capacity the single least-recently-used
        entry is evicted (the old memo cleared ALL 262k entries at
        once, re-deserializing the whole working set on the next
        fan-out query)."""
        memo = self._tags_memo
        d = memo.get(ordinal)
        if d is None:
            if len(memo) >= self.TAGS_MEMO_CAPACITY:
                memo.popitem(last=False)
            d = memo[ordinal] = self._registry.tags_of(ordinal)
        else:
            memo.move_to_end(ordinal)
        return d

    # --- queries (ref: src/m3ninx/search/searcher/) ---

    @staticmethod
    def _freeze_result(a: np.ndarray) -> np.ndarray:
        """Cached query results are shared by reference — read-only so
        a mutating caller faults instead of corrupting the cache."""
        a.setflags(write=False)
        return a

    @staticmethod
    def _set_to_array(s: set) -> np.ndarray:
        """Snapshot a mut postings set as an (unsorted) int64 array.
        The writer may resize the set mid-iteration; the interpreter
        guards that with RuntimeError — retry, additions are monotone
        so a retry only ever sees a superset."""
        while True:
            try:
                return np.fromiter(s, dtype=np.int64)
            except RuntimeError:
                continue

    @staticmethod
    def _snapshot_iter(s) -> list:
        """list() of a set that the writer may be resizing (same
        RuntimeError-retry contract as :meth:`_set_to_array`)."""
        while True:
            try:
                return list(s)
            except RuntimeError:
                continue

    def _union_sorted(self, frozen_parts: list[np.ndarray], mut: set[int]) -> np.ndarray:
        parts = [p for p in frozen_parts if len(p)]
        if mut:
            parts.append(np.sort(self._set_to_array(mut)))
        if not parts:
            return np.zeros(0, dtype=np.int64)
        if len(parts) == 1:
            return parts[0]
        return np.unique(np.concatenate(parts))

    def query_term(self, name: bytes, value: bytes) -> np.ndarray:
        gen, segs, mut, _ = self._snapshot
        frozen = self._cache.get_or_compute(
            ("term", name, value, gen),
            lambda: self._freeze_result(self._union_sorted(
                [s.term(name, value) for s in segs], set())),
        )
        return self._union_sorted([frozen], mut.get((name, value), set()))

    def query_regexp(self, name: bytes, pattern: bytes) -> np.ndarray:
        rx = _compile_rx(pattern)
        gen, segs, mut, mut_names = self._snapshot
        frozen = self._cache.get_or_compute(
            ("re", name, pattern, gen),
            lambda: self._freeze_result(self._union_sorted(
                [s.regexp(name, rx) for s in segs], set())),
        )
        parts = [frozen]
        for value in self._snapshot_iter(mut_names.get(name, ())):
            if rx.fullmatch(value):
                s = mut.get((name, value))
                if s:
                    parts.append(np.sort(self._set_to_array(s)))
        return self._union_sorted(parts, set())

    def query_field(self, name: bytes) -> np.ndarray:
        """All series having the tag at all."""
        gen, segs, mut, mut_names = self._snapshot
        frozen = self._cache.get_or_compute(
            ("field", name, gen),
            lambda: self._freeze_result(self._union_sorted(
                [s.field(name) for s in segs], set())),
        )
        parts = [frozen]
        for value in self._snapshot_iter(mut_names.get(name, ())):
            s = mut.get((name, value))
            if s:
                parts.append(np.sort(self._set_to_array(s)))
        return self._union_sorted(parts, set())

    def _active_words_into(self, uni: np.ndarray, start_nanos: int,
                           end_nanos: int, block_size: int) -> None:
        """OR every overlapping block's activity bitmap into ``uni``."""
        for bs in set(self._block_frozen) | set(self._block_mut):
            if bs + block_size > start_nanos and bs < end_nanos:
                for w in self._block_frozen.get(bs, ()):
                    k = min(len(w), len(uni))
                    if k:
                        np.bitwise_or(uni[:k], w[:k], out=uni[:k])
                m = self._block_mut.get(bs)
                if m is not None:
                    m.or_into(uni)

    def _active_in_range(self, start_nanos: int, end_nanos: int, block_size: int
                         ) -> np.ndarray:
        uni = np.zeros(n_words(len(self._registry)), dtype=np.uint64)
        self._active_words_into(uni, start_nanos, end_nanos, block_size)
        return ordinals_from_words(uni)

    # --- fused conjunction ---

    def _frozen_matcher_words(self, kind: str, name: bytes, value: bytes,
                              gen: int, segs) -> np.ndarray:
        """Universe bitmap of one base matcher over the FROZEN segments
        (cached per generation, read-only).  Sized to the frozen
        ordinal span; the caller ORs it into a full-universe buffer."""

        def compute():
            w = np.zeros(n_words(max((s.ord_hi for s in segs), default=0)),
                         dtype=np.uint64)
            for s in segs:
                if kind == "term":
                    s.term_into(w, name, value)
                elif kind == "field":
                    s.field_into(w, name)
                else:
                    s.regexp_into(w, name, _compile_rx(value))
            w.setflags(write=False)
            return w

        return self._cache.get_or_compute(("w" + kind, name, value, gen), compute)

    def _matcher_words(self, kind: str, name: bytes, value: bytes,
                       nw: int, gen: int, segs, mut, mut_names) -> np.ndarray:
        """Full-universe bitmap for one base matcher: cached frozen
        words ORed with the mutable tail (``mut``/``mut_names`` from
        the SAME snapshot read as ``segs``).  Returns a FRESH writable
        buffer the conjunction may negate/fold in place."""
        uni = np.zeros(nw, dtype=np.uint64)
        fw = self._frozen_matcher_words(kind, name, value, gen, segs)
        k = min(len(fw), nw)
        if k:
            np.bitwise_or(uni[:k], fw[:k], out=uni[:k])

        def scatter(s: set) -> None:
            o = self._set_to_array(s)
            # an insert racing this query may have registered an
            # ordinal past the universe this query sized itself to —
            # clamp instead of scattering out of bounds
            o = o[o < (nw << 6)]
            set_bits(uni, o)

        if kind == "term":
            s = mut.get((name, value))
            if s:
                scatter(s)
        elif kind == "field":
            for v in self._snapshot_iter(mut_names.get(name, ())):
                s = mut.get((name, v))
                if s:
                    scatter(s)
        else:  # regexp
            rx = _compile_rx(value)
            for v in self._snapshot_iter(mut_names.get(name, ())):
                if rx.fullmatch(v):
                    s = mut.get((name, v))
                    if s:
                        scatter(s)
        return uni

    def query_conjunction(
        self,
        matchers,
        start_nanos: int | None = None,
        end_nanos: int | None = None,
        block_size: int | None = None,
        limits=None,
        meta=None,
    ) -> np.ndarray:
        """AND of matchers: [(kind, name, value)], kind in
        {"eq", "neq", "re", "nre"} — the PromQL matcher set with
        Prometheus's missing-label semantics: an absent label behaves
        as the empty string, so `{foo!="bar"}` and `{foo=~".*"}` match
        series without `foo`, `{foo=""}` matches only series without
        (or with empty) `foo`, and `{foo!=""}` requires it present
        (ref: src/query/parser/promql/matchers.go + upstream
        prometheus label matching).  With a time range, the result is
        pruned to series active in overlapping blocks.

        Fused set algebra: every matcher (negations as complements,
        absent-label semantics as ``~field``) becomes ONE universe
        bitmap, the whole tree folds in a single
        ``np.bitwise_and.reduce`` pass over the stacked word rows, and
        the result decodes to sorted ordinals once at the end —
        result-identical to the old pairwise
        ``intersect1d``/``setdiff1d`` fold, at word-parallel speed.

        ``limits``/``meta`` (storage.limits.QueryLimits / ResultMeta)
        bound the lookup: the per-query deadline is checked up front
        and the matched set is truncated (or the query aborted, under
        require-exhaustive) at ``max_fetched_series`` — enforced on
        the POPCOUNT, so decode never materializes ordinals past the
        truncation point (ref:
        src/dbnode/storage/limits/query_limits.go)."""
        if limits is not None:
            limits.check_deadline("index lookup")
        gen, segs, mut, mut_names = self._snapshot
        n = len(self._registry)
        if n == 0:
            if limits is not None:
                limits.enforce_series(0, meta)
            return np.zeros(0, dtype=np.int64)
        nw = n_words(n)

        def mw(kind: str, name: bytes, value: bytes = b"") -> np.ndarray:
            return self._matcher_words(kind, name, value, nw, gen, segs,
                                       mut, mut_names)

        stack: list[np.ndarray] = []
        for kind, name, value in matchers:
            if kind == "eq":
                if value == b"":
                    # matches absent-or-empty: NOT(present-and-non-empty)
                    w = mw("field", name)
                    np.bitwise_and(w, ~mw("term", name, b""), out=w)
                    np.invert(w, out=w)
                else:
                    w = mw("term", name, value)
            elif kind == "re":
                w = mw("re", name, value)
                if _compile_rx(value).fullmatch(b""):
                    # absent counts as "" which the pattern matches
                    np.bitwise_or(w, ~mw("field", name), out=w)
            elif kind == "neq":
                if value == b"":
                    # must be present with a non-empty value
                    w = mw("field", name)
                    np.bitwise_and(w, ~mw("term", name, b""), out=w)
                else:
                    w = mw("term", name, value)
                    np.invert(w, out=w)
            elif kind == "nre":
                w = mw("re", name, value)
                if _compile_rx(value).fullmatch(b""):
                    np.bitwise_or(w, ~mw("field", name), out=w)
                np.invert(w, out=w)
            else:
                raise ValueError(f"unknown matcher kind {kind}")
            stack.append(w)
        if start_nanos is not None and end_nanos is not None and block_size:
            act = np.zeros(nw, dtype=np.uint64)
            self._active_words_into(act, start_nanos, end_nanos, block_size)
            stack.append(act)
        if not stack:
            res = np.full(nw, np.uint64(0xFFFFFFFFFFFFFFFF), dtype=np.uint64)
        elif len(stack) == 1:
            res = stack[0]
        else:
            res = np.bitwise_and.reduce(np.stack(stack), axis=0)
        tail = n & 63
        if tail:  # mask ghost bits past the universe (negations set them)
            res[-1] &= (_U64_1 << np.uint64(tail)) - _U64_1
        if limits is not None:
            # ordinal order is deterministic (sorted), so truncation is
            # stable across replicas of the same index
            total = popcount(res)
            keep = limits.enforce_series(total, meta)
            return ordinals_from_words(
                res, limit=keep if keep < total else None)
        return ordinals_from_words(res)

    def label_values(self, name: bytes) -> list[bytes]:
        _, segs, _, mut_names = self._snapshot
        vals: set[bytes] = set(self._snapshot_iter(mut_names.get(name, ())))
        for seg in segs:
            vals.update(seg.values_of(name))
        return sorted(vals)

    def label_names(self) -> list[bytes]:
        _, segs, _, mut_names = self._snapshot
        names: set[bytes] = set(self._snapshot_iter(mut_names))
        for seg in segs:
            names.update(seg.names())
        return sorted(names)

    # --- persistence ---

    def persist(self, root: str | pathlib.Path, covered: list | None = None) -> None:
        """Write frozen state + checkpoint (tmp+rename, written last).

        Compacts inline first (the flush thread, not the insert path)
        so the on-disk segment set is bounded and deterministic.

        ``covered`` is opaque bootstrap metadata (the Database records
        which filesets this index snapshot already covers so restart
        can skip re-reading them)."""
        self.seal()
        self.compact()
        for bs in list(self._block_mut):
            self.freeze_block(bs)
        root = pathlib.Path(root)
        root.mkdir(parents=True, exist_ok=True)
        live: dict = {"registry": [], "postings": [], "blocks": {}, "covered": covered or []}
        for seg in self._registry._frozen:
            name = f"reg-{seg.base:012d}-{seg.n:012d}"
            if not (root / name / "checkpoint").exists():
                _save_arrays(root / name, seg.arrays())
            live["registry"].append(name)
        for seg in self._frozen:
            # content-stable name: segments cover disjoint ordinal
            # ranges, so (range, n_terms) identifies one — unchanged
            # segments are never rewritten across persists.  "post2-"
            # marks format v2 (bitmap containers); a v1 "post-" dir
            # from an older snapshot is never reused, so its layout
            # assumptions can't leak into v2 readers.
            name = f"post2-{seg.ord_lo:012d}-{seg.ord_hi:012d}-{seg.n_terms:010d}"
            if not (root / name / "checkpoint").exists():
                _save_arrays(root / name, seg.arrays())
            live["postings"].append(name)
        for bs, arrays in self._block_frozen.items():
            if not arrays:
                continue
            merged = np.zeros(max(len(w) for w in arrays), dtype=np.uint64)
            for w in arrays:
                np.bitwise_or(merged[: len(w)], w, out=merged[: len(w)])
            name = f"blk2-{bs:020d}-{popcount(merged):012d}"
            if not (root / name / "checkpoint").exists():
                _save_arrays(root / name, {"active_words": merged})
            live["blocks"][str(bs)] = name
        tmp = root / "INDEX_CHECKPOINT.json.tmp"
        tmp.write_text(json.dumps(live))
        tmp.replace(root / "INDEX_CHECKPOINT.json")
        # GC: directories not referenced by the new checkpoint
        referenced = set(live["registry"]) | set(live["postings"]) | set(live["blocks"].values())
        for child in root.iterdir():
            if child.is_dir() and child.name not in referenced:
                shutil.rmtree(child, ignore_errors=True)

    def load(self, root: str | pathlib.Path) -> list:
        """mmap frozen segments back; returns the ``covered`` metadata.

        All-or-nothing: if ANY referenced segment is missing or fails
        its digest, the whole snapshot is discarded and [] is returned
        so the caller falls back to the full fs rebuild — a partial
        load would leave ordinal gaps that make data silently
        unqueryable while "covered" suppresses the rebuild.

        Format compat: postings segments auto-detect v1 (array-only,
        no ``term_kind`` column) vs v2; v1 block activity (sorted
        ordinal arrays) converts to bitmap words at load."""
        root = pathlib.Path(root)
        ckpt = root / "INDEX_CHECKPOINT.json"
        if not ckpt.exists():
            return []
        live = json.loads(ckpt.read_text())
        registry: list[_FrozenRegistry] = []
        postings: list[_FrozenPostings] = []
        blocks: dict[int, np.ndarray] = {}
        for name in live["registry"]:
            arrays = _load_arrays(root / name)
            if arrays is None:
                return []
            registry.append(_FrozenRegistry(int(name.split("-")[1]), arrays))
        for name in live["postings"]:
            arrays = _load_arrays(root / name)
            if arrays is None:
                return []
            postings.append(_FrozenPostings(arrays))
        for bs, name in live["blocks"].items():
            arrays = _load_arrays(root / name)
            if arrays is None:
                return []
            if "active_words" in arrays:
                w = np.asarray(arrays["active_words"])
            else:  # v1: sorted active-ordinal array
                ords = np.asarray(arrays["active"])
                w = words_from_ordinals(
                    ords, n_words(int(ords[-1]) + 1 if len(ords) else 0))
                w.setflags(write=False)
            blocks[int(bs)] = w
        reg = self._registry
        with reg._lock:
            reg._frozen = reg._frozen + tuple(registry)
        if registry:
            # loaded segments hold ids the in-process lookup has never
            # seen — absence checks must consult them again
            reg._has_loaded_segments = True
        for seg in registry:
            reg._mut_base = max(reg._mut_base, seg.base + seg.n)
        with self._seg_lock:
            gen, segs, mut, mut_names = self._snapshot
            self._snapshot = (gen + len(postings), segs + tuple(postings),
                              mut, mut_names)
        for bs, active in blocks.items():
            self._block_frozen[bs].append(active)
        return live.get("covered", [])
