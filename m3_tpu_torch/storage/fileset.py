"""Immutable fileset files with digests and checkpoint-last atomicity.

File layout per (namespace, shard, block_start, volume)
(ref: src/dbnode/persist/fs/fs.go:26-33 suffix set, write.go:131 writer,
write.go:640 writeCheckpointFile):

    <ns>/<shard>/fileset-<blockstart>-<volume>-info.db        json header
    .../fileset-...-index.db     sorted (id, offset, length) entries
    .../fileset-...-data.db      concatenated M3TSZ streams
    .../fileset-...-bloomfilter.db
    .../fileset-...-digest.db    crc32 of each file above
    .../fileset-...-checkpoint.db  crc32 of the digest file, written LAST

A fileset is readable iff its checkpoint exists and validates — the
same crash-atomicity rule the reference's TLA+ flush spec encodes
(specs/dbnode/flush/FlushVersion.tla).
"""

from __future__ import annotations

import json
import pathlib
import struct
import zlib

import numpy as np

from m3_tpu_torch.utils import faultpoints
from m3_tpu_torch.utils.hash import BloomFilter

SUFFIXES = ("info", "index", "data", "bloomfilter", "digest", "checkpoint")


def _path(root: pathlib.Path, ns: str, shard: int, block_start: int, volume: int,
          suffix: str) -> pathlib.Path:
    return root / ns / str(shard) / f"fileset-{block_start}-{volume}-{suffix}.db"


class FilesetWriter:
    def __init__(self, root: str | pathlib.Path):
        self.root = pathlib.Path(root)

    def write(
        self,
        ns: str,
        shard: int,
        block_start: int,
        ids: list[bytes],
        streams: list[bytes],
        volume: int = 0,
        block_size: int = 0,
        tags: list[dict[bytes, bytes]] | None = None,
        covers_until: int = 0,
        counts: list[int] | None = None,
    ) -> None:
        """Persist one sealed block.  ids must be unique; entries are
        stored sorted by id for binary-search lookup.  Tags ride the
        index entries so bootstrap can rebuild the reverse index from
        disk (the reference's fs index bootstrap pass).

        ``counts`` (datapoints per stream, known at seal time) upgrades
        the index entries to v2: readers then size batch-decode grids
        exactly instead of paying a count-only decode pass over every
        stream — the hot fan-out read's second-largest cost.  Files
        written without counts stay v1; readers fall back."""
        order = sorted(range(len(ids)), key=lambda i: ids[i])
        ids = [ids[i] for i in order]
        streams = [streams[i] for i in order]
        tags = [tags[i] for i in order] if tags else [{} for _ in ids]
        counts = [int(counts[i]) for i in order] if counts else None
        index_v = 2 if counts is not None else 1

        data = b"".join(streams)
        # stream offsets in one cumsum instead of a running Python
        # accumulator — at flush the entry loop below is per-SERIES
        # (never per sample); the offsets are the only O(entries)
        # arithmetic and they stay in numpy
        n_entries = len(ids)
        offsets = np.zeros(n_entries + 1, dtype=np.int64)
        np.cumsum(
            np.fromiter((len(b) for b in streams), np.int64,
                        count=n_entries),
            out=offsets[1:])
        parts: list[bytes] = []
        for pos, (sid, blob, tg) in enumerate(zip(ids, streams, tags)):
            parts.append(struct.pack("<I", len(sid)) + sid)
            if index_v >= 2:
                parts.append(struct.pack("<qqq", int(offsets[pos]),
                                         len(blob), counts[pos]))
            else:
                parts.append(struct.pack("<qq", int(offsets[pos]),
                                         len(blob)))
            parts.append(struct.pack("<H", len(tg)))
            for k in sorted(tg):
                parts.append(struct.pack("<H", len(k)) + k)
                parts.append(struct.pack("<H", len(tg[k])) + tg[k])
        index = b"".join(parts)

        bloom = BloomFilter(max(len(ids), 1))
        for sid in ids:
            bloom.add(sid)

        import time

        info = json.dumps(
            {
                "block_start": block_start,
                "block_size": block_size,
                "volume": volume,
                "entries": len(ids),
                "index_v": index_v,
                "bloom_m": bloom.m,
                "bloom_k": bloom.k,
                # lets bootstrap order overlapping artifacts (data
                # fileset vs snapshot of the same block) by freshness
                "written_at": time.time_ns(),
                # WAL entries stamped at/before this are IN the fileset
                # (the block's seal time); bootstrap skips them
                "covers_until": covers_until or time.time_ns(),
            }
        ).encode()

        d = _path(self.root, ns, shard, block_start, volume, "info").parent
        d.mkdir(parents=True, exist_ok=True)

        faultpoints.check("fileset.begin")
        files = {
            "info": info,
            "index": bytes(index),
            "data": data,
            "bloomfilter": bloom.to_bytes(),
        }
        digests = {}
        for suffix, payload in files.items():
            p = _path(self.root, ns, shard, block_start, volume, suffix)
            p.write_bytes(payload)
            digests[suffix] = zlib.crc32(payload)

        faultpoints.check("fileset.data")
        digest_payload = json.dumps(digests).encode()
        _path(self.root, ns, shard, block_start, volume, "digest").write_bytes(
            digest_payload
        )
        faultpoints.check("fileset.digest")
        # checkpoint LAST: its presence marks the fileset complete
        checkpoint = struct.pack("<I", zlib.crc32(digest_payload))
        _path(self.root, ns, shard, block_start, volume, "checkpoint").write_bytes(
            checkpoint
        )
        faultpoints.check("fileset.done")


class FilesetReader:
    """mmap-backed reader (ref: src/dbnode/persist/fs/read.go,
    seek.go bloom+index lookup)."""

    def __init__(self, root: str | pathlib.Path, ns: str, shard: int,
                 block_start: int, volume: int = 0):
        self.root = pathlib.Path(root)
        self.ns, self.shard = ns, shard
        self.block_start, self.volume = block_start, volume

        cp = _path(self.root, ns, shard, block_start, volume, "checkpoint")
        if not cp.exists():
            raise FileNotFoundError(f"fileset incomplete: no checkpoint {cp}")
        digest_payload = _path(self.root, ns, shard, block_start, volume,
                               "digest").read_bytes()
        (want_crc,) = struct.unpack("<I", cp.read_bytes())
        if zlib.crc32(digest_payload) != want_crc:
            raise ValueError("checkpoint/digest mismatch")
        digests = json.loads(digest_payload)

        payloads = {}
        for suffix in ("info", "index", "bloomfilter"):
            payload = _path(self.root, ns, shard, block_start, volume,
                            suffix).read_bytes()
            if zlib.crc32(payload) != digests[suffix]:
                raise ValueError(f"digest mismatch for {suffix}")
            payloads[suffix] = payload

        self.info = json.loads(payloads["info"])
        self.bloom = BloomFilter.from_bytes(
            payloads["bloomfilter"], self.info["bloom_m"], self.info["bloom_k"]
        )
        index_v = self.info.get("index_v", 1)
        if index_v > 2:
            # fail loudly on formats from the future instead of parsing
            # garbage offsets with the v2 layout
            raise ValueError(
                f"unsupported fileset index version {index_v}")
        self._ids: list[bytes] = []
        self._offsets: list[tuple[int, int]] = []
        self._tags: list[dict[bytes, bytes]] = []
        # datapoints per stream (v2 filesets); None for v1 — readers
        # needing widths then pay a count pass
        self._counts: list[int] | None = [] if index_v >= 2 else None
        idx = payloads["index"]
        pos = 0
        while pos < len(idx):
            (n,) = struct.unpack_from("<I", idx, pos)
            pos += 4
            sid = bytes(idx[pos : pos + n])
            pos += n
            if index_v >= 2:
                off, length, n_dp = struct.unpack_from("<qqq", idx, pos)
                pos += 24
                self._counts.append(n_dp)
            else:
                off, length = struct.unpack_from("<qq", idx, pos)
                pos += 16
            (ntags,) = struct.unpack_from("<H", idx, pos)
            pos += 2
            tg: dict[bytes, bytes] = {}
            for _ in range(ntags):
                (klen,) = struct.unpack_from("<H", idx, pos)
                pos += 2
                k = bytes(idx[pos : pos + klen])
                pos += klen
                (vlen,) = struct.unpack_from("<H", idx, pos)
                pos += 2
                tg[k] = bytes(idx[pos : pos + vlen])
                pos += vlen
            self._ids.append(sid)
            self._offsets.append((off, length))
            self._tags.append(tg)
        data_path = _path(self.root, ns, shard, block_start, volume, "data")
        self._data = np.memmap(data_path, dtype=np.uint8, mode="r") if (
            data_path.stat().st_size
        ) else np.zeros(0, dtype=np.uint8)
        if zlib.crc32(self._data.tobytes()) != digests["data"]:
            raise ValueError("digest mismatch for data")

    @property
    def ids(self) -> list[bytes]:
        return self._ids

    @property
    def tags(self) -> list[dict[bytes, bytes]]:
        return self._tags

    def read(self, series_id: bytes) -> bytes | None:
        """Stream for one series, or None (bloom -> binary search -> mmap
        slice, the reference's seek path)."""
        if not self.bloom.may_contain(series_id):
            return None
        lo, hi = 0, len(self._ids)
        while lo < hi:
            mid = (lo + hi) // 2
            if self._ids[mid] < series_id:
                lo = mid + 1
            else:
                hi = mid
        if lo >= len(self._ids) or self._ids[lo] != series_id:
            return None
        off, length = self._offsets[lo]
        return self._data[off : off + length].tobytes()

    _pos_of: dict[bytes, int] | None = None

    def read_batch_with_counts(self, series_ids, zero_copy: bool = False):
        """Bulk read returning (blobs, dp_counts); counts entries are
        None for ids not present or on v1 filesets (no stored counts).
        ``zero_copy=True`` returns memoryview slices of the mmap
        instead of bytes copies (engine batch path: tens of thousands
        of small copies per fan-out otherwise)."""
        blobs = self.read_batch(series_ids, zero_copy=zero_copy)
        if self._counts is None:
            return blobs, [None] * len(blobs)
        pos_of = self._pos_of  # built by read_batch
        counts = [None if b is None else self._counts[pos_of[sid]]
                  for sid, b in zip(series_ids, blobs)]
        return blobs, counts

    _mv: memoryview | None = None

    def read_batch(self, series_ids,
                   zero_copy: bool = False) -> list[bytes | None]:
        """Bulk read: one dict lookup per id instead of bloom + bisect.
        The id->position map is built lazily on first bulk read and
        amortized across every query hitting this (cached) reader —
        fan-out reads spend their time here, not in per-call setup
        (ref: the seek-index byte ranges reused across a batch,
        persist/fs/retriever.go seekerManager)."""
        pos_of = self._pos_of
        if pos_of is None:
            pos_of = self._pos_of = {
                sid: i for i, sid in enumerate(self._ids)}
        offsets = self._offsets
        if zero_copy:
            mv = self._mv
            if mv is None:
                mv = self._mv = memoryview(self._data)
        else:
            mv = None
        data = self._data
        out: list = []
        for sid in series_ids:
            i = pos_of.get(sid)
            if i is None:
                out.append(None)
            else:
                off, length = offsets[i]
                out.append(mv[off:off + length] if zero_copy
                           else data[off:off + length].tobytes())
        return out

    def read_all(self) -> tuple[list[bytes], list[bytes]]:
        return self._ids, [
            self._data[o : o + n].tobytes() for o, n in self._offsets
        ]


def read_fileset_info(root: str | pathlib.Path, ns: str, shard: int,
                      block_start: int, volume: int) -> dict | None:
    """The info header alone (cheap — no data/digest validation);
    None if the fileset has no checkpoint."""
    if not _path(pathlib.Path(root), ns, shard, block_start, volume,
                 "checkpoint").exists():
        return None
    return json.loads(_path(pathlib.Path(root), ns, shard, block_start,
                            volume, "info").read_bytes())


def remove_fileset(root: str | pathlib.Path, ns: str, shard: int,
                   block_start: int, volume: int) -> None:
    """Delete one fileset's files, checkpoint FIRST so a partial delete
    leaves an unreadable (not half-readable) fileset."""
    for suffix in reversed(SUFFIXES):
        _path(pathlib.Path(root), ns, shard, block_start, volume,
              suffix).unlink(missing_ok=True)


def list_fileset_volumes(root: str | pathlib.Path, ns: str, shard: int
                         ) -> list[tuple[int, int]]:
    """ALL complete (block_start, volume) pairs, including superseded
    volumes (for cleanup)."""
    d = pathlib.Path(root) / ns / str(shard)
    if not d.exists():
        return []
    out = []
    for p in d.glob("fileset-*-checkpoint.db"):
        parts = p.name.split("-")
        out.append((int(parts[1]), int(parts[2])))
    return sorted(out)


def list_filesets(root: str | pathlib.Path, ns: str, shard: int) -> list[tuple[int, int]]:
    """Complete (block_start, volume) pairs — checkpoint present.
    Only the LATEST volume per block start is returned: a higher volume
    supersedes lower ones (written by unseal-merge re-flushes,
    ref: persist/fs merger semantics + volume index in fs.go)."""
    d = pathlib.Path(root) / ns / str(shard)
    if not d.exists():
        return []
    latest: dict[int, int] = {}
    for p in d.glob("fileset-*-checkpoint.db"):
        parts = p.name.split("-")
        bs, vol = int(parts[1]), int(parts[2])
        if vol >= latest.get(bs, -1):
            latest[bs] = vol
    return sorted(latest.items())
