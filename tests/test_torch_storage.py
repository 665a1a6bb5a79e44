"""Port parity: the storage node (Database, Shard, filesets, index, caches)
and the decode readers it uses, against the JAX package.

The same columnar writes go into a port ``Database(device="cpu")`` (E1's
and K3's plain versions) and a reference ``Database`` (commit log off on
both, 4 shards, a few hundred samples over three 2h blocks, with
out-of-order and duplicate timestamps).  What is held equal:

- reads from open buffers, sealed blocks and flushed filesets: points
  equal (times exactly, values bit for bit);
- sealed and flushed streams: byte for byte;
- filesets: each side's reader reads the other side's files;
- the cold rewrite after a reseal (the unseal merge): the merged streams;
- ``fetch_tagged`` with matchers, the decoded-block cache off and on.

``decode_streams_adaptive`` and ``decode_streams_merged`` are held against
the reference on the probe streams (grouped and ungrouped slots, an
out-of-order lane that makes the merged reader return None).
"""

import functools
import tempfile

import numpy as np
import pytest
import torch

from m3_tpu.ops import m3tsz_decode as jdec
from m3_tpu.storage.database import Database as JDatabase
from m3_tpu.storage.database import DatabaseOptions as JDatabaseOptions
from m3_tpu.storage.fileset import FilesetReader as JFilesetReader
from m3_tpu.storage.namespace import NamespaceOptions as JNamespaceOptions
from m3_tpu_torch.cache import CacheOptions
from m3_tpu_torch.models import corpus
from m3_tpu_torch.ops import m3tsz_decode as tdec
from m3_tpu_torch.ops import m3tsz_scalar as tsz
from m3_tpu_torch.storage.database import Database, DatabaseOptions
from m3_tpu_torch.storage.fileset import FilesetReader, list_filesets
from m3_tpu_torch.storage.namespace import NamespaceOptions

SEC = 1_000_000_000
MIN = 60 * SEC
HOUR = 3600 * SEC
BLOCK = 2 * HOUR
T0 = 1_600_000_000 * SEC
B0 = T0 - T0 % BLOCK


def _writes(seed=4):
    """~400 samples of 12 series over three blocks: shuffled, with
    duplicate timestamps (the later write wins) and float values."""
    rng = np.random.default_rng(seed)
    ids, tags, ts, vs = [], [], [], []
    for i in range(12):
        sid = b"m{job=%d,i=%d}" % (i % 3, i)
        for _ in range(34):
            ids.append(sid)
            tags.append({b"__name__": b"m", b"job": b"j%d" % (i % 3), b"i": b"%d" % i})
            ts.append(B0 + int(rng.integers(0, 3 * 720)) * 10 * SEC)
            vs.append([float(rng.integers(0, 50)), rng.normal() * 100, 0.5][i % 3])
    order = rng.permutation(len(ids))
    pick = lambda xs: [xs[k] for k in order]  # noqa: E731
    return pick(ids), pick(tags), pick(ts), pick(vs)


def _dbs(pd, jd, cache=CacheOptions()):
    port = Database(DatabaseOptions(path=pd, num_shards=4, commit_log_enabled=False,
                                    cache=cache), device="cpu")
    ref = JDatabase(JDatabaseOptions(path=jd, num_shards=4, commit_log_enabled=False))
    port.create_namespace(NamespaceOptions(name="default"))
    ref.create_namespace(JNamespaceOptions(name="default"))
    return port, ref


def _pts(payload):
    if isinstance(payload, (bytes, bytearray, memoryview)):
        t, v = tsz.decode_series(bytes(payload))
        return np.asarray(t, np.int64), np.asarray(v, np.float64)
    return np.asarray(payload[0], np.int64), np.asarray(payload[1], np.float64)


def _same_points(got, want, what):
    gt, gv = got
    wt, wv = want
    np.testing.assert_array_equal(gt, wt, err_msg=what)
    np.testing.assert_array_equal(np.isnan(gv), np.isnan(wv), err_msg=what)
    ok = np.isnan(gv) | (gv.view(np.int64) == wv.view(np.int64))
    assert ok.all(), f"{what}: {gv[~ok][:3]} != {wv[~ok][:3]}"


def _same_series(port, ref, ids, what):
    for sid in sorted(set(ids)):
        got = port.fetch_series("default", sid, 0, 2**62)
        want = ref.fetch_series("default", sid, 0, 2**62)
        assert [b for b, _ in got] == [b for b, _ in want], (what, sid)
        for (bs, g), (_, w) in zip(got, want):
            assert type(g) is type(w) or (isinstance(g, bytes) and isinstance(w, bytes))
            if isinstance(w, (bytes, bytearray)):
                assert bytes(g) == bytes(w), (what, sid, bs)
            _same_points(_pts(g), _pts(w), f"{what} {sid} {bs}")


def _drop_sealed(*dbs):
    """Drop the in-memory copies of flushed blocks so reads hit the
    filesets (as the reference's cache tests do)."""
    for db in dbs:
        for shard in db._ns("default").shards.values():
            shard._sealed.clear()


def _streams(db):
    return {bs: [(s, t, bytes(p)) for s, t, p in db.series_streams_for_block("default", bs)]
            for bs in (B0, B0 + BLOCK, B0 + 2 * BLOCK)}


def test_database_lifecycle_matches_reference():
    ids, tags, ts, vs = _writes()
    with tempfile.TemporaryDirectory() as pd, tempfile.TemporaryDirectory() as jd:
        port, ref = _dbs(pd, jd)
        for db in (port, ref):
            db.write_batch("default", ids, tags, ts, vs)
        _same_series(port, ref, ids, "open buffers")
        # seal the first two blocks only, then flush them
        now = B0 + 2 * BLOCK + 11 * MIN
        assert port.tick(now_nanos=now) == ref.tick(now_nanos=now)
        _same_series(port, ref, ids, "sealed")
        sealed = _streams(port)
        assert sealed == _streams(ref) and sealed[B0] and sealed[B0 + BLOCK]
        assert port.flush() == ref.flush()
        _same_series(port, ref, ids, "flushed")
        _drop_sealed(port, ref)
        _same_series(port, ref, ids, "read from filesets")
        assert _streams(port) == sealed
        # filesets: the same (shard, block, volume) sets, and each side's
        # reader reads the other's files
        for shard in range(4):
            files = list_filesets(f"{pd}/data", "default", shard)
            assert files == list_filesets(f"{jd}/data", "default", shard)
            for bs, vol in files:
                mine = FilesetReader(f"{pd}/data", "default", shard, bs, vol)
                theirs = JFilesetReader(f"{jd}/data", "default", shard, bs, vol)
                cross = FilesetReader(f"{jd}/data", "default", shard, bs, vol)
                assert mine.ids == theirs.ids == cross.ids
                assert mine.tags == theirs.tags
                for sid in mine.ids:
                    assert mine.read(sid) == bytes(theirs.read(sid)) == cross.read(sid)
        # a cold rewrite into a flushed block: the next tick reseals the
        # merged block, the next flush writes a new volume
        cold_ids = [ids[0], ids[0], ids[5]]
        cold_t = [B0 + 10 * SEC, B0 + 17 * SEC, B0 + BLOCK + 3 * MIN]
        cold_v = [-1.5, 7.0, 3.25]
        for db in (port, ref):
            db.load_batch("default", cold_ids, [tags[0], tags[0], tags[5]], cold_t, cold_v)
        _same_series(port, ref, ids, "unsealed")
        assert port.tick(now_nanos=now) == ref.tick(now_nanos=now)
        assert _streams(port) == _streams(ref)
        assert port.flush() == ref.flush()
        _same_series(port, ref, ids, "reflushed")
        got = dict(zip(*_pts(port.fetch_series("default", ids[0], B0, B0 + 1)[0][1])))
        assert got[B0 + 10 * SEC] == -1.5 and got[B0 + 17 * SEC] == 7.0
        for shard in range(4):
            assert list_filesets(f"{pd}/data", "default", shard) == \
                list_filesets(f"{jd}/data", "default", shard)
        port.close()
        ref.close()


@pytest.mark.parametrize("policy", ["none", "lru"])
def test_fetch_tagged_matches_reference(policy):
    ids, tags, ts, vs = _writes(seed=8)
    cache = CacheOptions(decoded_policy=policy)
    matchers = [[("eq", b"job", b"j1")], [("re", b"i", b"1.*")],
                [("eq", b"__name__", b"m"), ("neq", b"job", b"j0")]]
    with tempfile.TemporaryDirectory() as pd, tempfile.TemporaryDirectory() as jd:
        port, ref = _dbs(pd, jd, cache)
        for db in (port, ref):
            db.write_batch("default", ids, tags, ts, vs)
            db.tick(now_nanos=B0 + BLOCK + 11 * MIN)  # seal the first block
            db.flush()
        _drop_sealed(port, ref)
        for rnd in range(2):  # the second round reads a warm cache
            for m in matchers:
                for with_counts in (False, True):
                    got = port.fetch_tagged("default", m, B0, B0 + 3 * BLOCK,
                                            with_counts=with_counts)
                    want = ref.fetch_tagged("default", m, B0, B0 + 3 * BLOCK,
                                            with_counts=with_counts)
                    assert list(got) == list(want) and got
                    for sid in want:
                        g, w = got[sid], want[sid]
                        assert [e[0] for e in g] == [e[0] for e in w]
                        for eg, ew in zip(g, w):
                            if policy == "none" or not with_counts:
                                assert type(eg[1]) is type(ew[1])
                            _same_points(_pts(eg[1]), _pts(ew[1]), f"{m} {sid}")
                            if with_counts:
                                assert eg[2] == ew[2] or (policy == "lru" and eg[2] == len(
                                    _pts(eg[1])[0]))
        if policy == "lru":
            dc = port._decoded_cache
            assert len(dc) > 0 and dc.hits > 0 and dc.device.type == "cpu"
        port.close()
        ref.close()


def test_database_unported_options_raise(tmp_path):
    with pytest.raises(TypeError, match="path"):
        DatabaseOptions()  # no default directory to share
    with pytest.raises(NotImplementedError, match="commit log"):
        Database(DatabaseOptions(path=str(tmp_path)), device="cpu")
    db = Database(DatabaseOptions(path=str(tmp_path), commit_log_enabled=False),
                  device="cpu")
    with pytest.raises(NotImplementedError, match="structured"):
        db.create_namespace(NamespaceOptions(name="s", schema=object()))
    db.close()


def test_database_default_device_needs_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Database(DatabaseOptions(path=str(tmp_path), commit_log_enabled=False))


# --- the decode readers -----------------------------------------------------


def _reader_streams():
    return corpus.probe_streams(36) + corpus.walk_streams(6, 50)


@pytest.mark.parametrize("with_counts", [False, True])
def test_decode_streams_adaptive_matches_reference(with_counts, monkeypatch):
    """Held against the reference's device decode (K3's XLA program and its
    scalar fallback), the path the port runs: on the CPU the reference
    would route ``decode_streams`` through its native C++ decoder, which
    reads points out of the three garbage probe streams that the device
    kernel flags as errors (ROADMAP.md queue 3)."""
    monkeypatch.setattr(jdec, "decode_streams",
                        functools.partial(jdec.decode_streams, prefer_native=False))
    streams = _reader_streams()
    counts = None
    if with_counts:  # v2-fileset counts, one of them stale (understated)
        counts = np.array([len(tsz.decode_series(s)[0]) if i < 10 else 0
                           for i, s in enumerate(streams)], dtype=np.int64)
        counts[3] = max(counts[3] - 1, 0)
    got = tdec.decode_streams_adaptive(streams, counts=counts, device="cpu")
    want = jdec.decode_streams_adaptive(streams, counts=counts)
    gt, gv, gm = got
    wt, wv, wm = (np.asarray(x) for x in want)
    assert gm.shape[0] == wm.shape[0] == len(streams)
    for lane in range(len(streams)):
        _same_points((gt[lane][gm[lane]], gv[lane][gm[lane]]),
                     (wt[lane][wm[lane]], wv[lane][wm[lane]]), f"lane {lane}")


@pytest.mark.parametrize("layout", ["grouped", "ungrouped", "out_of_order"])
def test_decode_streams_merged_matches_reference(layout):
    walks = corpus.walk_streams(8, 40)
    if layout == "grouped":
        # two blocks per lane in time order: the second block's walk starts
        # after the first one's last point
        later = corpus.walk_streams(4, 40, seed=9, start=corpus.START + 1000 * SEC)
        streams = [walks[0], later[0], walks[1], walks[2], later[1], walks[3]]
        slots = np.array([0, 0, 1, 2, 2, 4])
        n_lanes = 5
    elif layout == "ungrouped":
        streams, slots, n_lanes = walks[:4], np.array([1, 0, 1, 2]), 3
    else:  # backward timestamps inside a stream
        streams = [walks[0], corpus.probe_streams(36)[2]]
        slots, n_lanes = np.array([0, 1]), 2
    got = tdec.decode_streams_merged(streams, slots, n_lanes)
    want = jdec.decode_streams_merged(streams, slots, n_lanes)
    if layout == "grouped":
        assert got is not None and want is not None
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        assert got is None and want is None
