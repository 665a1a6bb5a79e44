"""Port parity: AggregateTiles (T1) and TileAggregator over the storage node.

- T1's plain version (``m3_tpu_torch.ops.tiles.aggregate_tiles`` on CPU
  tensors) against the reference's jitted ``aggregate_tiles_kernel`` on the
  same packed streams: seed-42 walks (truncated at 64 steps), the decoder's
  probe streams (error lanes, truncation, garbage), float mode, a
  millisecond unit, and ``corpus.tile_probe_streams`` (ties at a tile's
  greatest time, timestamps going back across tiles, NaN / +-Inf / +-0.0,
  the grid's edges) at block starts on and 1 ns off the second grid.
  Every field matches bit for bit (f64 as bit patterns, NaN positions
  equal), sums included: XLA:CPU runs the scatter-adds in stream order.
- The port's ``TileAggregator`` over a port ``Database(device="cpu")``
  against the reference's over a JAX ``Database``: the same writes into two
  directories (commit log off on both); the sealed source streams equal
  byte for byte and every tile read back equal.
- The cases of the reference's ``tests/test_tiles.py`` on the port.

Each reference shape compiles once: batches are padded to 32 lanes x 160
words.
"""

import functools
import tempfile

import numpy as np
import pytest
import torch

from m3_tpu.ops import tiles as jtiles
from m3_tpu.storage.database import Database as JDatabase
from m3_tpu.storage.database import DatabaseOptions as JDatabaseOptions
from m3_tpu.storage.namespace import NamespaceOptions as JNamespaceOptions
from m3_tpu.storage.tiles import AggregateTilesOptions as JTilesOptions
from m3_tpu.storage.tiles import TileAggregator as JTileAggregator
from m3_tpu_torch.models import corpus
from m3_tpu_torch.ops import m3tsz_scalar as tsz
from m3_tpu_torch.ops import tiles as ttiles
from m3_tpu_torch.ops.bitstream import pack_streams
from m3_tpu_torch.ops.downsample import AggregationType
from m3_tpu_torch.storage.database import Database, DatabaseOptions
from m3_tpu_torch.storage.namespace import NamespaceOptions
from m3_tpu_torch.storage.tiles import AggregateTilesOptions, TileAggregator

from test_torch_m3tsz_decode import assert_same

SEC = 1_000_000_000
MS = 1_000_000
MIN = 60 * SEC
HOUR = 3600 * SEC
T0 = 1_600_000_000 * SEC
START = corpus.START
N_STEPS, N_TILES, LANES, WORDS = 64, 12, 32, 160
OFF_GRID = START + 100 * SEC + 1  # a block start 1 ns past a second


@functools.lru_cache(maxsize=None)
def _case(name):
    """(streams, int_optimized, unit_nanos, tile_nanos, block_start)."""
    if name == "walks":
        return corpus.walk_streams(LANES, 80), True, SEC, MIN, START
    if name == "probes":
        return corpus.probe_streams(N_STEPS), True, SEC, MIN, START
    if name == "tile_probes":
        return (corpus.tile_probe_streams(MIN, N_TILES)
                + corpus.walk_streams(8, 80, seed=5)), True, SEC, MIN, START
    if name == "tile_probes_off_grid":
        return (corpus.tile_probe_streams(MIN, N_TILES)
                + corpus.walk_streams(8, 80, seed=5)), True, SEC, MIN, OFF_GRID
    if name == "float":
        return (corpus.probe_streams(N_STEPS, int_optimized=False)
                + corpus.golden_streams()), False, SEC, MIN, START
    if name == "ms":
        return (corpus.ms_streams(24, N_STEPS) + corpus.walk_streams(8, N_STEPS),
                True, MS, 2 * SEC, START)
    raise KeyError(name)


def _pack(streams):
    words, nbits = pack_streams(streams)
    assert words.shape[1] <= WORDS and len(streams) <= LANES
    words = np.pad(words, ((0, LANES - len(streams)), (0, WORDS - words.shape[1])))
    return words, np.pad(nbits, (0, LANES - len(streams)))


def _agg_same(got, want, what):
    for field in ("sum", "sum_sq", "count", "min", "max", "last"):
        assert_same(getattr(got, field), getattr(want, field), f"{what}.{field}")


@pytest.mark.parametrize("name", ["walks", "probes", "tile_probes",
                                  "tile_probes_off_grid", "float", "ms"])
def test_aggregate_tiles_matches_jax(name):
    streams, int_opt, unit, tile, block_start = _case(name)
    words, nbits = _pack(streams)
    want = jtiles.aggregate_tiles_kernel(
        words, nbits, n_steps=N_STEPS, n_tiles=N_TILES, tile_nanos=tile,
        block_start=block_start, unit_nanos=unit, int_optimized=int_opt)
    got = ttiles.aggregate_tiles(
        torch.from_numpy(words), torch.from_numpy(nbits), N_STEPS, N_TILES, tile,
        block_start, unit_nanos=unit, int_optimized=int_opt)
    _agg_same(got[0], want[0], name)
    assert_same(got[1], want[1], f"{name}.decoded_count")
    assert_same(got[2], want[2], f"{name}.error")
    n = len(streams)
    count = got[0].count.numpy()
    assert count[:n].sum() > 0
    if name in ("walks", "probes"):  # truncation at n_steps is reached
        assert (got[1].numpy()[:n] == N_STEPS).any()
    if name == "probes":  # error lanes and clean lanes alike
        assert got[2][:n].any() and not got[2][:n].all()


def test_tile_probe_corners():
    """The corners the probes exist for, read off the plain version."""
    streams, *_ = _case("tile_probes")
    words, nbits = _pack(streams)
    agg, _, _ = ttiles.aggregate_tiles(torch.from_numpy(words), torch.from_numpy(nbits),
                                       N_STEPS, N_TILES, MIN, START)
    last, mn, mx, cnt = (agg.last.numpy(), agg.min.numpy(), agg.max.numpy(),
                         agg.count.numpy())
    assert last[0, 0] == 5.0 and np.isnan(last[0, 1])  # ties: the last one wins
    assert cnt[1, 0] == 5 and last[1, 0] == 9.0 and cnt[1, 2] == 2  # back across tiles
    assert np.isnan(mn[2, 3]) and np.isnan(mx[2, 3])  # +-Inf extremes -> NaN
    assert cnt[2, 2] == 1 and agg.sum.numpy()[2, 2] == 0.0  # a NaN-only tile
    # in stream order: (0.1 + 0.2) + 0.3, not 0.6
    assert agg.sum.numpy()[4, 0] == 0.1 + 0.2 + 0.3 != 0.6
    assert cnt[3].sum() == 5  # -1s, the grid's end and beyond dropped
    off, _, _ = ttiles.aggregate_tiles(torch.from_numpy(words), torch.from_numpy(nbits),
                                       N_STEPS, N_TILES, MIN, OFF_GRID)
    # 1 ns before the block start is dropped (a truncating division would
    # put it in tile 0); 1 ns before the grid's end is in the last tile
    assert off.count.numpy()[3, 0] == 1 and off.count.numpy()[3, N_TILES - 1] == 1
    # signed zeros (float mode keeps -0.0; the int grammar writes +0.0):
    # -0.0, -0.0, -0.0, -0.0, +0.0 in tile 0 give min -0.0 and max +0.0
    streams, *_ = _case("float")
    words, nbits = _pack(streams)
    agg, _, _ = ttiles.aggregate_tiles(torch.from_numpy(words), torch.from_numpy(nbits),
                                       N_STEPS, N_TILES, MIN, START, int_optimized=False)
    assert agg.count[1, 0] == 5
    assert np.signbit(agg.min.numpy()[1, 0]) and not np.signbit(agg.max.numpy()[1, 0])


# --- TileAggregator over a Database ------------------------------------------


def _writes(n_series=20, per_series=30, seed=9):
    rng = np.random.default_rng(seed)
    ids, tags, ts, vs = [], [], [], []
    for i in range(n_series):
        sid = b"cpu.host%d" % i
        for _ in range(per_series):
            ids.append(sid)
            tags.append({b"__name__": sid, b"host": b"h%d" % (i % 3)})
            ts.append(T0 + int(rng.integers(0, 30)) * MIN + int(rng.integers(0, 60)) * SEC)
            vs.append(float(rng.integers(0, 100)) + [0.0, 0.25, 0.5][i % 3])
    return ids, tags, ts, vs


def _points(payload):
    if isinstance(payload, (bytes, bytearray)):
        t, v = tsz.decode_series(payload)
        return np.asarray(t, np.int64), np.asarray(v, np.float64)
    return np.asarray(payload[0], np.int64), np.asarray(payload[1], np.float64)


def _series_points(db, ns, sid):
    out = {}
    for _, payload in db.fetch_series(ns, sid, 0, 2**62):
        t, v = _points(payload)
        out.update(zip(t.tolist(), v.tolist()))
    return out


def _port_db(td, num_shards=4, **kw):
    return Database(DatabaseOptions(path=td, num_shards=num_shards,
                                    commit_log_enabled=False, **kw), device="cpu")


def _ref_db(td, num_shards=4):
    return JDatabase(JDatabaseOptions(path=td, num_shards=num_shards,
                                      commit_log_enabled=False))


def test_tile_aggregator_matches_reference():
    agg_types = (AggregationType.MEAN, AggregationType.MAX, AggregationType.LAST,
                 AggregationType.SUM)
    ids, tags, ts, vs = _writes()
    with tempfile.TemporaryDirectory() as pd, tempfile.TemporaryDirectory() as jd:
        pdb, jdb = _port_db(pd), _ref_db(jd)
        for db, ns_cls in ((pdb, NamespaceOptions), (jdb, JNamespaceOptions)):
            db.create_namespace(ns_cls(name="raw"))
            db.create_namespace(ns_cls(name="tiles_1m", aggregated=True,
                                       aggregation_resolution=MIN))
            db.write_batch("raw", ids, tags, ts, vs)
            db.tick(now_nanos=T0 + 5 * HOUR)
            db.flush()
        bs = T0 - T0 % (2 * HOUR)
        got_src = pdb.series_streams_for_block("raw", bs)
        want_src = jdb.series_streams_for_block("raw", bs)
        assert len(got_src) == 20
        assert [(s, t, bytes(p)) for s, t, p in got_src] == \
            [(s, t, bytes(p)) for s, t, p in want_src]
        got = TileAggregator(pdb).aggregate_tiles(
            "raw", "tiles_1m", T0, T0 + 2 * HOUR,
            AggregateTilesOptions(tile_nanos=MIN, agg_types=agg_types))
        want = JTileAggregator(jdb).aggregate_tiles(
            "raw", "tiles_1m", T0, T0 + 2 * HOUR,
            JTilesOptions(tile_nanos=MIN, agg_types=agg_types))
        assert (got.n_series, got.n_blocks, got.n_tiles_written, got.n_errors) == \
            (want.n_series, want.n_blocks, want.n_tiles_written, want.n_errors)
        assert got.n_tiles_written > 0 and got.n_errors == 0
        from m3_tpu_torch.aggregator.aggregator import MetricKind, apply_suffix, suffix_for
        for i in range(20):
            for at in agg_types:
                oid = apply_suffix(b"cpu.host%d" % i, suffix_for(MetricKind.GAUGE, at))
                g, w = _series_points(pdb, "tiles_1m", oid), _series_points(jdb, "tiles_1m", oid)
                assert g and g.keys() == w.keys(), oid
                gv = np.array([g[k] for k in sorted(g)])
                wv = np.array([w[k] for k in sorted(w)])
                assert_same(torch.from_numpy(gv), wv, oid.decode())
        # the tiles seal and flush like any block
        for db in (pdb, jdb):
            db.tick(now_nanos=T0 + 8 * HOUR)
            db.flush()
        assert [(s, bytes(p)) for s, _, p in pdb.series_streams_for_block("tiles_1m", bs)] == \
            [(s, bytes(p)) for s, _, p in jdb.series_streams_for_block("tiles_1m", bs)]
        pdb.close()
        jdb.close()


def _tiles_case(case, td):
    """One case of the reference's tests/test_tiles.py on the port."""
    db = _port_db(td, num_shards=2)
    db.create_namespace(NamespaceOptions(name="raw"))
    if case == "resolution_mismatch":
        db.create_namespace(NamespaceOptions(name="t", aggregated=True,
                                             aggregation_resolution=5 * MIN))
        # a 1m tile grid into a namespace advertising 5m is refused
        with pytest.raises(ValueError, match="aggregation_resolution"):
            TileAggregator(db).aggregate_tiles("raw", "t", T0, T0 + HOUR,
                                               AggregateTilesOptions(tile_nanos=MIN))
        res = TileAggregator(db).aggregate_tiles("raw", "t", T0, T0 + HOUR,
                                                 AggregateTilesOptions(tile_nanos=5 * MIN))
        assert res.n_errors == 0
        return
    db.create_namespace(NamespaceOptions(name="t"))
    if case == "tile_must_divide_block":
        with pytest.raises(ValueError, match="divide"):
            TileAggregator(db).aggregate_tiles("raw", "t", T0, T0 + HOUR,
                                               AggregateTilesOptions(tile_nanos=7 * SEC))
    elif case == "quantiles_rejected":
        with pytest.raises(ValueError, match="quantiles"):
            TileAggregator(db).aggregate_tiles(
                "raw", "t", T0, T0 + HOUR,
                AggregateTilesOptions(tile_nanos=MIN, agg_types=(AggregationType.P99,)))
    elif case == "truncation_grown":
        # more points than max_points: the bound grows, nothing truncates
        base = T0 - T0 % (2 * HOUR)
        n_pts = 300
        db.write_batch("raw", [b"dense"] * n_pts, [{b"__name__": b"dense"}] * n_pts,
                       [base + i * SEC for i in range(n_pts)], [float(i) for i in range(n_pts)])
        db.tick(now_nanos=base + 5 * HOUR)
        res = TileAggregator(db).aggregate_tiles(
            "raw", "t", base, base + 2 * HOUR,
            AggregateTilesOptions(tile_nanos=MIN, max_points=32,
                                  agg_types=(AggregationType.SUM,)))
        assert res.n_errors == 0
        got = _series_points(db, "t", b"dense.sum")
        assert got[base + MIN] == sum(range(60))
        assert sum(got.values()) == sum(range(n_pts))
    elif case == "corrupt_payload_isolated":
        ids, tags, ts, vs = [], [], [], []
        for i in range(4):
            for k in range(5):
                ids.append(b"s%d" % i)
                tags.append({b"__name__": b"s%d" % i})
                ts.append(T0 + k * MIN)
                vs.append(float(k))
        db.write_batch("raw", ids, tags, ts, vs)
        db.tick(now_nanos=T0 + 5 * HOUR)
        orig = db.series_streams_for_block

        def poisoned(ns, block_start):
            out = []
            for sid, tg, stream in orig(ns, block_start):
                if sid == b"s1":
                    stream = None  # a corrupt fileset entry
                elif sid == b"s2":
                    stream = b""  # no data, no error
                out.append((sid, tg, stream))
            return out

        db.series_streams_for_block = poisoned
        res = TileAggregator(db).aggregate_tiles(
            "raw", "t", T0, T0 + 2 * HOUR, AggregateTilesOptions(tile_nanos=10 * MIN))
        assert res.n_errors == 1 and res.n_series == 3 and res.n_tiles_written > 0
        assert _series_points(db, "t", b"s0.mean") and _series_points(db, "t", b"s3.mean")
        assert not _series_points(db, "t", b"s1.mean")
        assert not _series_points(db, "t", b"s2.mean")
    else:
        raise KeyError(case)
    db.close()


@pytest.mark.parametrize("case", ["tile_must_divide_block", "quantiles_rejected",
                                  "truncation_grown", "resolution_mismatch",
                                  "corrupt_payload_isolated"])
def test_reference_tile_cases(case):
    with tempfile.TemporaryDirectory() as td:
        _tiles_case(case, td)


def test_tile_aggregator_launches_twice_per_block(monkeypatch):
    """720 points of 10s data in a 2h block saturate the first bound of
    512: TileAggregator runs T1 at 512, then at 1024, as the reference does."""
    calls = []
    real = ttiles.aggregate_tiles

    def spy(*a, **kw):
        calls.append(kw["n_steps"])
        return real(*a, **kw)

    monkeypatch.setattr(ttiles, "aggregate_tiles", spy)
    base = T0 - T0 % (2 * HOUR)
    with tempfile.TemporaryDirectory() as td:
        db = _port_db(td, num_shards=1)
        db.create_namespace(NamespaceOptions(name="raw"))
        db.create_namespace(NamespaceOptions(name="t"))
        ts = [base + (i + 1) * 10 * SEC for i in range(719)] + [base]
        db.write_batch("raw", [b"a"] * 720, [{b"__name__": b"a"}] * 720, ts,
                       [float(i % 7) for i in range(720)])
        db.tick(now_nanos=base + 5 * HOUR)
        res = TileAggregator(db).aggregate_tiles(
            "raw", "t", base, base + 2 * HOUR,
            AggregateTilesOptions(tile_nanos=5 * MIN, agg_types=(AggregationType.COUNT,)))
        assert calls == [512, 1024] and res.n_errors == 0
        got = _series_points(db, "t", b"a.count")
        assert len(got) == 24 and sum(got.values()) == 720
        db.close()
