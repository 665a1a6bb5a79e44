"""Batched streaming window accumulators: the aggregator's device state.

Port of ``m3_tpu/aggregator/elems.py``.  The reference keeps one heap
object per (metric, aggregation key, window) (ref:
src/aggregator/aggregator/generic_elem.go:119 findOrCreate, :202 AddUnion,
:267 Consume; src/aggregator/aggregation/{counter.go,gauge.go,timer.go}).
Here the elems of one resolution are eight dense tensors on the device:
lane = one (metric, aggregation key) pair, each lane owning a ring of W
window slots, laid out slot-major: flat = slot * capacity + lane (the
reference's is lane-major, lane * W + slot), so a batch of one window over
consecutive lanes touches consecutive slots.  Ingest is one scatter over
a sample batch (A1a), flush a gather + slot reset (A1b), and timer
quantiles a padded sort + weighted nearest-rank pick (A1c).  Slot state is
the reference's moment vector: sum / sum_sq / count / min / max /
last(+time) (ref: counter.go:42-75, gauge.go:45-80).

- On CUDA state, ``scatter_update``, ``gather_reset`` and
  ``padded_quantiles`` launch the kernels of ``csrc/aggregator_elems.cu``;
  they raise if a kernel cannot be built or launched.  A1a and A1b check
  their slot indices on the card (min, max, order) and read the check back
  in the call's one sync; an index outside the state raises
  ``ValueError`` with the state untouched (A1a launches after the read,
  A1b before it, behind a guard that reads the check on the card).  The
  state is updated in place (the reference donates it to its jitted
  functions).
- On CPU state they run the plain PyTorch versions beside them, which fix
  the same arithmetic order on any device: the samples of a slot are
  applied in arrival order, one pass per rank within the slot.

Epoch rule: a slot is keyed by its window-aligned start.  A sample for a
newer window that maps to an occupied slot wins, and the stale
(unflushed) contents are discarded; samples older than the slot's
resident epoch are dropped and counted.

Timer quantiles: raw timer samples are buffered on the host per flush
interval and reduced at flush time (``padded_quantiles``).  The buffer is
bounded: past ``timer_reservoir_cap`` rows, hot (lane, window) slots are
compacted KLL-style into weighted points (see ``_compact_reservoir``).

The reference's device-memory ledger registration waits for the port's
device telemetry (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from m3_tpu_torch.ops import _build
from m3_tpu_torch.utils.device import resolve_device

F64 = torch.float64
I64 = torch.int64

# Slot-empty sentinel for win_start / last_time (far before any real time).
EMPTY = -(1 << 62)

# (name, empty value) of each state field, in ElemState order
_EMPTY_OF = (("win_start", EMPTY), ("sum", 0.0), ("sum_sq", 0.0), ("count", 0),
             ("min", float("inf")), ("max", float("-inf")), ("last_time", EMPTY),
             ("last", float("nan")))
_DTYPES = (I64, F64, F64, I64, F64, F64, I64, F64)


class ElemState(NamedTuple):
    """Flattened [W * cap] window-slot state (the pool's flat = slot *
    capacity + lane; the kernels take any flat indices)."""

    win_start: torch.Tensor  # i64, EMPTY when slot is free
    sum: torch.Tensor  # f64
    sum_sq: torch.Tensor  # f64
    count: torch.Tensor  # i64: counts NaN datapoints too (gauge.go:62-66)
    min: torch.Tensor  # f64, +inf when no non-NaN value yet
    max: torch.Tensor  # f64, -inf when no non-NaN value yet
    last_time: torch.Tensor  # i64, EMPTY when no datapoint yet
    last: torch.Tensor  # f64


def init_state(capacity: int, windows: int, device=None) -> ElemState:
    dev = resolve_device(device)
    n = capacity * windows
    return ElemState(*(torch.full((n,), empty, dtype=dt, device=dev)
                       for (_, empty), dt in zip(_EMPTY_OF, _DTYPES)))


# ---------------------------------------------------------------------------
# A1a: one ingest batch into the ring slots
# ---------------------------------------------------------------------------


def _min_ieee(a, b):
    """IEEE minimum of non-NaN operands, -0.0 below +0.0 (XLA's scatter-min)."""
    return torch.where(a < b, a, torch.where(b < a, b, torch.where(torch.signbit(a), a, b)))


def _max_ieee(a, b):
    return torch.where(a > b, a, torch.where(b > a, b, torch.where(torch.signbit(a), b, a)))


# A1a's calls on the card by path: "runs" (a batch in slot order, no sort)
# and "grouped" (group_by_slot first)
A1A_PATHS = {"runs": 0, "grouped": 0}


def group_by_slot(flat: torch.Tensor):
    """The batch grouped by slot in arrival order: (order i64[N], the
    sample indices sorted stably by slot; slots i64[S], the touched slots
    ascending; offsets i64[S + 1] into ``order``)."""
    keys, order = torch.sort(flat, stable=True)
    slots, counts = torch.unique_consecutive(keys, return_counts=True)
    offsets = torch.zeros(len(slots) + 1, dtype=I64, device=flat.device)
    torch.cumsum(counts, dim=0, out=offsets[1:])
    return order, slots, offsets


def scatter_update_plain(state: ElemState, flat, start, times, values) -> torch.Tensor:
    """Plain PyTorch version of ``scatter_update`` (same arguments; updates
    ``state`` in place and returns the stale count)."""
    n_batch = flat.shape[0]
    dev = flat.device
    order, slots, offsets = group_by_slot(flat)
    # epoch resolution: the newest window start wins each touched slot
    epoch = state.win_start.clone().scatter_reduce_(0, flat, start, "amax")
    changed = epoch[slots] != state.win_start[slots]
    for (_, empty), x in zip(_EMPTY_OF, state):
        x[slots] = torch.where(changed, torch.full_like(x[slots], empty), x[slots])
    state.win_start[slots] = epoch[slots]

    keep = start == epoch[flat]  # the sample belongs to the resident epoch
    contrib = keep & ~torch.isnan(values)  # NaN excluded from the moments
    vz = torch.where(contrib, values, 0.0)
    vmin = torch.where(contrib, values, torch.inf)
    vmax = torch.where(contrib, values, -torch.inf)
    tk = torch.where(keep, times, EMPTY)
    # pass r applies the r-th sample (in arrival order) of every slot, so
    # the slots of one pass are unique
    pos = torch.arange(n_batch, device=dev)
    counts = offsets[1:] - offsets[:-1]
    rank = pos - torch.repeat_interleave(offsets[:-1], counts)  # of order[k]
    for r in range(int(counts.max()) if n_batch else 0):
        i = order[rank == r]
        s = flat[i]
        state.sum[s] = state.sum[s] + vz[i]
        state.sum_sq[s] = state.sum_sq[s] + vz[i] * vz[i]
        state.count[s] = state.count[s] + keep[i].to(I64)
        state.min[s] = _min_ieee(state.min[s], vmin[i])
        state.max[s] = _max_ieee(state.max[s], vmax[i])
        state.last_time[s] = torch.maximum(state.last_time[s], tk[i])
    # `last` = value of the last-arriving kept sample at the greatest time
    winner = keep & (times == state.last_time[flat])
    best = torch.full_like(state.win_start, -1).scatter_reduce_(
        0, flat[winner], pos[winner], "amax")[slots]
    state.last[slots] = torch.where(best >= 0, values[best.clamp(min=0)], state.last[slots])
    return (~keep).sum(dtype=I64)


_SIGNATURES = {
    "m3_slot_check": [_build.P, _build.LL, _build.P, _build.P],
    "m3_scatter_update": [_build.P, _build.P, _build.P, _build.LL, _build.P, _build.P,
                          _build.P, _build.P, _build.P, _build.P],
    "m3_gather_reset": [_build.P, _build.P, _build.LL, _build.I, _build.P, _build.P, _build.LL,
                        _build.P],
    "m3_padded_quantiles": [_build.P, _build.P, _build.LL, _build.I, _build.I, _build.P,
                            _build.I, _build.I, _build.P, _build.P, _build.P, _build.P],
}


def _lib():
    return _build.library("aggregator_elems", _SIGNATURES)


def _check_state(state: ElemState, *batch: torch.Tensor) -> torch.device:
    dev = state.win_start.device
    for x, dt in zip(state, _DTYPES):
        if x.dtype != dt or x.device != dev or not x.is_contiguous():
            raise ValueError("ElemState fields must be contiguous, on one device, "
                             "of the ElemState dtypes")
    for x in batch:
        if x.device != dev:
            raise ValueError(f"batch tensor on {x.device}, state on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


_SIGN = 1 << 63
_U64 = (1 << 64) - 1


def _from_key(key: int) -> int:
    """The i64 whose order key (its bits with the sign flipped, as u64) is
    ``key``."""
    x = (key & _U64) ^ _SIGN
    return x - (1 << 64) if x >= _SIGN else x


def _decode_check(raw: list[int]) -> tuple[int, int, bool]:
    """(min, max, non-decreasing) from the slot check's first three words:
    the greatest ~key, the greatest key, the unsorted flag."""
    return _from_key(~raw[0]), _from_key(raw[1]), raw[2] == 0


def _slot_check(flat: torch.Tensor) -> torch.Tensor:
    """Launch the slot check on ``flat`` (a contiguous i64 [N] CUDA tensor,
    N > 0): its i64[4] words on the card, unread (``_read_check``); the
    fourth is a zero for A1a's stale count."""
    words = torch.empty(4, dtype=I64, device=flat.device)
    lib = _lib()
    rc = lib.m3_slot_check(flat.data_ptr(), flat.numel(), words.data_ptr(),
                           torch.cuda.current_stream(flat.device).cuda_stream)
    _build.check(lib, rc, "slot_check")
    return words


def _read_check(words: torch.Tensor, state: ElemState) -> bool:
    """Read the slot check (the call's one sync) and raise unless its slots
    lie in the state, which the kernels index without bounds checks; True
    if they are non-decreasing."""
    lo, hi, in_order = _decode_check(words[:3].tolist())
    if lo < 0 or hi >= state.win_start.numel():
        raise ValueError(f"slot indices {lo}..{hi} outside the state's "
                         f"{state.win_start.numel()} slots")
    return in_order


def _pointers(state: ElemState) -> np.ndarray:
    return np.asarray([x.data_ptr() for x in state], dtype=np.uint64)


def scatter_update(state: ElemState, flat: torch.Tensor, start: torch.Tensor,
                   times: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """One ingest batch into ``state``, in place: flat i64[N] slot indices,
    start i64[N] window starts, times i64[N], values f64[N].  Returns the
    number of samples dropped as stale (older than their slot's epoch), an
    i64 scalar tensor.

    On the card A1a takes one of two paths, after the slot check (one
    sync): a batch in slot order (``flat`` non-decreasing) goes straight to
    the kernel, which finds each slot's run itself; any other batch is
    grouped by ``group_by_slot`` first (a stable sort; its
    ``unique_consecutive`` syncs once more).  Both apply a slot's samples in
    batch order, the order of the reference's scatter, so both give the
    bits of ``scatter_update_plain``."""
    dev = _check_state(state, flat, start, times, values)
    if not (flat.dim() == 1 and start.shape == times.shape == values.shape == flat.shape):
        raise ValueError("flat, start, times and values must be one [N] shape")
    flat, start, times = flat.to(I64), start.to(I64), times.to(I64)
    values = values.to(F64)
    if dev.type == "cpu":
        return scatter_update_plain(state, flat, start, times, values)
    if flat.numel() == 0:
        return torch.zeros((), dtype=I64, device=dev)
    flat = flat.contiguous()
    start, times, values = start.contiguous(), times.contiguous(), values.contiguous()
    words = _slot_check(flat)
    dropped = words[3]
    if _read_check(words, state):
        A1A_PATHS["runs"] += 1
        _scatter_kernel(state, flat, None, None, start, times, values, dropped)
    else:
        A1A_PATHS["grouped"] += 1
        order, slots, offsets = group_by_slot(flat)
        _scatter_kernel(state, slots, offsets, order, start, times, values, dropped)
    return dropped


def _scatter_kernel(state: ElemState, slots, offsets, order, start, times, values,
                    dropped) -> None:
    """Launch A1a on a batch whose slots lie in the state; adds the stale
    count into ``dropped``.  Grouped by ``group_by_slot``: ``slots``,
    ``offsets`` and ``order`` as it returns them; in slot order: ``slots``
    is the batch's flat itself and ``offsets`` and ``order`` are None."""
    ptrs = _pointers(state)
    lib = _lib()
    rc = lib.m3_scatter_update(ptrs.ctypes.data, slots.data_ptr(),
                               None if offsets is None else offsets.data_ptr(), len(slots),
                               None if order is None else order.data_ptr(),
                               start.data_ptr(), times.data_ptr(), values.data_ptr(),
                               dropped.data_ptr(),
                               torch.cuda.current_stream(slots.device).cuda_stream)
    _build.check(lib, rc, "scatter_update")
    _build.count_launch("scatter_update")


# ---------------------------------------------------------------------------
# A1b: gather the flushed slots, then reset them
# ---------------------------------------------------------------------------


def gather_reset_plain(state: ElemState, flats: torch.Tensor, reset: bool = True) -> ElemState:
    """Plain PyTorch version of ``gather_reset`` (same arguments and result)."""
    out = ElemState(*(x[flats] for x in state))
    if reset:
        for (_, empty), x in zip(_EMPTY_OF, state):
            x[flats] = empty
    return out


def gather_reset(state: ElemState, flats: torch.Tensor, reset: bool = True) -> ElemState:
    """The slots ``flats`` (i64[F], unique) of ``state`` as an ElemState of
    [F] tensors; with ``reset`` the slots are then emptied in place.  On
    the card one call launches the slot check and A1b behind its guard (a
    coalesced copy where the flats are consecutive); then the check's read,
    the call's one sync: out-of-range flats raise there, the state
    untouched."""
    dev = _check_state(state, flats)
    flats = flats.to(I64).contiguous()
    if dev.type == "cpu":
        return gather_reset_plain(state, flats, reset)
    n = flats.numel()
    ints = torch.empty((3, n), dtype=I64, device=dev).unbind()
    floats = torch.empty((5, n), dtype=F64, device=dev).unbind()
    out = ElemState(ints[0], *floats[:2], ints[1], *floats[2:4], ints[2], floats[4])
    if n:
        words = torch.empty(4, dtype=I64, device=dev)
        _gather_kernel(state, flats, reset, out, words)
        _read_check(words, state)
    return out


def _gather_kernel(state: ElemState, flats: torch.Tensor, reset: bool, out: ElemState,
                   words: torch.Tensor | None = None) -> None:
    """Launch A1b into ``out``.  With ``words`` (i64[4] on the card) the
    entry first runs the slot check of flats into them and the copy touches
    nothing unless every flat lies in the state; without, the flats must."""
    ptrs, out_ptrs = _pointers(state), _pointers(out)
    lib = _lib()
    rc = lib.m3_gather_reset(ptrs.ctypes.data, flats.data_ptr(), flats.numel(), int(reset),
                             out_ptrs.ctypes.data, None if words is None else words.data_ptr(),
                             state.win_start.numel(),
                             torch.cuda.current_stream(flats.device).cuda_stream)
    _build.check(lib, rc, "gather_reset")
    _build.count_launch("gather_reset")


# ---------------------------------------------------------------------------
# A1c: weighted nearest-rank quantiles over an inf-padded [F, K] matrix
# ---------------------------------------------------------------------------

MAX_QUANTILES = 32  # kMaxQ of csrc/aggregator_elems.cu
WARP_K = 32  # kWarpK: rows of at most this many samples sort in registers, 32 / P rows a warp
WARP_ROWS_PER_BLOCK = 8  # kWarpTierThreads / 32: rows of 32 samples a block of that tier
SMEM_MAX_P = 8192  # kSmemMaxP, 20 B a pair: longer padded rows sort in global scratch
SCRATCH_BYTES = 256 << 20  # cap on the global scratch of long rows


def _order_keys(values: torch.Tensor) -> torch.Tensor:
    """int64 keys in the order of jnp.argsort: -0.0 == +0.0, NaN after +inf."""
    v = torch.where(torch.isnan(values), torch.nan, values)
    v = torch.where(v == 0, 0.0, v)
    b = v.view(I64)
    return b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFF)


def padded_quantiles_plain(values: torch.Tensor, weights: torch.Tensor,
                           qs: tuple[float, ...]) -> torch.Tensor:
    """Plain PyTorch version of ``padded_quantiles`` (same arguments and result)."""
    F, K = values.shape
    order = torch.sort(_order_keys(values), dim=1, stable=True).indices
    vs = torch.gather(values, 1, order)
    cw = torch.cumsum(torch.gather(weights, 1, order), dim=1)
    total = cw[:, -1]
    outs = []
    for q in qs:
        idx = (cw < (q * total)[:, None]).sum(dim=1).clamp(0, K - 1)
        picked = torch.gather(vs, 1, idx[:, None])[:, 0]
        picked = torch.where(torch.isinf(picked), 0.0, picked)
        if K > 1:  # the reference's masked sum: -0.0 + 0.0 is +0.0
            picked = torch.where(picked == 0, 0.0, picked)
        outs.append(torch.where(total > 0, picked, 0.0))
    if not outs:
        return torch.zeros((F, 0), dtype=F64, device=values.device)
    return torch.stack(outs, dim=-1)


def padded_quantiles(values: torch.Tensor, weights: torch.Tensor,
                     qs: tuple[float, ...]) -> torch.Tensor:
    """Weighted nearest-rank quantiles over an inf-padded [F, K] sample
    matrix (pad weight 0): [F, len(qs)].

    For unit weights this is rank = ceil(q*n), 1-indexed, the target the
    reference's CM stream approximates (ref: cm/stream.go:141-175).  The
    running weights are summed in sorted order: one after another in the
    plain version, by a parallel scan (other groupings of the same adds)
    in the kernel; the two agree bit for bit when those partial sums are
    exact, as they are for the pool's power-of-two weights."""
    if values.dim() != 2 or weights.shape != values.shape:
        raise ValueError(f"values and weights must be one [F, K] shape, got "
                         f"{tuple(values.shape)} and {tuple(weights.shape)}")
    if values.device != weights.device:
        raise ValueError("values and weights must be on one device")
    F, K = values.shape
    if K < 1:
        raise ValueError("K must be at least 1")
    values, weights = values.to(F64), weights.to(F64)
    if values.device.type == "cpu":
        return padded_quantiles_plain(values, weights, qs)
    if not values.is_cuda:
        raise ValueError(f"unsupported device {values.device}")
    if len(qs) > MAX_QUANTILES:
        raise ValueError(f"at most {MAX_QUANTILES} quantiles per call")
    return _launch_quantiles(values.contiguous(), weights.contiguous(), qs)


def _launch_quantiles(values: torch.Tensor, weights: torch.Tensor,
                      qs: tuple[float, ...]) -> torch.Tensor:
    """A1c on contiguous f64 [F, K] tensors of the card: the tier by K, its
    grid, and the global scratch of rows past SMEM_MAX_P."""
    F, K = values.shape
    dev = values.device
    out = torch.empty((F, len(qs)), dtype=F64, device=dev)
    if F == 0 or not qs:
        return out
    P = 1 << (K - 1).bit_length()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    keys = cols = None
    if K <= WARP_K:
        rows_per_block = WARP_ROWS_PER_BLOCK * (32 // P)
        grid = min(-(-F // rows_per_block), 32 * sms)
    elif P > SMEM_MAX_P:
        grid = max(1, min(F, 2 * sms, SCRATCH_BYTES // (12 * P)))
        keys = torch.empty((grid, P), dtype=I64, device=dev)
        cols = torch.empty((grid, P), dtype=torch.int32, device=dev)
    else:
        grid = min(F, 16 * sms)
    q = np.asarray(qs, dtype=np.float64)
    lib = _lib()
    rc = lib.m3_padded_quantiles(values.data_ptr(), weights.data_ptr(), F, K, P, q.ctypes.data,
                                 len(qs), grid,
                                 None if keys is None else keys.data_ptr(),
                                 None if cols is None else cols.data_ptr(), out.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "padded_quantiles")
    _build.count_launch("padded_quantiles")
    return out


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------


class FlushedWindows(NamedTuple):
    """Host-side result of one flush pass (numpy arrays, length F)."""

    lanes: np.ndarray  # int64 lane index
    starts: np.ndarray  # int64 window-aligned start nanos
    sum: np.ndarray
    sum_sq: np.ndarray
    count: np.ndarray
    min: np.ndarray  # NaN when window had no non-NaN value
    max: np.ndarray
    last: np.ndarray


class ElemPool:
    """All elems of one resolution: dense device state + host lane map.

    Replaces the reference's metricList of elems
    (ref: src/aggregator/aggregator/list.go:155) for one resolution.  The
    state lives on ``device`` (default ``cuda``), slot-major: window slot
    s of lane l is flat s * capacity + l (``_flat``, ``lanes_of``)."""

    def __init__(self, resolution_nanos: int, capacity: int = 256,
                 windows: int = 8, timer_reservoir_cap: int = 1 << 20,
                 timer_summary_size: int = 2048, device=None):
        if windows < 2:
            raise ValueError("need >= 2 window slots per lane")
        self.device = resolve_device(device)
        self.resolution = int(resolution_nanos)
        self.windows = int(windows)
        self.capacity = int(capacity)
        self.n_lanes = 0
        self.dropped_stale = 0
        # open (unflushed) window-start range, to size the ring; the
        # reference has no cap (map keyed by aligned start,
        # generic_elem.go findOrCreate) so the ring grows on demand.
        self._open_min: int | None = None
        self._open_max: int | None = None
        self._flushed_to = -(1 << 62)  # last flush cutoff: older = late
        self._state = init_state(self.capacity, self.windows, self.device)
        # Raw timer sample reservoir for quantile lanes (host side):
        # chunks of (flat_idx i64[], start i64[], value f64[], weight
        # f64[]); raw samples carry weight 1.  BOUNDED: when the total
        # buffered rows cross `timer_reservoir_cap`, hot (flat, start)
        # slots spill into `timer_summary_size` equal-mass weighted
        # points, per-compaction rank error <= 1/(2*summary_size)
        # (ref: src/aggregator/aggregation/quantile/cm/stream.go:104,
        # cm/options.go:33 defaultEps = 1e-3).
        self.timer_reservoir_cap = int(timer_reservoir_cap)
        self.timer_summary_size = int(timer_summary_size)
        # seeded coin for KLL pair selection (deterministic per pool)
        self._rng = np.random.default_rng(0xA55)
        self.n_timer_compactions = 0
        self._timer_rows = 0
        # next compaction trigger; doubles past the cap when a pass
        # can't reduce further, keeping compaction cost amortized O(rows)
        self._compact_at = self.timer_reservoir_cap
        self._timer_chunks: list[tuple[np.ndarray, np.ndarray,
                                       np.ndarray, np.ndarray]] = []

    # -- lanes ---------------------------------------------------------------

    def alloc_lane(self) -> int:
        lane = self.n_lanes
        self.n_lanes += 1
        if self.n_lanes > self.capacity:
            self._grow(max(self.capacity * 2, self.n_lanes))
        return lane

    def _grow(self, new_cap: int) -> None:
        """Widen each window's row of lanes to ``new_cap`` (slot-major: the
        [W, capacity] state becomes [W, new_cap]), the reservoir's flats
        with it."""
        old, w = self.capacity, self.windows

        def widen(x: torch.Tensor, empty) -> torch.Tensor:
            y = torch.full((w, new_cap), empty, dtype=x.dtype, device=x.device)
            y[:, :old] = x.view(w, old)
            return y.view(-1)

        self._state = ElemState(*(widen(x, empty)
                                  for x, (_, empty) in zip(self._state, _EMPTY_OF)))
        self._timer_chunks = [((flat // old) * new_cap + flat % old, start, val, wt)
                              for flat, start, val, wt in self._timer_chunks]
        self.capacity = new_cap

    def _grow_windows(self, new_w: int) -> None:
        """Re-layout to a wider ring (slot-major flat = slot * capacity +
        lane)."""
        cap, res = self.capacity, self.resolution
        st = ElemState(*(x.cpu().numpy() for x in self._state))
        occ = np.nonzero(st.win_start != EMPTY)[0]
        starts = st.win_start[occ]
        nf = ((starts // res) % new_w) * cap + self.lanes_of(occ)
        n = cap * new_w
        host = ElemState(
            win_start=np.full(n, EMPTY, np.int64),
            sum=np.zeros(n), sum_sq=np.zeros(n),
            count=np.zeros(n, np.int64),
            min=np.full(n, np.inf), max=np.full(n, -np.inf),
            last_time=np.full(n, EMPTY, np.int64),
            last=np.full(n, np.nan))
        for dst, src in zip(host, st):
            dst[nf] = src[occ]
        self._state = ElemState(*(torch.from_numpy(x).to(self.device) for x in host))
        self._timer_chunks = [
            (((start // res) % new_w) * cap + self.lanes_of(flat), start, val, w)
            for flat, start, val, w in self._timer_chunks]
        self.windows = new_w

    # -- ingest --------------------------------------------------------------

    def window_start(self, t_nanos: np.ndarray) -> np.ndarray:
        return t_nanos - t_nanos % self.resolution

    def _flat(self, lanes: np.ndarray, starts: np.ndarray) -> np.ndarray:
        slot = (starts // self.resolution) % self.windows
        return slot * self.capacity + lanes

    def lanes_of(self, flats: np.ndarray) -> np.ndarray:
        """The lanes of flat slot indices (the inverse of ``_flat`` given
        the window)."""
        return flats % self.capacity

    def update(self, lanes: np.ndarray, times: np.ndarray,
               values: np.ndarray, timer_mask: np.ndarray | None = None,
               allow_late: bool = False) -> None:
        """Ingest one sample batch (host arrays, any length > 0).

        allow_late admits samples for windows at/before the flush
        watermark: used for forwarded (next pipeline stage) metrics,
        which the reference likewise accepts past the source window's
        flush (forwarding delay, forwarded_writer.go)."""
        lanes = np.asarray(lanes, dtype=np.int64)
        times = np.asarray(times, dtype=np.int64)
        values = np.asarray(values, dtype=np.float64)
        starts = self.window_start(times)
        # drop samples older than the last flush cutoff (the reference
        # rejects writes beyond the allowed lateness, entry.go)
        late = (starts + self.resolution <= self._flushed_to
                if not allow_late else np.zeros(len(starts), dtype=bool))
        if late.any():
            self.dropped_stale += int(late.sum())
            keep = ~late
            lanes, times, values, starts = (
                lanes[keep], times[keep], values[keep], starts[keep])
            if timer_mask is not None:
                timer_mask = timer_mask[keep]
            if lanes.size == 0:
                return
        # size the ring to hold every open window simultaneously
        lo = int(starts.min()) if self._open_min is None \
            else min(self._open_min, int(starts.min()))
        hi = int(starts.max()) if self._open_max is None \
            else max(self._open_max, int(starts.max()))
        self._open_min, self._open_max = lo, hi
        span = (hi - lo) // self.resolution + 1
        if span > self.windows:
            w = 2 * self.windows
            while w < span + 1:
                w *= 2
            self._grow_windows(w)
        flat = self._flat(lanes, starts)
        dev = self.device
        dropped = scatter_update(
            self._state, torch.from_numpy(flat).to(dev), torch.from_numpy(starts).to(dev),
            torch.from_numpy(times).to(dev), torch.from_numpy(values).to(dev))
        self.dropped_stale += int(dropped)
        if timer_mask is not None and timer_mask.any():
            n = int(timer_mask.sum())
            self._timer_chunks.append((
                flat[timer_mask], starts[timer_mask], values[timer_mask],
                np.ones(n)))
            self._timer_rows += n
            if self._timer_rows > self._compact_at:
                self._compact_reservoir()
                self._compact_at = max(self.timer_reservoir_cap,
                                       self._timer_rows * 2)

    # -- flush ---------------------------------------------------------------

    def expired_flats(self, cutoff_nanos: int) -> np.ndarray:
        """Slots whose window END is <= cutoff (ordered by start)."""
        ws = self._state.win_start.cpu().numpy()
        flats = np.nonzero((ws != EMPTY) &
                           (ws + self.resolution <= cutoff_nanos))[0]
        return flats[np.argsort(ws[flats], kind="stable")]

    def flush_before(self, cutoff_nanos: int) -> FlushedWindows | None:
        flats = self.expired_flats(cutoff_nanos)
        self._flushed_to = max(self._flushed_to, cutoff_nanos)
        # remaining open windows all have start > cutoff - resolution
        floor = ((cutoff_nanos - self.resolution) // self.resolution + 1
                 ) * self.resolution
        if self._open_min is not None:
            if self._open_max is not None and self._open_max < floor:
                self._open_min = self._open_max = None
            else:
                self._open_min = max(self._open_min, floor)
        if flats.size == 0:
            return None
        out = gather_reset(self._state, torch.from_numpy(flats).to(self.device), True)
        out = ElemState(*(x.cpu().numpy() for x in out))
        empty_min = np.isinf(out.min)
        return FlushedWindows(
            lanes=self.lanes_of(flats),
            starts=out.win_start,
            sum=out.sum,
            sum_sq=out.sum_sq,
            count=out.count,
            min=np.where(empty_min, np.nan, out.min),
            max=np.where(np.isinf(out.max), np.nan, out.max),
            last=out.last,
        )

    def purge_timer_reservoir(self) -> None:
        """Drop reservoir entries at/behind the flush watermark.

        Samples whose window was epoch-overwritten or kernel-dropped
        never match a flushed window, so without this they would be
        retained forever (unbounded host memory under out-of-order
        timer traffic)."""
        if not self._timer_chunks:
            return
        flat, start, val, w = self._concat_reservoir()
        keep = start + self.resolution > self._flushed_to
        self._timer_chunks = (
            [(flat[keep], start[keep], val[keep], w[keep])]
            if keep.any() else [])
        self._timer_rows = int(keep.sum())
        self._compact_at = max(self.timer_reservoir_cap,
                               self._timer_rows * 2)

    def _concat_reservoir(self):
        return (np.concatenate([c[0] for c in self._timer_chunks]),
                np.concatenate([c[1] for c in self._timer_chunks]),
                np.concatenate([c[2] for c in self._timer_chunks]),
                np.concatenate([c[3] for c in self._timer_chunks]))

    def _compact_reservoir(self) -> None:
        """Bound the reservoir with KLL-style level compaction: rows
        carry power-of-two weights (raw samples weight 1 = level 0);
        whenever a (slot, level) group exceeds 2x `timer_summary_size`
        rows, its value-sorted rows are PAIRED and one of each pair,
        chosen by a seeded coin per compaction, is promoted with doubled
        weight to the next level.  The random coin makes the rank errors
        of the O(log n) nested compactions cancel instead of compounding
        (Karnin-Lang-Liberty 2016).  Memory: <= 2m rows per occupied
        level, O(m log n) per hot slot."""
        m = self.timer_summary_size
        flat, start, val, w = self._concat_reservoir()
        n_slots = np.int64(self.capacity * self.windows)
        # orders groups by (window, lane) here as in the reference's
        # lane-major pool, so the seeded coins fall on the same groups
        slot_key = (start // self.resolution) * n_slots + flat
        level = np.round(np.log2(w)).astype(np.int64)
        # done rows can never overflow again this compaction: after the
        # first pass only slots that just received promotions are
        # re-examined, so each cascade level sorts a shrinking subset
        done = [x[:0] for x in (flat, start, val, w, level)]
        while len(flat):
            key = slot_key * 64 + level
            order = np.lexsort((val, key))
            flat, start, val, w, slot_key, level, key = (
                x[order] for x in (flat, start, val, w, slot_key,
                                   level, key))
            _uniq, first, counts = np.unique(
                key, return_index=True, return_counts=True)
            hot = np.nonzero(counts > 2 * m)[0]
            if hot.size == 0:
                break
            keep_mask = np.ones(len(key), dtype=bool)
            parts = []
            affected = set()
            for g in hot:
                lo, n = int(first[g]), int(counts[g])
                sl = slice(lo, lo + n)
                keep_mask[sl] = False
                affected.add(int(slot_key[lo]))
                vv = val[sl]
                o = int(self._rng.integers(2))
                n_pairs = n // 2
                kept = vv[o:2 * n_pairs:2]
                parts.append((
                    np.full(n_pairs, flat[lo]),
                    np.full(n_pairs, start[lo]),
                    kept,
                    np.full(n_pairs, w[lo] * 2.0),
                    np.full(n_pairs, level[lo] + 1),
                ))
                if n % 2:  # odd leftover stays at its level
                    parts.append((flat[lo:lo + 1], start[lo:lo + 1],
                                  vv[-1:], w[lo:lo + 1],
                                  level[lo:lo + 1]))
                self.n_timer_compactions += 1
            parts.append((flat[keep_mask], start[keep_mask],
                          val[keep_mask], w[keep_mask],
                          level[keep_mask]))
            flat, start, val, w, level = (
                np.concatenate(p) for p in zip(*parts))
            slot_key = (start // self.resolution) * n_slots + flat
            # park rows of unaffected slots; only promoted slots can
            # cascade further
            aff = np.asarray(sorted(affected), dtype=np.int64)
            sel = np.isin(slot_key, aff)
            done = [np.concatenate([d, x[~sel]]) for d, x in zip(
                done, (flat, start, val, w, level))]
            flat, start, val, w, level = (
                x[sel] for x in (flat, start, val, w, level))
            slot_key = slot_key[sel]
        flat, start, val, w, _lv = (
            np.concatenate([d, x]) for d, x in zip(
                done, (flat, start, val, w, level)))
        self._timer_chunks = [(flat, start, val, w)]
        self._timer_rows = len(flat)

    def timer_padded(self, flushed: FlushedWindows):
        """The reservoir rows of the flushed windows as the padded
        ([F, K] values, [F, K] weights) numpy pair ``padded_quantiles``
        takes (None when none), consuming them from the reservoir."""
        nf = flushed.lanes.size
        if not self._timer_chunks:
            return None
        flat_all, start_all, val_all, w_all = self._concat_reservoir()
        fflat = self._flat(flushed.lanes, flushed.starts)
        # Map reservoir samples -> flushed row via (flat, start) identity.
        order = np.argsort(fflat, kind="stable")
        pos = np.searchsorted(fflat[order], flat_all)
        pos = np.clip(pos, 0, nf - 1)
        row = order[pos]
        hit = (fflat[row] == flat_all) & (flushed.starts[row] == start_all)
        # retain everything not flushed this pass
        if (~hit).any():
            self._timer_chunks = [(flat_all[~hit], start_all[~hit],
                                   val_all[~hit], w_all[~hit])]
        else:
            self._timer_chunks = []
        self._timer_rows = int((~hit).sum())
        self._compact_at = max(self.timer_reservoir_cap,
                               self._timer_rows * 2)
        row, vals, ws = row[hit], val_all[hit], w_all[hit]
        if row.size == 0:
            return None
        # Bucket into padded [F, K] matrices (host data movement only).
        order2 = np.argsort(row, kind="stable")
        row, vals, ws = row[order2], vals[order2], ws[order2]
        counts = np.bincount(row, minlength=nf)
        k = int(counts.max())
        row_first = np.cumsum(counts) - counts  # start offset of each row
        col = np.arange(row.size) - row_first[row]
        padded = np.full((nf, k), np.inf)
        padded[row, col] = vals
        weights = np.zeros((nf, k))
        weights[row, col] = ws
        return padded, weights

    def timer_quantiles(self, flushed: FlushedWindows,
                        qs: tuple[float, ...]) -> np.ndarray:
        """[F, len(qs)] quantiles for the flushed windows; consumes the
        reservoir entries that belonged to them."""
        padded = self.timer_padded(flushed)
        if padded is None:
            return np.zeros((flushed.lanes.size, len(qs)))
        values, weights = (torch.from_numpy(x).to(self.device) for x in padded)
        return padded_quantiles(values, weights, tuple(qs)).cpu().numpy()
