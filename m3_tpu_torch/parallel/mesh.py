"""The device mesh of the port and its collectives.

Port of ``m3_tpu/parallel/mesh.py``.  The reference lays a
``n_series_shards x n_window_shards`` ``jax.sharding.Mesh`` over TPU chips
and runs each pipeline under ``shard_map`` with XLA collectives over ICI.
The port keeps the mesh's shape and shard order (row-major: shard ``k`` is
series shard ``k // n_window_shards``, window shard ``k % n_window_shards``)
and lays the shards on the ranks of a ``torch.distributed`` process group,
rank-major: each rank holds a contiguous block of ``n_shards // world``
shards on its own device.  Without a group there is one rank and every shard
lies on the one device (the card, or the CPU in the parity tests).

- **Lanes.**  The lanes of a rank's shards are one contiguous tensor,
  ``[shards_on_rank * local_lanes, ...]``; shard ``k`` of the rank owns rows
  ``[k * local_lanes, (k + 1) * local_lanes)``.  Per-lane work runs in one
  launch over the rank's lanes (``shard_map`` has no counterpart: PyTorch
  runs eagerly, so its callers are plain functions over the rank's block).
- **Collectives.**  A collective takes each local shard's partial as one row
  of a ``[shards_on_rank, ...]`` tensor.  The rows of every rank are stacked
  into ``[n_shards, ...]`` in shard order (``all_gather_into_tensor`` on the
  group, called whenever the mesh has one, world size 1 included), and the
  ordered reduce MK1 (``ops/mesh_reduce.py``) folds the stack over the
  shards of the axis in ascending order.  So every rank gets the same bits
  whatever NCCL's own order, and one rank with 8 shards the bits of two
  ranks with 4 each.
- ``all_gather`` along lanes is free within a rank (the rows are
  contiguous) and one ``all_gather_into_tensor`` across ranks.
  ``psum_scatter`` folds the whole stack in one MK1 launch and keeps each
  local shard's owned chunk; followed by ``all_gather`` it is the
  reference's sequence-parallel schedule of ``consolidate_windows``.

The mesh never moves work between devices: a CUDA mesh needs an NCCL group
(or none), a CPU mesh a gloo group (or none).  It never creates a group
either: the caller initialises ``torch.distributed``, and a failed NCCL
initialisation raises there.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from m3_tpu_torch.ops import query_grouped
from m3_tpu_torch.ops.mesh_reduce import mesh_reduce
from m3_tpu_torch.utils.device import resolve_device

SERIES_AXIS = "series"
WINDOW_AXIS = "window"
AXES = (SERIES_AXIS, WINDOW_AXIS)


class Mesh:
    """``n_series_shards x n_window_shards`` shards over the ranks of
    ``group`` (None: one rank), each rank's block on ``device``."""

    def __init__(self, n_series_shards: int, n_window_shards: int = 1, device=None,
                 group=None):
        if n_series_shards < 1 or n_window_shards < 1:
            raise ValueError(f"mesh {n_series_shards}x{n_window_shards} has no shard")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:  # the tensors' own name of it
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.group = group
        self.shape = {SERIES_AXIS: int(n_series_shards), WINDOW_AXIS: int(n_window_shards)}
        self.n_shards = int(n_series_shards) * int(n_window_shards)
        if group is None:
            self.world, self.rank = 1, 0
        else:
            backend = dist.get_backend(group)
            want = "nccl" if self.device.type == "cuda" else "gloo"
            if backend != want:
                raise ValueError(f"a mesh on {self.device.type} takes a {want} group, "
                                 f"not {backend}")
            self.world, self.rank = dist.get_world_size(group), dist.get_rank(group)
        if self.n_shards % self.world:
            raise ValueError(f"{self.n_shards} shards do not split over {self.world} ranks")
        self.shards_per_rank = self.n_shards // self.world
        self.first_shard = self.rank * self.shards_per_rank

    def __repr__(self) -> str:
        return (f"Mesh({self.shape[SERIES_AXIS]}x{self.shape[WINDOW_AXIS]}, "
                f"rank {self.rank}/{self.world}, {self.device})")

    @property
    def local_shards(self) -> range:
        return range(self.first_shard, self.first_shard + self.shards_per_rank)

    def rows(self, n_rows: int) -> slice:
        """The rank's rows of an axis of ``n_rows`` split evenly over the
        shards in shard order."""
        if n_rows % self.n_shards:
            raise ValueError(f"{n_rows} rows do not split over {self.n_shards} shards")
        per = n_rows // self.n_shards
        return slice(self.first_shard * per, (self.first_shard + self.shards_per_rank) * per)

    def stack(self, local: torch.Tensor) -> torch.Tensor:
        """[shards_on_rank, ...] partials of the local shards -> [n_shards,
        ...] of every shard, in shard order."""
        if local.shape[0] != self.shards_per_rank:
            raise ValueError(f"expected {self.shards_per_rank} local partials, "
                             f"got {local.shape[0]}")
        return self.gather_rows(local)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's rows -> the rows of every rank, in rank order (one
        ``all_gather_into_tensor`` on the group; none without one)."""
        if x.device != self.device:
            raise ValueError(f"tensor on {x.device}, mesh on {self.device}")
        if self.group is None:
            return x
        x = x.contiguous()
        out = torch.empty((self.world * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x, group=self.group)
        return out


def make_mesh(n_series_shards: int, n_window_shards: int = 1, device=None,
              group=None) -> Mesh:
    """A ``n_series_shards x n_window_shards`` mesh over the ranks of
    ``group`` (None: every shard on the one ``device``, default the CUDA
    device)."""
    return Mesh(n_series_shards, n_window_shards, device, group)


def supports_f64_reduce_scatter(mesh: Mesh) -> bool:
    """Whether the scatter schedule (``psum_scatter`` then ``all_gather``)
    carries f64 on this mesh.  The reference answers False on the TPU, whose
    X64 rewriter implements all-reduce but not reduce-scatter for emulated
    f64; the H100 has IEEE f64 and the port reduces in MK1, so both the
    card and the CPU take it.  Both schedules give the same bits (MK1 folds
    each element over the same shards in the same order)."""
    return mesh.device.type in ("cpu", "cuda")


def _axes(axis) -> frozenset:
    axes = frozenset((axis,) if isinstance(axis, str) else axis)
    if not axes or not axes <= set(AXES):
        raise ValueError(f"unknown mesh axis {axis!r}")
    return axes


def _grid(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """Every shard's partial as [n_series, n_window, ...]."""
    full = mesh.stack(local)
    return full.reshape((mesh.shape[SERIES_AXIS], mesh.shape[WINDOW_AXIS]) + tuple(full.shape[1:]))


def _per_local(mesh: Mesh, red: torch.Tensor, key) -> torch.Tensor:
    """red[key(k)] for each local shard k, stacked."""
    keys = [key(k) for k in mesh.local_shards]
    if len(set(keys)) == 1:
        return red[keys[0]].expand((len(keys),) + tuple(red.shape[1:]))
    return red[keys]


def _reduce(mesh: Mesh, local: torch.Tensor, op: str, axis) -> torch.Tensor:
    axes = _axes(axis)
    n_s, n_w = mesh.shape[SERIES_AXIS], mesh.shape[WINDOW_AXIS]
    g = _grid(mesh, local)
    rest = tuple(g.shape[2:])
    if axes == {SERIES_AXIS}:  # over s at each w
        red = mesh_reduce(g.reshape(n_s, -1), op).reshape((n_w,) + rest)
        return _per_local(mesh, red, lambda k: k % n_w)
    if axes == {WINDOW_AXIS}:  # over w at each s
        red = mesh_reduce(g.transpose(0, 1).reshape(n_w, -1), op).reshape((n_s,) + rest)
        return _per_local(mesh, red, lambda k: k // n_w)
    red = mesh_reduce(g.reshape(n_s * n_w, -1), op).reshape((1,) + rest)
    return _per_local(mesh, red, lambda k: 0)


def psum(mesh: Mesh, local: torch.Tensor, axis) -> torch.Tensor:
    """``jax.lax.psum``: each local shard's partial (rows of ``local``
    [shards_on_rank, ...]) summed over the shards that share its place on
    the other axis (over every shard for both axes) -> [shards_on_rank, ...]."""
    return _reduce(mesh, local, "sum", axis)


def pmin(mesh: Mesh, local: torch.Tensor, axis) -> torch.Tensor:
    """``jax.lax.pmin``, as ``psum``."""
    return _reduce(mesh, local, "min", axis)


def pmax(mesh: Mesh, local: torch.Tensor, axis) -> torch.Tensor:
    """``jax.lax.pmax``, as ``psum``."""
    return _reduce(mesh, local, "max", axis)


def psum_scatter(mesh: Mesh, local: torch.Tensor, axis: str) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axis, scatter_dimension=0, tiled=True)``:
    the sum over ``axis`` of each local shard's partial [N, ...], of which
    the shard keeps the chunk of N it owns (its index along ``axis``) ->
    [shards_on_rank, N // axis size, ...].  The stack is already whole on
    the rank, so one MK1 launch folds all of it and each local shard keeps
    its chunk: the all-reduce's bits and launch count."""
    if axis not in AXES:
        raise ValueError(f"psum_scatter over one axis, got {axis!r}")
    n_w = mesh.shape[WINDOW_AXIS]
    g = _grid(mesh, local)
    n, rest = g.shape[2], tuple(g.shape[3:])
    n_a = mesh.shape[axis]
    if n % n_a:
        raise ValueError(f"{n} rows do not scatter over {n_a} shards")
    by = g if axis == SERIES_AXIS else g.transpose(0, 1)  # reduced axis first
    # [other axis, owner along axis, chunk, ...]
    red = mesh_reduce(by.reshape(n_a, -1), "sum").reshape((by.shape[1], n_a, n // n_a) + rest)
    keys = [divmod(k, n_w) for k in mesh.local_shards]  # (s, w)
    return torch.stack([red[w, s] if axis == SERIES_AXIS else red[s, w] for s, w in keys])


def all_gather(mesh: Mesh, local: torch.Tensor, axis: str) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=0, tiled=True)``: each local
    shard's [c, ...] concatenated in order over the shards along ``axis`` ->
    [shards_on_rank, axis size * c, ...]."""
    if axis not in AXES:
        raise ValueError(f"all_gather over one axis, got {axis!r}")
    n_s, n_w = mesh.shape[SERIES_AXIS], mesh.shape[WINDOW_AXIS]
    g = _grid(mesh, local)
    rest = tuple(g.shape[3:])
    if axis == SERIES_AXIS:
        full = g.transpose(0, 1).reshape((n_w, n_s * g.shape[2]) + rest)
        return _per_local(mesh, full, lambda k: k % n_w)
    full = g.reshape((n_s, n_w * g.shape[2]) + rest)
    return _per_local(mesh, full, lambda k: k // n_w)


def consolidate_windows(mesh: Mesh, partial: torch.Tensor, axis_name: str,
                        use_scatter: bool) -> torch.Tensor:
    """Finish a fleet consolidation over ``axis_name``: ``partial``
    [shards_on_rank, N] is each local shard's vector already summed over the
    series axis.  With ``use_scatter`` each shard reduces only the range of N
    it owns, then the ranges are gathered (the reference's sequence-parallel
    schedule); otherwise one all-reduce.  Both give the same bits."""
    if use_scatter:
        return all_gather(mesh, psum_scatter(mesh, partial, axis_name), axis_name)
    return psum(mesh, partial, axis_name)


# --- placement: the reference's shardings as lane-block layout helpers ---


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32 and x.device != device:  # moved as int32 bit patterns
            return x.view(torch.int32).to(device).view(torch.uint32)
        return x.to(device)
    a = np.ascontiguousarray(x)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).to(device).view(torch.uint32)
    return torch.from_numpy(a).to(device)


def series_sharding(mesh: Mesh, x) -> torch.Tensor:
    """The rank's rows of ``x`` (rows split evenly over every shard, in
    shard order) on the mesh's device: ``device_put(x, series_sharding)``."""
    rows = mesh.rows(len(x))
    return _as_tensor(x[rows], mesh.device)


def replicated(mesh: Mesh, x) -> torch.Tensor:
    """``x`` whole on the mesh's device: ``device_put(x, replicated)``."""
    return _as_tensor(x, mesh.device)


def shard_segments(mesh: Mesh, n_lanes: int, groups=None, n_groups: int = 1) -> np.ndarray:
    """Segment ids of the rank's ``n_lanes`` lanes for a per-shard grouped
    reduce: ``k * n_groups + group`` for a lane of local shard ``k`` (its
    ``groups`` id, 0 without one), -1 for a group id outside
    ``[0, n_groups)`` (no segment, as the reference's segment ops drop it)."""
    spr = mesh.shards_per_rank
    if n_lanes % spr:
        raise ValueError(f"{n_lanes} lanes do not split over {spr} shards")
    base = np.repeat(np.arange(spr, dtype=np.int64) * n_groups, n_lanes // spr)
    if groups is None:
        return base
    g = np.asarray(groups, dtype=np.int64)
    return np.where((g >= 0) & (g < n_groups), base + g, -1)


def shard_reduce(mesh: Mesh, x: torch.Tensor, agg: str = "sum",
                 empty_value: float = 0.0) -> torch.Tensor:
    """``agg`` (a QK4 op) of each local shard's lanes, NaN cells absent:
    the rank's lanes ``x`` [shards_on_rank * local_lanes, N] ->
    [shards_on_rank, N], ``empty_value`` where a shard has no present cell.
    One QK4 launch over segments = shard ids."""
    spr = mesh.shards_per_rank
    if x.shape[0] % spr:
        raise ValueError(f"{x.shape[0]} lanes do not split over {spr} shards")
    if not x.is_cuda:
        return query_grouped.grouped_reduce(x, shard_segments(mesh, x.shape[0]), spr, agg,
                                            empty_value=empty_value)
    # contiguous lane blocks: the kernel's index needs no member list
    per = x.shape[0] // spr
    offsets = torch.arange(spr + 1, dtype=torch.int64) * per
    index = query_grouped.GroupIndex(None, offsets.to(x.device, non_blocking=True),
                                     np.full(spr, per, dtype=np.int64))
    return query_grouped.grouped_reduce(x, None, spr, agg, index, empty_value)
