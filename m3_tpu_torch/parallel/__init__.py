"""Meshes, their collectives, and the shard-even repack.

Port of ``m3_tpu/parallel``.  The reference scales by hashing series onto
virtual shards placed across nodes; its mesh has two axes:

- ``series`` — data parallelism: a shard is a partition of the lane axis;
- ``window`` — sequence parallelism over the time axis: the fleet
  consolidation's window range splits over its shards.

The port lays the shards on the ranks of a ``torch.distributed`` group (or
all on one device) and reduces every collective in shard order with the
hand-written MK1 (``mesh.py``).  ``repack.py`` lays a packed query batch out
shard-even, as the reference's engine does before a sharded query.
"""

from m3_tpu_torch.parallel.mesh import SERIES_AXIS, WINDOW_AXIS, Mesh, make_mesh  # noqa: F401
