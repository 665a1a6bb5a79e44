"""Storage node — the dbnode equivalent (ref: src/dbnode/).

Port of ``m3_tpu/storage``: database -> namespace -> shard with columnar
open buffers, seals that batch-encode a block (E1 on the card), filesets,
the tag index, and AggregateTiles (``tiles.py``, T1 on the card).  The commit log, structured namespaces, peers and the mediator wait
for ROADMAP.md's queue 1 item 5.
"""

from m3_tpu_torch.storage.database import Database, DatabaseOptions  # noqa: F401
from m3_tpu_torch.storage.namespace import NamespaceOptions, RetentionOptions  # noqa: F401
