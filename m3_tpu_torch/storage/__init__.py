"""Storage: the block seal's batched encode (``shard.py``).  The shard
with its buffer, commit log and filesets waits for ROADMAP.md's queue 1
item 8."""
