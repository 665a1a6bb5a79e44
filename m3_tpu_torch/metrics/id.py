"""M3 metric ID codec: ``m3+name+tag1=v1,tag2=v2``.

(ref: src/metrics/metric/id/m3/id.go:30-79 — component splitter '+',
tag pair splitter ',', name splitter '='; rollup IDs append the
``m3_rollup=true`` tag pair and sort pairs by name.)
"""

from __future__ import annotations

M3_PREFIX = b"m3+"
ROLLUP_TAG = (b"m3_rollup", b"true")


def encode_m3_id(name: bytes, tags: dict[bytes, bytes]) -> bytes:
    pairs = b",".join(k + b"=" + tags[k] for k in sorted(tags))
    return M3_PREFIX + name + b"+" + pairs


def decode_m3_id(mid: bytes) -> tuple[bytes, dict[bytes, bytes]]:
    if not mid.startswith(M3_PREFIX):
        raise ValueError(f"not an m3 id: {mid!r}")
    rest = mid[len(M3_PREFIX):]
    name, _, pairs = rest.partition(b"+")
    tags: dict[bytes, bytes] = {}
    if pairs:
        for pair in pairs.split(b","):
            k, _, v = pair.partition(b"=")
            tags[k] = v
    return name, tags


def new_rollup_id(new_name: bytes, tags: dict[bytes, bytes]) -> bytes:
    """(ref: id/m3/id.go:59 NewRollupID): tag pairs + m3_rollup=true,
    sorted by name."""
    t = dict(tags)
    t[ROLLUP_TAG[0]] = ROLLUP_TAG[1]
    return encode_m3_id(new_name, t)


def is_rollup_id(mid: bytes) -> bool:
    try:
        _, tags = decode_m3_id(mid)
    except ValueError:
        return False
    return tags.get(ROLLUP_TAG[0]) == ROLLUP_TAG[1]
