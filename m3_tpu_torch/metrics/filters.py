"""Tag filters with glob patterns.

(ref: src/metrics/filters/filter.go — per-tag patterns supporting
``*`` wildcards, ``{a,b}`` alternation, ``[0-9]`` ranges, and negation
``!``; a metric matches when every tag filter matches.)

A filter is ``{tag_name: pattern}`` plus an optional ``__name__``
pattern for the metric name (the coordinator's tag-based world) — the
string form accepted is the reference's rule-config style
``tag1:pat1 tag2:pat2``.
"""

from __future__ import annotations

import re


def _glob_to_regex(pattern: str) -> re.Pattern:
    out, i = [], 0
    while i < len(pattern):
        c = pattern[i]
        if c == "*":
            out.append(".*")
        elif c == "?":
            out.append(".")
        elif c == "{":
            j = pattern.index("}", i)
            alts = pattern[i + 1:j].split(",")
            out.append("(?:" + "|".join(re.escape(a) for a in alts) + ")")
            i = j
        elif c == "[":
            j = pattern.index("]", i)
            out.append(pattern[i:j + 1])
            i = j
        else:
            out.append(re.escape(c))
        i += 1
    return re.compile("".join(out).encode())


class TagFilter:
    def __init__(self, filters: dict[bytes, str]):
        """filters: tag name -> glob pattern ('!' prefix negates)."""
        self._tests: list[tuple[bytes, re.Pattern, bool]] = []
        for name, pat in filters.items():
            if any(c.isspace() for c in pat):
                # the canonical config-string form is whitespace-
                # separated; a space inside a pattern cannot round-trip
                # through KV serialization (ref: rule config filters
                # are space-free tag:glob tokens)
                raise ValueError(
                    f"filter pattern {pat!r} must not contain whitespace")
            # names face the same round-trip constraint, plus ':' which
            # delimits name from pattern, plus they must survive a
            # UTF-8 decode/encode cycle through the KV document
            try:
                decoded = name.decode("utf-8")
            except UnicodeDecodeError:
                raise ValueError(
                    f"filter tag name {name!r} must be valid UTF-8") from None
            if any(c.isspace() or c == ":" for c in decoded):
                raise ValueError(
                    f"filter tag name {name!r} must not contain "
                    "whitespace or ':'")
            negate = pat.startswith("!")
            if negate:
                pat = pat[1:]
            self._tests.append((name, _glob_to_regex(pat), negate))
        # canonical config-string form, for serialization (rules in KV)
        self.source = " ".join(
            f"{name.decode('utf-8')}:{pat}"
            for name, pat in filters.items())

    @staticmethod
    def parse(s: str) -> "TagFilter":
        """``tag1:pat1 tag2:pat2`` (ref: rule config filter strings)."""
        filters = {}
        for part in s.split():
            name, _, pat = part.partition(":")
            if not pat:
                raise ValueError(f"bad filter component {part!r}")
            filters[name.encode()] = pat
        tf = TagFilter(filters)
        tf.source = s
        return tf

    def matches(self, tags: dict[bytes, bytes]) -> bool:
        for name, rx, negate in self._tests:
            value = tags.get(name)
            if value is None:
                return False   # the tag must exist, negated or not
            ok = rx.fullmatch(value) is not None
            if ok == negate:
                return False
        return True
