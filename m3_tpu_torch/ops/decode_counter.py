"""Process-wide M3TSZ decode-call counter.

Every public decode entry point (batched stream decoders and the scalar
oracle) bumps this by the number of streams it was handed, as in the
reference package.  The reference also exports it as the
``m3_m3tsz_decode_calls_total`` metric; that export returns with the
port's device-telemetry module — here it is a plain locked integer.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_calls = 0


def bump(n: int = 1) -> None:
    global _calls
    with _lock:
        _calls += n


def value() -> int:
    return _calls
