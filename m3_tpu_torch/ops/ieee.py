"""Elementwise float64 forms with the reference's (XLA's) semantics where
PyTorch's differ.

- ``maximum``/``minimum``: ``jnp.maximum``/``jnp.minimum``.  NaN
  propagates, and -0.0 orders below +0.0 whatever the operand order
  (``torch.maximum(-0.0, 0.0)`` returns the second operand).
- ``sign``: ``jnp.sign``.  Keeps the sign of a zero and NaN
  (``torch.sign`` maps -0.0 and NaN to +0.0).
- ``pow``: ``jnp.power`` by a scalar exponent at the special values.
  ``torch.pow`` computes exponents of +-0.5 as a square root, which takes
  -inf to NaN and keeps the sign of -0.0; IEEE pow(-inf, y) and
  pow(-0.0, y) for y not an odd integer are those of +inf and +0.0.
- ``sqrt``: the correctly rounded square root, as XLA's.  ``torch.sqrt``
  is that on the card, but on the CPU it goes through MKL's vector math
  and is an ulp off for about 1% of f64 inputs, so CPU tensors take
  numpy's.

Plain tensor code, the same on the CPU and the card but for ``sqrt``.
"""

from __future__ import annotations

import numpy as np
import torch


def _pair(a, b):
    """Both operands as f64 tensors on the tensor operand's device; a
    Python number becomes a filled 0-d tensor (a fill, not a copy)."""
    dev = (a if isinstance(a, torch.Tensor) else b).device

    def f64(x):
        if isinstance(x, torch.Tensor):
            return x.to(torch.float64)
        return torch.full((), float(x), dtype=torch.float64, device=dev)

    return f64(a), f64(b)


def maximum(a, b) -> torch.Tensor:
    a, b = _pair(a, b)
    m = torch.where(a > b, a, torch.where(b > a, b, torch.where(torch.signbit(a), b, a)))
    return torch.where(torch.isnan(a) | torch.isnan(b), torch.nan, m)


def minimum(a, b) -> torch.Tensor:
    a, b = _pair(a, b)
    m = torch.where(a < b, a, torch.where(b < a, b, torch.where(torch.signbit(a), a, b)))
    return torch.where(torch.isnan(a) | torch.isnan(b), torch.nan, m)


def sign(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))


def pow(x: torch.Tensor, p: float) -> torch.Tensor:
    p = float(p)
    r = torch.pow(x, p)
    if p == p and abs(p) != float("inf") and p == int(p) and int(p) % 2:
        return r  # an odd integer keeps the base's sign
    return torch.where((x == -float("inf")) | (x == 0), torch.pow(torch.abs(x), p), r)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        with np.errstate(invalid="ignore"):
            return torch.from_numpy(np.sqrt(x.to(torch.float64).numpy()))
    return torch.sqrt(x)
