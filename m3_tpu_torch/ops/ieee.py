"""Elementwise float64 forms with the reference's (XLA's) semantics where
PyTorch's differ.

- ``maximum``/``minimum``: ``jnp.maximum``/``jnp.minimum``.  NaN
  propagates, and -0.0 orders below +0.0 whatever the operand order
  (``torch.maximum(-0.0, 0.0)`` returns the second operand).
- ``sign``: ``jnp.sign``.  Keeps the sign of a zero and NaN
  (``torch.sign`` maps -0.0 and NaN to +0.0).

Plain tensor code, the same on the CPU and the card.
"""

from __future__ import annotations

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
