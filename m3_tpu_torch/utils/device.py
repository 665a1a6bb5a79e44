"""Device selection for the port's entry points.

Entry points run on the CUDA device unless the caller asks for the CPU,
by ``device="cpu"`` or by handing in CPU tensors.  Without CUDA the
default raises: nothing quietly runs on the CPU in place of the card.
"""

from __future__ import annotations

import torch


def resolve_device(device=None, like: torch.Tensor | None = None) -> torch.device:
    """``device`` if given, else the device of ``like`` if it is a tensor,
    else ``cuda``.  Raises if the result is a CUDA device and there is none."""
    if device is not None:
        dev = torch.device(device)
    elif isinstance(like, torch.Tensor):
        dev = like.device
    else:
        dev = torch.device("cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' (or CPU tensors) to "
            "run the plain PyTorch versions")
    return dev
