"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and absent.

    Entry points default to the card. A machine without one must say
    ``device="cpu"`` explicitly: nothing falls back to the CPU on its own.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is visible; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu' "
                         "('meta' for shape-only stand-ins)")
    return dev
