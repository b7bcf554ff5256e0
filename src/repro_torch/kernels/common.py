"""Helpers shared by every kernel family of the port."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """Resolve an entry point's ``device`` argument.

    ``None`` means the CUDA device: the port runs on the card unless the
    caller asks for another device by name.  There is no auto-detection,
    so a machine without CUDA raises here instead of quietly running on
    the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
