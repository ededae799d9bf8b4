"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card; anything else is taken as given.

    Raises when CUDA is asked for (explicitly or by default) and no card
    is present: the port never falls back to the CPU on its own — a
    caller who wants the CPU says ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the port "
            "on the CPU")
    return dev
