"""Helpers shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device, who: str) -> torch.device:
    """An entry point's device: ``"cuda"`` unless the caller names another.
    Without a CUDA device it raises instead of running on the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who}: no CUDA device; pass device=\"cpu\" to run on "
                               "the CPU")
        device = "cuda"
    return torch.device(device)
