"""The few calls that differ between the card and the CPU, which the
benchmark's own tests drive at a small size."""

from __future__ import annotations

import gc

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    """``torch.cuda.max_memory_allocated`` since the last ``reset_peak``;
    0 off the card."""
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def free(device) -> None:
    """Return what freed tensors held, so the reference's peak is its own."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
