"""The cosine-warmup learning-rate schedule: the port of
``plip_tpu.train.scheduler`` (the reference's OpenCLIP-derived schedule)."""

from __future__ import annotations

import math

import numpy as np


def cosine_lr(base_lr: float, warmup_length: int, steps: int):
    """schedule(step) -> lr, a Python float computed in float32 as the JAX
    package computes it.

    warmup: ``base_lr * (step + 1) / warmup_length``
    then:   ``0.5 * (1 + cos(pi * e / es)) * base_lr`` with
            ``e = step - warmup``, ``es = steps - warmup``
    """
    f32 = np.float32
    es = max(steps - warmup_length, 1)

    def schedule(step: int) -> float:
        s = f32(step)
        if s < warmup_length:
            return float(f32(base_lr) * (s + f32(1)) / f32(warmup_length))
        e = s - f32(warmup_length)
        cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * e / f32(es))) * f32(base_lr)
        return float(cos)

    return schedule
