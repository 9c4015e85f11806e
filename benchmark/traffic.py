"""The one generator of the benchmark's traffic: everything a mix file of
``benchmark/mixes`` asks for, drawn from the run's seed.

- ``tile_pool``: RGB uint8 tiles, a smooth field of colour with grain,
  drawn on the device in one call and brought to the host.
- ``encode_requests``: the pool cut into requests of a fixed number of
  tiles, so every seed sends the same work.
- ``train_rows``: which pool tile each row of a training epoch holds.
- ``captions``: pathology captions from the mix's words, their lengths a
  fixed set of quantiles of a uniform range in an order the seed shuffles.
"""

from __future__ import annotations

from typing import List, Mapping

import numpy as np
import torch
import torch.nn.functional as F


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream of the seed."""
    return np.random.default_rng([stream, seed])


def tile_pool(count: int, px: int, seed: int, device) -> np.ndarray:
    """``[count, px, px, 3]`` uint8 on the host."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 7 + 1) % (1 << 63))
    out = np.empty((count, px, px, 3), np.uint8)
    for lo in range(0, count, 256):  # a block at a time: 256 tiles of fp32 are 200 MB
        n = min(256, count - lo)
        low = torch.rand((n, 3, 8, 8), generator=gen, device=device) * 255
        img = F.interpolate(low, size=(px, px), mode="bilinear", align_corners=False)
        img = img + 24 * torch.randn(img.shape, generator=gen, device=device)
        out[lo:lo + n] = img.clamp(0, 255).round().to(torch.uint8).permute(
            0, 2, 3, 1).cpu().numpy()
    return out


def encode_requests(pool: np.ndarray, request_tiles: int) -> List[List[np.ndarray]]:
    """The pool cut into requests of ``request_tiles`` consecutive tiles, each
    the list of arrays a caller hands ``encode_images``; the window sends
    them in turn, round and round. Built in set-up, not inside a request."""
    if len(pool) % request_tiles:
        raise ValueError(f"a pool of {len(pool)} tiles does not cut into "
                         f"requests of {request_tiles}")
    return [list(pool[lo:lo + request_tiles]) for lo in range(0, len(pool), request_tiles)]


def train_rows(count: int, pool_size: int, seed: int) -> np.ndarray:
    """Pool index of each training row: passes over the pool, each in a new
    order, so any ``pool_size`` consecutive rows differ."""
    r = rng(seed, 2)
    reps = -(-count // pool_size)
    return np.concatenate([r.permutation(pool_size) for _ in range(reps)])[:count]


def captions(mix: Mapping, count: int, seed: int) -> List[str]:
    """``count`` captions of ``words`` drawn from the mix's word list; the
    word counts cycle through evenly spaced values of
    [``caption_words_min``, ``caption_words_max``] in shuffled passes."""
    r = rng(seed, 3)
    lo, hi = mix["caption_words_min"], mix["caption_words_max"]
    lengths = np.arange(lo, hi + 1)
    vocab = mix["caption_vocabulary"].split()
    reps = -(-count // len(lengths))
    counts = np.concatenate([r.permutation(lengths) for _ in range(reps)])[:count]
    picks = r.integers(len(vocab), size=int(counts.sum()))
    out, off = [], 0
    for n in counts:
        out.append(" ".join(vocab[i] for i in picks[off:off + n]))
        off += n
    return out
