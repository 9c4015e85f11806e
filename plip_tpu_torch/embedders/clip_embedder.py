"""Cache-first CLIP embedder over the port's ``PLIP``: the port of
``plip_tpu.embedders.clip_embedder`` (the reference harness's
``embedders/plip.py``).

- Image embeddings use the by-name cache layout, text embeddings the
  sha256 one (``utils.cacher``), so entries interchange with the JAX
  package and the reference.
- Outputs are **L2-normalized** (the public ``PLIP`` returns raw features).
- Every image entry records its ``decode_mode`` in a ``.meta.json``
  sidecar. A hit written with ``decode_mode="fast_approx"`` is refused (a
  warning, then recomputed and overwritten) when the caller asks for an
  exact mode; an entry without a sidecar is accepted as "unknown".
"""

from __future__ import annotations

import os
import warnings
from typing import Sequence

import numpy as np

from ..utils.cacher import (
    cache_hit_or_miss,
    cache_numpy_object,
    cache_numpy_object_raw_filename,
    get_savepath,
    read_cache_meta,
    write_cache_meta,
)
from .abst import AbstractEmbedder

# the modes that keep the 0.999-cosine contract (PLIP.encode_images)
_EXACT_MODES = ("fast", "exact")


def _l2(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x, axis=1, keepdims=True)


class CLIPEmbedder(AbstractEmbedder):
    """model: a ``plip_tpu_torch.api.PLIP`` (any architecture)."""

    def __init__(self, model, name: str, backbone: str):
        self.model = model
        self.name = name
        self.backbone = backbone

    def image_embedder(
        self,
        list_of_images: Sequence,
        device=None,
        num_workers: int = 8,
        batch_size: int = 32,
        additional_cache_name: str = "",
        decode_mode: str = "fast",
    ) -> np.ndarray:
        """Cache first; ``device`` is the reference's argument, unused: the
        model runs where it was placed."""
        save_path = get_savepath(self.name + "img" + additional_cache_name, self.backbone)
        if os.path.exists(save_path):
            meta = read_cache_meta(save_path)
            cached_mode = (meta or {}).get("decode_mode")
            if cached_mode == "fast_approx" and decode_mode in _EXACT_MODES:
                warnings.warn(
                    f"cached embeddings at {save_path} were produced with "
                    "decode_mode='fast_approx' (cosine > 0.995, below the "
                    f"0.999 contract) but decode_mode={decode_mode!r} was "
                    "requested — recomputing and overwriting the cache entry."
                )
            else:
                return np.load(save_path)
        emb = self.embed_images(list_of_images, num_workers=num_workers,
                                batch_size=batch_size, decode_mode=decode_mode)
        cache_numpy_object_raw_filename(emb, self.name + "img" + additional_cache_name,
                                        self.backbone)
        write_cache_meta(save_path, {"decode_mode": decode_mode})
        return emb

    def text_embedder(
        self,
        list_of_labels: Sequence[str],
        device=None,
        num_workers: int = 1,
        batch_size: int = 32,
        additional_cache_name: str = "",
    ) -> np.ndarray:
        hit = cache_hit_or_miss(self.name + "txt" + additional_cache_name, self.backbone)
        if hit is not None:
            return hit
        emb = self.embed_text(list_of_labels, batch_size=batch_size)
        cache_numpy_object(emb, self.name + "txt" + additional_cache_name, self.backbone)
        return emb

    def embed_images(self, list_of_images: Sequence, num_workers: int = 8,
                     batch_size: int = 32, decode_mode: str = "fast") -> np.ndarray:
        """``PLIP.encode_images`` (its decode lanes), then the reference's L2
        normalization."""
        emb = self.model.encode_images(list(list_of_images), batch_size=batch_size,
                                       num_workers=num_workers, decode_mode=decode_mode)
        return _l2(emb)

    def embed_text(self, list_of_labels: Sequence[str], batch_size: int = 32) -> np.ndarray:
        return _l2(self.model.encode_text(list(list_of_labels), batch_size=batch_size))
