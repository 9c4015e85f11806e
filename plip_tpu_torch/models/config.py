"""Model configuration for the PyTorch CLIP dual encoder.

The same dataclasses, fields and architectures as ``plip_tpu.models.config``
(which imports JAX), so a checkpoint's ``__config__`` JSON means the same
model in both packages. Defaults are the ``vinid/plip`` ViT-B/32:

- image tower: 224x224 input, 32x32 patches -> 49+CLS tokens, width 768,
  12 layers, 12 heads, pre-LN, QuickGELU, LN + linear proj -> 512-d
- text tower: 77-token context, vocab 49408, width 512, 12 layers, 8 heads,
  causal mask, pooled at the first EOT, proj -> 512-d
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class TowerConfig:
    width: int
    layers: int
    heads: int

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


@dataclasses.dataclass(frozen=True)
class VisionConfig(TowerConfig):
    image_size: int = 224
    patch_size: int = 32

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1  # +CLS


@dataclasses.dataclass(frozen=True)
class TextConfig(TowerConfig):
    vocab_size: int = 49408
    context_length: int = 77
    eot_token: Optional[int] = None  # default: vocab_size - 1

    @property
    def eot(self) -> int:
        return self.eot_token if self.eot_token is not None else self.vocab_size - 1


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    vision: VisionConfig = VisionConfig(width=768, layers=12, heads=12)
    text: TextConfig = TextConfig(width=512, layers=12, heads=8)
    embed_dim: int = 512
    logit_scale_init: float = math.log(1.0 / 0.07)
    logit_scale_max: float = math.log(100.0)
    ln_eps: float = 1e-5

    @staticmethod
    def vit_b32() -> "CLIPConfig":
        return CLIPConfig()

    @staticmethod
    def vit_b16() -> "CLIPConfig":
        return CLIPConfig(vision=VisionConfig(width=768, layers=12, heads=12, patch_size=16))

    @staticmethod
    def vit_l14() -> "CLIPConfig":
        return CLIPConfig(
            vision=VisionConfig(width=1024, layers=24, heads=16, patch_size=14),
            text=TextConfig(width=768, layers=12, heads=12),
            embed_dim=768,
        )

    @staticmethod
    def vit_l14_336() -> "CLIPConfig":
        return CLIPConfig(
            vision=VisionConfig(width=1024, layers=24, heads=16,
                                patch_size=14, image_size=336),
            text=TextConfig(width=768, layers=12, heads=12),
            embed_dim=768,
        )

    @staticmethod
    def tiny(vocab_size: int = 64) -> "CLIPConfig":
        """Small config for fast CPU tests."""
        return CLIPConfig(
            vision=VisionConfig(width=64, layers=2, heads=4, image_size=32, patch_size=16),
            text=TextConfig(width=32, layers=2, heads=4, vocab_size=vocab_size, context_length=16),
            embed_dim=24,
        )


ARCHITECTURES = {
    "ViT-B/32": CLIPConfig.vit_b32,
    "ViT-B/16": CLIPConfig.vit_b16,
    "ViT-L/14": CLIPConfig.vit_l14,
    "ViT-L/14@336px": CLIPConfig.vit_l14_336,
}

# CLIP normalization constants.
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)

DEFAULT_COMPUTE_DTYPE = torch.float32
