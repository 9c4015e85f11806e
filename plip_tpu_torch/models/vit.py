"""Standalone ViT image classifier (torchvision ``vit_b_16/32`` shaped): the
port of ``plip_tpu.models.vit``.

The reference fine-tunes torchvision ViTs as supervised baselines
(``fine_tuning/finetune.py:102-112``: ``vit_b_16``/``vit_b_32`` with the
classification head replaced). Graph: conv patchify with bias (``models.clip
.patchify`` and a linear) -> CLS token + learned position embedding -> pre-LN
blocks with exact GELU, LN eps 1e-6 (``Transformer(act="gelu",
eps=1e-6)``: K1's sublayer forward and K2's backward on the card) -> final
LN -> a head on the CLS token, fp32 logits.

Parameters keep the JAX package's names (``patch_embed``, ``class_token``,
``pos_embed``, ``blocks``, ``ln_final``, ``head``); ``load_jax_params``
takes the JAX package's tree (blocks stacked on a leading layer axis), and
``flat_params`` flattens such a tree into this module's state_dict names.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from .clip import _project, patchify
from .config import VisionConfig
from .layers import Remat, Transformer, _normal_, layer_norm, linear_params, ln_params

ARCHS = {
    "vit_b_16": VisionConfig(width=768, layers=12, heads=12, image_size=224, patch_size=16),
    "vit_b_32": VisionConfig(width=768, layers=12, heads=12, image_size=224, patch_size=32),
}

LN_EPS = 1e-6


class ViTClassifier(nn.Module):
    def __init__(self, arch: str, num_classes: int):
        super().__init__()
        cfg = ARCHS[arch]
        self.arch, self.cfg = arch, cfg
        self.patch_embed = linear_params(cfg.patch_size * cfg.patch_size * 3, cfg.width)
        self.class_token = nn.Parameter(torch.zeros(cfg.width))
        self.pos_embed = nn.Parameter(torch.zeros(cfg.seq_len, cfg.width))
        self.blocks = Transformer(cfg.width, cfg.layers, cfg.heads, False, LN_EPS, act="gelu")
        self.ln_final = ln_params(cfg.width)
        self.head = linear_params(cfg.width, num_classes)

    def forward(self, pixels: torch.Tensor, dtype: torch.dtype = torch.float32,
                remat: Remat = False) -> torch.Tensor:
        """NHWC pixels -> fp32 logits ``[B, num_classes]``."""
        cfg = self.cfg
        x = patchify(pixels.to(dtype), cfg.patch_size)
        x = (_project(x, self.patch_embed["kernel"], dtype)
             + self.patch_embed["bias"]).to(dtype)
        cls = self.class_token.to(dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dtype)
        x = self.blocks(x, remat)
        x = layer_norm(x[:, 0], self.ln_final, LN_EPS)
        return x.float() @ self.head["kernel"] + self.head["bias"]

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "ViTClassifier":
        """The JAX package's scheme (``plip_tpu.models.vit.init_params``),
        drawn from ``generator``."""
        width = self.cfg.width
        _normal_(self.patch_embed["kernel"], width ** -0.5, generator)
        _normal_(self.pos_embed, 0.02, generator)
        self.blocks.init_params(generator)
        _normal_(self.head["kernel"], 0.02, generator)
        for t in (self.patch_embed["bias"], self.class_token, self.head["bias"]):
            t.zero_()
        return self

    def load_jax_params(self, params: Mapping) -> "ViTClassifier":
        """Load the JAX package's parameter tree (numpy or JAX arrays)."""
        self.load_state_dict({k: torch.tensor(v) for k, v in flat_params(params).items()})
        return self


def flat_params(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """A JAX parameter tree (nested dicts; ``blocks`` stacked on a leading
    layer axis) -> ``{state_dict name: fp32 array}``, ``blocks.{i}.`` per
    layer."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if k == "blocks":
            stacked = flat_params(v)
            n = next(iter(stacked.values())).shape[0]
            for i in range(n):
                out.update({f"{name}.{i}.{s}": a[i] for s, a in stacked.items()})
        elif isinstance(v, Mapping):
            out.update(flat_params(v, name + "."))
        else:
            out[name] = np.ascontiguousarray(np.asarray(v, np.float32))
    return out
