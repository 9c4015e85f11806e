"""CLIP dual encoder in PyTorch: the port of ``plip_tpu.models.clip``.

- ``encode_image``: patchify -> patch embed -> +CLS -> +pos -> ln_pre ->
  pre-LN blocks -> CLS token -> ln_post -> proj. Output **unnormalized**.
- ``encode_text``: token + pos embed -> causal blocks -> pool at the first
  EOT -> ln_final -> proj. Output unnormalized.
- ``forward``: L2-normalize both, ``exp(clamp(logit_scale)) * img @ txt.T``.

Parameters stay fp32; each forward takes a compute ``dtype`` (fp32 or bf16)
and casts weights where the JAX package casts them. The projections sum the
compute-dtype operands in fp32 and return fp32, as the JAX package's
``preferred_element_type=float32`` dots do. The patch embed is a
``[patch*patch*3, W]`` matrix over row-major ``(ph, pw, C)`` patches, not a
convolution weight.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn

from ..parallel.distributed import reduce_from_tp
from .config import CLIPConfig
from .layers import Remat, Transformer, _normal_, layer_norm, linear_params, ln_params


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """NHWC image -> ``[B, tokens, patch*patch*C]`` (row-major patch order)."""
    B, H, W, C = pixels.shape
    gh, gw = H // patch, W // patch
    x = pixels.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize`` semantics: the norm is floored at ``eps``, so a zero
    embedding stays zero instead of turning into NaN."""
    return x / x.norm(dim=dim, keepdim=True).clamp_min(eps)


def _project(x: torch.Tensor, kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 ``x . kernel`` of compute-dtype operands (exact products, fp32 sum)."""
    return torch.matmul(x.float(), kernel.to(dtype).float())


class VisionTower(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        v = cfg.vision
        self.patch_size, self.eps = v.patch_size, cfg.ln_eps
        self.patch_embed = linear_params(v.patch_size * v.patch_size * 3, v.width, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(v.width))
        self.pos_embed = nn.Parameter(torch.zeros(v.seq_len, v.width))
        self.ln_pre = ln_params(v.width)
        self.blocks = Transformer(v.width, v.layers, v.heads, False, cfg.ln_eps)
        self.ln_post = ln_params(v.width)
        self.proj = linear_params(v.width, cfg.embed_dim, bias=False)

    def forward(self, pixels: torch.Tensor, dtype: torch.dtype,
                remat: Remat = False) -> torch.Tensor:
        """pixels NHWC ``[B, H, W, 3]`` (CLIP-normalized) -> fp32 ``[B, embed_dim]``."""
        x = patchify(pixels.to(dtype), self.patch_size)
        x = torch.matmul(x, self.patch_embed["kernel"].to(dtype))
        cls = self.class_embedding.to(dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dtype)
        x = layer_norm(x, self.ln_pre, self.eps)
        x = self.blocks(x, remat)
        x = layer_norm(x[:, 0], self.ln_post, self.eps)
        return _project(x, self.proj["kernel"], dtype)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        std = self.class_embedding.shape[0] ** -0.5
        for t in (self.patch_embed["kernel"], self.class_embedding, self.pos_embed,
                  self.proj["kernel"]):
            _normal_(t, std, generator)
        self.blocks.init_params(generator)


class TextTower(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        t = cfg.text
        self.eot, self.eps = t.eot, cfg.ln_eps
        self.token_embed = nn.Parameter(torch.zeros(t.vocab_size, t.width))
        # under tensor parallelism (parallel.mesh.shard_params): the TPGroup,
        # and the first vocabulary row of this rank's token_embed shard
        self.tp, self.vocab_start = None, 0
        self.pos_embed = nn.Parameter(torch.zeros(t.context_length, t.width))
        self.blocks = Transformer(t.width, t.layers, t.heads, True, cfg.ln_eps)
        self.ln_final = ln_params(t.width)
        self.proj = linear_params(t.width, cfg.embed_dim, bias=False)

    def forward(self, ids: torch.Tensor, dtype: torch.dtype,
                remat: Remat = False) -> torch.Tensor:
        """ids ``[B, context_length]`` -> fp32 ``[B, embed_dim]``, pooled at
        the first EOT. The sequence runs unpadded (S=77): the JAX package pads
        it to 80 only to fit the TPU's tiling."""
        x = self.embed_tokens(ids).to(dtype) + self.pos_embed.to(dtype)
        x = self.blocks(x, remat)
        eot_pos = (ids == self.eot).int().argmax(dim=-1)  # first EOT
        pooled = x[torch.arange(x.shape[0], device=x.device), eot_pos]
        pooled = layer_norm(pooled, self.ln_final, self.eps)
        return _project(pooled, self.proj["kernel"], dtype)

    def embed_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        """fp32 ``token_embed[ids]``. Under tp ``token_embed`` is this rank's
        vocabulary rows: an id outside them reads a zero row, the gather is
        local, and the rows are summed over the group (one rank holds each
        id, so the sum is exact); the backward stays on the shard."""
        if self.tp is None:
            return self.token_embed[ids]
        rows = self.token_embed.shape[0]
        local = ids - self.vocab_start
        inside = (local >= 0) & (local < rows)
        emb = self.token_embed[local.clamp(0, max(rows - 1, 0))] if rows else \
            self.token_embed.new_zeros((*ids.shape, self.token_embed.shape[1]))
        return reduce_from_tp(emb * inside.unsqueeze(-1), self.tp)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        _normal_(self.token_embed, 0.02, generator)
        _normal_(self.pos_embed, 0.01, generator)
        self.blocks.init_params(generator)
        _normal_(self.proj["kernel"], self.pos_embed.shape[1] ** -0.5, generator)


class CLIP(nn.Module):
    """The CLIP dual encoder. Parameter names mirror the JAX package's tree
    (``visual.blocks.3.attn.qkv.kernel`` is layer 3 of
    ``visual/blocks/attn/qkv/kernel``)."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.visual = VisionTower(cfg)
        self.text = TextTower(cfg)
        self.logit_scale = nn.Parameter(torch.tensor(cfg.logit_scale_init))

    def encode_image(self, pixels: torch.Tensor, dtype: torch.dtype = torch.float32,
                     remat: Remat = False) -> torch.Tensor:
        return self.visual(pixels, dtype, remat)

    def encode_text(self, ids: torch.Tensor, dtype: torch.dtype = torch.float32,
                    remat: Remat = False) -> torch.Tensor:
        return self.text(ids, dtype, remat)

    def forward(self, pixels: torch.Tensor, ids: torch.Tensor,
                dtype: torch.dtype = torch.float32,
                remat: Union[Remat, Tuple[Remat, Remat]] = False,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits_per_image, logits_per_text). ``remat`` is one policy for
        both towers or an ``(image, text)`` pair (``models.layers``)."""
        r_img, r_txt = remat if isinstance(remat, tuple) else (remat, remat)
        img = l2_normalize(self.encode_image(pixels, dtype, r_img))
        txt = l2_normalize(self.encode_text(ids, dtype, r_txt))
        scale = self.logit_scale.clamp(max=self.cfg.logit_scale_max).exp().float()
        logits_per_image = scale * img @ txt.T
        return logits_per_image, logits_per_image.T

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "CLIP":
        """Random OpenAI-CLIP-style weights drawn from ``generator`` (the JAX
        package's scheme; the numbers differ, since the generators do)."""
        self.visual.init_params(generator)
        self.text.init_params(generator)
        self.logit_scale.fill_(self.cfg.logit_scale_init)
        return self
