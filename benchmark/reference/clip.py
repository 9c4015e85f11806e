"""A plain CLIP dual encoder in PyTorch: the yardstick the benchmark holds the
program's embeddings, losses and updates against.

Written from OpenAI CLIP's published model (``model.py``: pre-LN blocks,
QuickGELU, the class token, ``ln_post`` and the projection; the text tower
causal and pooled at the first end-of-text token). It imports nothing of the
program. Parameters are a flat dict in the naming of ``benchmark.weights``
(``[in, out]`` matrices named ``kernel``; the qkv columns ``[q | k | v]``,
heads contiguous within each; patches flattened row-major ``(ph, pw, C)``).

Every product goes through a ``Matmul`` object, so the same forward runs in
float32 with TF32 off (the reference), or in a lower precision (a control:
``benchmark.reference.lowp``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping

import torch
import torch.nn.functional as F

Params = Mapping[str, torch.Tensor]


def fp32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def layer_norm(x: torch.Tensor, P: Params, pre: str, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], P[pre + ".scale"], P[pre + ".bias"], eps)


def block(x: torch.Tensor, P: Params, pre: str, heads: int, causal: bool, eps: float,
          mm: Callable) -> torch.Tensor:
    """x + attn(LN1 x), then x + MLP(LN2 x), MLP = fc2(QuickGELU(fc1 h))."""
    B, S, W = x.shape
    D = W // heads
    h = layer_norm(x, P, pre + ".ln1", eps)
    qkv = mm(h, P[pre + ".attn.qkv.kernel"]) + P[pre + ".attn.qkv.bias"]
    q, k, v = qkv.reshape(B, S, 3, heads, D).permute(2, 0, 3, 1, 4).unbind(0)
    logits = mm(q * D ** -0.5, k.transpose(-1, -2))
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    ctx = mm(torch.softmax(logits, dim=-1), v).transpose(1, 2).reshape(B, S, W)
    x = x + mm(ctx, P[pre + ".attn.out.kernel"]) + P[pre + ".attn.out.bias"]
    h = layer_norm(x, P, pre + ".ln2", eps)
    h = mm(h, P[pre + ".mlp.fc1.kernel"]) + P[pre + ".mlp.fc1.bias"]
    h = h * torch.sigmoid(1.702 * h)
    return x + mm(h, P[pre + ".mlp.fc2.kernel"]) + P[pre + ".mlp.fc2.bias"]


def encode_image(P: Params, pixels: torch.Tensor, cfg: Mapping,
                 mm: Callable = fp32_matmul) -> torch.Tensor:
    """CLIP-normalized NHWC pixels ``[B, H, W, 3]`` -> ``[B, embed_dim]``,
    unnormalized."""
    v, eps = cfg["vision"], cfg["ln_eps"]
    p = v["patch_size"]
    B, H, W, C = pixels.shape
    x = pixels.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
    x = mm(x.reshape(B, (H // p) * (W // p), p * p * C), P["visual.patch_embed.kernel"])
    cls = P["visual.class_embedding"].expand(B, 1, -1)
    x = torch.cat([cls, x], dim=1) + P["visual.pos_embed"]
    x = layer_norm(x, P, "visual.ln_pre", eps)
    for i in range(v["layers"]):
        x = block(x, P, f"visual.blocks.{i}", v["heads"], False, eps, mm)
    x = layer_norm(x[:, 0], P, "visual.ln_post", eps)
    return mm(x, P["visual.proj.kernel"])


def encode_text(P: Params, ids: torch.Tensor, cfg: Mapping,
                mm: Callable = fp32_matmul) -> torch.Tensor:
    """Token ids ``[B, context_length]`` -> ``[B, embed_dim]``, pooled at the
    first end-of-text token (the vocabulary's last id)."""
    t, eps = cfg["text"], cfg["ln_eps"]
    x = P["text.token_embed"][ids] + P["text.pos_embed"]
    for i in range(t["layers"]):
        x = block(x, P, f"text.blocks.{i}", t["heads"], True, eps, mm)
    eot = (ids == t["vocab_size"] - 1).int().argmax(dim=-1)
    x = layer_norm(x[torch.arange(x.shape[0], device=x.device), eot], P, "text.ln_final",
                   eps)
    return mm(x, P["text.proj.kernel"])


def infonce(P: Params, pixels: torch.Tensor, ids: torch.Tensor, cfg: Mapping,
            mm: Callable = fp32_matmul) -> torch.Tensor:
    """CLIP's symmetric cross-entropy over the batch, the logit scale
    ``exp(min(logit_scale, logit_scale_max))``."""
    img = F.normalize(encode_image(P, pixels, cfg, mm), dim=-1)
    txt = F.normalize(encode_text(P, ids, cfg, mm), dim=-1)
    scale = P["logit_scale"].clamp(max=cfg["logit_scale_max"]).exp()
    logits = scale * mm(img, txt.t())
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.t(), labels)) / 2


def cosine_lr(base_lr: float, warmup: int, steps: int) -> Callable[[int], float]:
    """OpenCLIP's schedule: linear warmup ``base_lr (s + 1) / warmup``, then
    a half cosine to 0 at ``steps``."""
    es = max(steps - warmup, 1)

    def schedule(s: int) -> float:
        if s < warmup:
            return base_lr * (s + 1) / warmup
        return 0.5 * (1 + math.cos(math.pi * (s - warmup) / es)) * base_lr

    return schedule


class AdamW:
    """Decoupled AdamW (Loshchilov and Hutter) as optax steps it: the rate of
    the count before the step, bias correction at count + 1, decay
    ``lr * wd * p`` beside the Adam direction."""

    def __init__(self, schedule: Callable[[int], float], weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule, self.wd, self.b1, self.b2, self.eps = schedule, weight_decay, b1, b2, eps
        self.count = 0
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        lr = self.schedule(self.count)
        self.count += 1
        bc1, bc2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for k, p in params.items():
            g = grads[k]
            m = self.mu[k] = self.b1 * self.mu.get(k, torch.zeros_like(p)) + (1 - self.b1) * g
            v = self.nu[k] = self.b2 * self.nu.get(k, torch.zeros_like(p)) + (1 - self.b2) * g * g
            upd = (m / bc1) / ((v / bc2).sqrt() + self.eps) + self.wd * p
            p.sub_(lr * upd)
