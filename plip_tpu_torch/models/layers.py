"""Transformer layers of the CLIP towers, for inference.

The port of ``plip_tpu.models.layers``. Parameters keep the JAX package's
names and layouts (``[in, out]`` weight matrices named ``kernel``), held in
``nn.ParameterDict``s so that a block's ``ln1`` and ``attn`` are the mappings
``ops.attention.attention_sublayer`` takes. The JAX package stacks the blocks
on a leading layer axis and scans them; here ``Transformer`` is a list of
``Block``s run in a Python loop (``utils.checkpoint`` converts between the
two).

Rounding follows the JAX package: LayerNorm statistics in fp32, ``linear``
emits the compute dtype, QuickGELU runs in the compute dtype.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from ..ops.attention import attention_sublayer, layer_norm_rows_reference


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """QuickGELU: x * sigmoid(1.702 x), the CLIP activation."""
    return x * torch.sigmoid(1.702 * x)


def layer_norm(x: torch.Tensor, p: Mapping, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics, output cast back to x's dtype."""
    return layer_norm_rows_reference(x, p["scale"], p["bias"], eps)


def linear(x: torch.Tensor, p: Mapping) -> torch.Tensor:
    """x @ kernel + bias, in x's dtype."""
    y = torch.matmul(x, p["kernel"].to(x.dtype))
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def mlp(x: torch.Tensor, p: Mapping) -> torch.Tensor:
    return linear(quick_gelu(linear(x, p["fc1"])), p["fc2"])


def ln_params(width: int) -> nn.ParameterDict:
    return nn.ParameterDict({"scale": nn.Parameter(torch.ones(width)),
                             "bias": nn.Parameter(torch.zeros(width))})


def linear_params(d_in: int, d_out: int, bias: bool = True) -> nn.ParameterDict:
    p = {"kernel": nn.Parameter(torch.zeros(d_in, d_out))}
    if bias:
        p["bias"] = nn.Parameter(torch.zeros(d_out))
    return nn.ParameterDict(p)


class Block(nn.Module):
    """Pre-LN transformer block: x + attn(LN1 x), then x + MLP(LN2 x).

    The attention half is ``ops.attention.attention_sublayer`` (CUDA kernels
    on the card); the MLP half is plain PyTorch, as it was plain XLA in the
    JAX package."""

    def __init__(self, width: int, heads: int, causal: bool = False, eps: float = 1e-5):
        super().__init__()
        self.heads, self.causal, self.eps = heads, causal, eps
        self.ln1 = ln_params(width)
        self.attn = nn.ModuleDict({"qkv": linear_params(width, 3 * width),
                                   "out": linear_params(width, width)})
        self.ln2 = ln_params(width)
        self.mlp = nn.ModuleDict({"fc1": linear_params(width, 4 * width),
                                  "fc2": linear_params(4 * width, width)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = attention_sublayer(x, self.ln1, self.attn, self.heads, self.causal,
                               eps=self.eps)
        return x + mlp(layer_norm(x, self.ln2, self.eps), self.mlp)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator, layers: int) -> None:
        """OpenAI-CLIP initialization (the JAX package's ``init_block_stack``)."""
        width = self.ln1["scale"].shape[0]
        stds = {"qkv": width ** -0.5,
                "out": (width ** -0.5) * ((2 * layers) ** -0.5)}
        for name, std in stds.items():
            _normal_(self.attn[name]["kernel"], std, generator)
        _normal_(self.mlp["fc1"]["kernel"], (2 * width) ** -0.5, generator)
        _normal_(self.mlp["fc2"]["kernel"], stds["out"], generator)


class Transformer(nn.ModuleList):
    """A stack of ``Block``s, run in order."""

    def __init__(self, width: int, layers: int, heads: int, causal: bool = False,
                 eps: float = 1e-5):
        super().__init__(Block(width, heads, causal, eps) for _ in range(layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self:
            x = block(x)
        return x

    def init_params(self, generator: torch.Generator) -> None:
        for block in self:
            block.init_params(generator, len(self))


def _normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Fill ``t`` with N(0, std^2) drawn on the CPU from ``generator``, so the
    same seed gives the same weights on every device."""
    t.copy_(torch.randn(t.shape, generator=generator) * std)
