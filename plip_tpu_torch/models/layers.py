"""Transformer layers of the CLIP towers.

The port of ``plip_tpu.models.layers``. Parameters keep the JAX package's
names and layouts (``[in, out]`` weight matrices named ``kernel``), held in
``nn.ParameterDict``s so that a block's ``ln1`` and ``attn`` are the mappings
``ops.attention.attention_sublayer`` takes. The JAX package stacks the blocks
on a leading layer axis and scans them; here ``Transformer`` is a list of
``Block``s run in a Python loop (``utils.checkpoint`` converts between the
two).

Rounding follows the JAX package: LayerNorm statistics in fp32, ``linear``
emits the compute dtype, QuickGELU runs in the compute dtype. Every
LayerNorm (``ln_pre``, ``ln_post``, ``ln_final``, LN1, LN2) runs K1's
``ln_rows`` on the card, its backward K2's ``ln_bwd_rows``.

A block's attention half takes one of four paths, as
``plip_tpu.models.layers.transformer`` and ``ops.attention`` decide them by
S, W and ``remat`` (``sublayer_path``):

- ``"attention_sublayer"``: K1's fused sublayer forward, K2 backward
  (``ops.attention``), when S <= 128, or W <= 768, or ``remat`` is not
  False and S > 512 (the JAX package's flat path, padded there to 584);
- ``"hybrid"``: the composed sublayer over K3 forward under K2's backward
  (``ops.attention.attention_sublayer(hybrid=True)``), when ``remat`` is not
  False, W > 768 and 128 < S <= 512 (``_train_fwd_composed``);
- ``"mha_core"`` / ``"flash_core"``: the composed sublayer
  ``x + linear(core(linear(LN1 x)))`` over K3 (S <= 512, backward K4) or K5
  (backward the VJP of the JAX package's ``_jnp_mha``), when ``remat`` is
  False, W > 768 and S > 128 (serving passes ``remat=False``).

A W8A8 block (``ops.quant.quantize_block_linears``: its linears hold
``kernel_q``, no ``kernel``) never takes K1's sublayer, as the JAX package's
gates on ``"kernel" in attn["qkv"]`` keep it off the fused kernels: it runs
the composed sublayer over ``mha_core`` (S <= 512) or ``flash_core`` at every
S and W, its linears ``ops.quant.linear_w8a8``. It is inference only: under
autograd or a ``remat`` other than False it raises.

The JAX package also takes K1 for some wide towers at small batch, where its
TPU block picker happens to accept the whole batch; the port dispatches by
shape only.

Training memory follows the JAX package's ``remat`` policies
(``plip_tpu.models.layers.transformer``):

- ``False`` keeps every activation;
- ``"mlp"`` recomputes only the MLP half in the backward
  (``torch.utils.checkpoint``; its ``[B, S, 4W]`` fc1 activations are most
  of a block's memory, while the attention sublayer saves only its input
  anyway);
- ``"mlp_h1"`` saves the MLP half's input and its fc1 output h1, and
  recomputes LN2 and the activation but not the fc1 product
  (``ops.mlp.mlp_half_h1``); the attention half as under ``"mlp"``;
- ``True`` recomputes the whole block (``torch.utils.checkpoint``);
- ``"block"`` saves only each block's input: the whole block through
  ``ops.block_bwd.block_flat``, whose backward is K7 (CUDA on the card)
  where the JAX package takes its kernel (ViT-B/32 both towers, ViT-B/16
  vision), else the composed block over ``mha_core`` / ``jnp_mha_core``
  (normalize-first above 512 tokens, as the JAX package's padded tower)
  recomputed in the backward (``torch.utils.checkpoint``).
"""

from __future__ import annotations

from typing import Mapping, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention_sublayer, composed_sublayer, layer_norm_rows
from ..ops.block_bwd import block_flat
from ..ops.mha import MAX_SEQ as MHA_MAX_SEQ
from ..ops.mha import flash_core, mha_core
from ..ops.mlp import mlp_half, mlp_half_h1

# K1's sublayer serves S <= SHORT_SEQ at any width (the JAX package's
# attention_sublayer gate), and longer sequences up to this width when
# serving (plip_tpu.models.layers._FLAT_FWD_ONLY_MAX_W); wider towers train
# through it past MHA_MAX_SEQ, and through the hybrid below.
SHORT_SEQ = 128
FLAT_FWD_ONLY_MAX_W = 768

Remat = Union[bool, str]
REMATS = (False, True, "mlp", "mlp_h1", "block")


def layer_norm(x: torch.Tensor, p: Mapping, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics, output cast back to x's dtype
    (``ops.attention.layer_norm_rows``: ``ln_rows`` forward, ``ln_bwd_rows``
    backward on the card)."""
    return layer_norm_rows(x, p["scale"], p["bias"], eps)


def sublayer_path(S: int, W: int, remat) -> str:
    """The attention path a block runs (the module doc): ``"attention_sublayer"``,
    ``"hybrid"``, ``"mha_core"`` or ``"flash_core"``."""
    if (S <= SHORT_SEQ or W <= FLAT_FWD_ONLY_MAX_W
            or (remat is not False and S > MHA_MAX_SEQ)):
        return "attention_sublayer"
    if remat is not False:
        return "hybrid"
    return "mha_core" if S <= MHA_MAX_SEQ else "flash_core"


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

    The attention half is ``ops.attention.attention_sublayer`` (K1 or the
    hybrid) or the composed sublayer over ``ops.mha`` (``sublayer_path``;
    CUDA kernels on the card); the MLP half is plain PyTorch around
    ``layer_norm_rows``, as it was plain XLA in the JAX package."""

    def __init__(self, width: int, heads: int, causal: bool = False, eps: float = 1e-5):
        super().__init__()
        self.heads, self.causal, self.eps = heads, causal, eps
        self.ln1 = ln_params(width)
        self.attn = nn.ModuleDict({"qkv": linear_params(width, 3 * width),
                                   "out": linear_params(width, width)})
        self.ln2 = ln_params(width)
        self.mlp = nn.ModuleDict({"fc1": linear_params(width, 4 * width),
                                  "fc2": linear_params(4 * width, width)})

    def mlp_half(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_half(x, self.ln2, self.mlp, self.eps)

    def composed_attention(self, x: torch.Tensor, core) -> torch.Tensor:
        """``x + linear(core(linear(LN1 x, qkv)), out)``: the JAX package's
        ``_jnp_attn_sublayer``, the projections in the compute dtype."""
        return composed_sublayer(x, self.ln1, self.attn, self.heads, self.causal, None,
                                 self.eps, x.shape[1], core)

    def quantized_forward(self, x: torch.Tensor, remat: Remat) -> torch.Tensor:
        """A W8A8 block: the composed sublayer over K3 or K5, then the MLP
        half, with no autograd."""
        if remat is not False:
            raise ValueError(f"remat={remat!r}: a W8A8-quantized block is inference-only "
                             "and runs with remat=False")
        if torch.is_grad_enabled() and (x.requires_grad or any(
                p.requires_grad for p in self.parameters())):
            raise RuntimeError("a W8A8-quantized block is inference-only: call it under "
                               "torch.no_grad() or torch.inference_mode(), with no input "
                               "or parameter that requires grad")
        core = mha_core if x.shape[1] <= MHA_MAX_SEQ else flash_core
        return self.mlp_half(self.composed_attention(x, core))

    def forward(self, x: torch.Tensor, remat: Remat = False) -> torch.Tensor:
        if "kernel" not in self.attn["qkv"]:  # W8A8 linears (ops.quant)
            return self.quantized_forward(x, remat)
        if remat == "block":
            return block_flat(x, {"ln1": self.ln1, "attn": self.attn, "ln2": self.ln2,
                                  "mlp": self.mlp}, self.heads, self.causal, self.eps)
        path = sublayer_path(x.shape[1], x.shape[2], remat)
        if path in ("attention_sublayer", "hybrid"):
            x = attention_sublayer(x, self.ln1, self.attn, self.heads, self.causal,
                                   eps=self.eps, hybrid=path == "hybrid")
        else:
            x = self.composed_attention(x, mha_core if path == "mha_core" else flash_core)
        if remat == "mlp":
            return checkpoint(self.mlp_half, x, use_reentrant=False)
        if remat == "mlp_h1":
            return mlp_half_h1(x, self.ln2, self.mlp, self.eps)
        return self.mlp_half(x)

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

    def forward(self, x: torch.Tensor, remat: Remat = False) -> torch.Tensor:
        """``remat``: one of ``REMATS`` (see the module doc)."""
        if remat not in REMATS:
            raise ValueError(f"remat={remat!r}: the port takes one of {REMATS}")
        for block in self:
            if remat is True:
                x = checkpoint(block, x, True, use_reentrant=False)
            else:
                x = block(x, remat)
        return x

    def init_params(self, generator: torch.Generator) -> None:
        for block in self:
            block.init_params(generator, len(self))


def _normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Fill ``t`` with N(0, std^2) drawn on the CPU from ``generator``, so the
    same seed gives the same weights on every device."""
    t.copy_(torch.randn(t.shape, generator=generator) * std)
