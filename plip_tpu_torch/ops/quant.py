"""W8A8 inference quantization of the transformer blocks' linears: the port
of ``plip_tpu.ops.quant``.

- ``quantize_linear``: ``{kernel [..., in, out], bias?}`` ->
  ``{kernel_q int8, wscale, bias?}``, a symmetric scale per output channel
  over the input axis (``max|w| / 127``, floored at 1e-12), a leading
  layer-stack axis kept.
- ``quantize_block_linears``: that, applied in place to every linear of a
  block stack (a ``models.layers.Transformer``).
- ``linear_w8a8``: x in fp32, a dynamic scale per row (``max|x| / 127``,
  floored at 1e-8), ``round(x / scale)`` as int8, an int8 x int8 -> int32
  product, then ``acc * ascale * wscale + bias`` in fp32, cast back to x's
  dtype. ``torch.round`` rounds half to even, as ``jnp.round`` does.

Inference only: a quantized block has no ``kernel`` leaf, so
``models.layers.Block`` routes it to the composed sublayer over ``mha_core``
(K3) or ``flash_core`` (K5) at every S, never K1's fused sublayer, and
refuses autograd and every ``remat`` but False. ``ops.attention.linear``
dispatches here on ``kernel_q``.

The int8 product was XLA's ``dot_general`` with int32 accumulation in the
JAX package, not a Pallas kernel; here it is ``torch._int_mm`` (CUDA: more
than 16 rows, K and N multiples of 8; ``ops.retrieval.int8_operand`` and
``int8_dot`` pad to them). ``kernel_q`` is stored column-major (its
transpose contiguous), the layout of the product's second operand there.
The int32 sums are exact, so the integers match the JAX package's.
``LAUNCHES["int8_mm"]`` counts the products run on the card.

Under tensor parallelism (``parallel.mesh``; a ``TPGroup`` ``tp``) a
row-parallel linear (``out``, ``fc2``: this rank's input rows) takes every
max over its input axis over the whole width: the weights' per-channel max
(``quantize_linear``, after sharding, as the JAX package quantizes its
sharded tree) and the activations' per-row max (``linear_w8a8``) are
all-reduced with MAX, and the int32 sums are all-reduced before the one
dequantize, so a tp tower's integers equal the meshless ones.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from .retrieval import int8_dot, int8_operand

LAUNCHES = {"int8_mm": 0}


def _per_127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` correctly rounded on every device, as ``jnp``'s divide.
    A Python scalar divisor takes a reciprocal multiply on CUDA
    (``a * (1 / 127)``), which is one ulp off now and then; a 0-dim tensor
    on t's device divides."""
    return t / t.new_full((), 127.0)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def quantize_linear(p: Mapping, tp=None) -> dict:
    """``{kernel, bias?}`` -> ``{kernel_q, wscale, bias?}`` (tensors; the
    scales fp32 ``[..., 1, out]``). ``tp``: ``kernel`` is this rank's input
    rows of a row-parallel linear; the max is over all ranks' rows."""
    w = p["kernel"].detach().float()
    amax = w.abs().amax(dim=-2, keepdim=True)
    if tp is not None:
        tp.all_reduce_max_(amax)
    wscale = _per_127(amax).clamp_min(1e-12)
    out = {"kernel_q": torch.round(w / wscale).to(torch.int8).mT.contiguous().mT,
           "wscale": wscale}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


# the row-parallel linears of a block under tensor parallelism
ROW_PARALLEL = ("attn.out", "mlp.fc2")


def quantize_block_linears(blocks: nn.Module, tp=None) -> nn.Module:
    """Quantize, in place, every linear (a ``ParameterDict`` with a
    ``kernel [..., in, out]``) of a block stack (``Transformer``, ``Block``):
    it trades ``kernel`` for frozen ``kernel_q`` and ``wscale`` parameters
    (its bias frozen too), so they move with ``.to(device)`` and appear in
    ``state_dict``. ``tp``: the blocks are sharded (``parallel.mesh``); the
    row-parallel linears' scales take the max over the group. Returns
    ``blocks``."""
    for name, mod in blocks.named_modules():
        if (isinstance(mod, nn.ParameterDict) and "kernel" in mod
                and mod["kernel"].dim() >= 2):
            q = quantize_linear(mod, tp if name.endswith(ROW_PARALLEL) else None)
            del mod["kernel"]
            for k in ("kernel_q", "wscale"):
                mod[k] = nn.Parameter(q[k], requires_grad=False)
            if "bias" in mod:
                mod["bias"].requires_grad_(False)
    return blocks


def quantize_activations(x: torch.Tensor, tp=None):
    """(int8 ``round(x / ascale)``, fp32 ``ascale [..., 1]``) of x's rows, x
    taken to fp32 inside the ops (|x|, its max and the cast are exact in
    x's dtype; the divide promotes to fp32). ``tp``: x is this rank's
    columns; the row max is over all ranks' (an all-reduce MAX)."""
    amax = x.abs().amax(dim=-1, keepdim=True).float()
    if tp is not None:
        tp.all_reduce_max_(amax)
    ascale = _per_127(amax).clamp_min(1e-8)
    return torch.round(x / ascale).to(torch.int8), ascale


def int8_mm(xq: torch.Tensor, kernel_q: torch.Tensor) -> torch.Tensor:
    """``xq [M, K] @ kernel_q [K, N]`` of int8s in exact int32 sums."""
    a = int8_operand(xq)
    out = int8_dot(a, kernel_q.mT)
    if a.is_cuda:
        LAUNCHES["int8_mm"] += 1
    return out[:xq.shape[0]]


def w8a8_accumulate(x: torch.Tensor, p: Mapping, tp=None):
    """(int32 ``acc [M, N]``, fp32 ``ascale [..., 1]``): the quantized rows of
    x ``[..., K]`` against ``kernel_q``. ``tp``: a row-parallel linear (x and
    ``kernel_q`` this rank's share of K): the scale's max and the int32 sums
    over the group."""
    kq = p["kernel_q"]
    if kq.dim() != 2:
        raise ValueError(f"linear_w8a8 takes one layer's kernel_q, got shape {tuple(kq.shape)}")
    xq, ascale = quantize_activations(x, tp)
    acc = int8_mm(xq.reshape(-1, kq.shape[0]), kq)
    if tp is not None:
        acc = tp.all_reduce_(acc.contiguous())
    return acc, ascale


def linear_w8a8(x: torch.Tensor, p: Mapping, tp=None) -> torch.Tensor:
    """The W8A8 linear of ``p`` (``quantize_linear``'s keys) on x ``[..., K]``,
    in x's dtype; ``tp``: row-parallel (``w8a8_accumulate``)."""
    kq = p["kernel_q"]
    acc, ascale = w8a8_accumulate(x, p, tp)
    # fp32 (acc * ascale) * wscale (+ bias), the JAX package's order; the
    # int32 -> fp32 cast happens inside the first product
    y = (acc.reshape(*x.shape[:-1], kq.shape[1]) * ascale).mul_(p["wscale"].reshape(-1))
    if "bias" in p:
        y.add_(p["bias"])
    return y.to(x.dtype)
