"""Attention core of the composed towers: qkv ``[B, S, 3W]`` -> ctx ``[B, S, W]``.

The port of the two TPU kernels that ``plip_tpu.ops.attention.fused_attention``
dispatches by S. The composed sublayer takes them where a tower is too wide
for K1's flat sublayer when serving (ViT-L/14 and L/14@336 vision):

- ``mha_core``: K3, ``_mha_kernel``. S <= ``MAX_SEQ`` (512), causal and
  ``s_valid`` masks, the softmax normalized before the P.v dot up to
  ``DEFER_ABOVE`` tokens and the divide deferred past it above.
- ``flash_core``: K5, ``_flash_kernel`` at its shipped ``pipeline=True``. Any
  S (the towers take it above 512), deferred divide, causal order by global
  row, no ``s_valid``. The TPU's q blocks of 256 rows and its head groups
  (``hpp``) were there for its 128 lanes; here a block is one (sequence,
  head, 64-row q tile), so every head is its own block and none is skipped.

On a CUDA tensor both launch ``csrc/mha.cu``; on the CPU each is its plain
PyTorch version (``*_reference``). ``LAUNCHES`` counts the kernel launches.

Numerics are the TPU kernels' and differ from K1's in one place: q is scaled
by ``D**-0.5`` in fp32 and cast to the compute dtype *before* the q.k dot
(K1 scales the fp32 logits after it). Logits and softmax are fp32; P is cast
to the compute dtype for the P.v dot, which sums in fp32.

Autograd: on the CPU the plain version is differentiable as it stands. On
the card the kernels run under ``AttentionCoreFn``, whose backward raises
``NotImplementedError``: K3's backward (K4) and a flash backward are not
ported yet, and a silent missing grad is what the port must never give.

``qkv`` is ``[B, S, 3W]`` or flat ``[B*S, 3W]`` with the JAX package's
column layout ``[q heads | k heads | v heads]``; the context has qkv's rank.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .attention import (DEFER_ABOVE, _check, _check_geometry, _dtype_code, _on_cpu,
                        _stream, keep_mask, softmax_pv_reference)

# mha_core's longest sequence (the TPU dispatch boundary _PERROW_MAX_S).
MAX_SEQ = 512
# The one head width the kernel is built for: every tower of the config has it.
HEAD_DIM = 64

LAUNCHES = {"mha_core": 0, "flash_core": 0}

_NO_BACKWARD = {
    "mha_core": "mha_core has no backward on the card: its TPU backward, K4 "
                "(plip_tpu/ops/attention.py:125 _mha_bwd_kernel), is not ported yet "
                "(ROADMAP.md Queue 2 item 4, slice 4)",
    "flash_core": "flash_core has no backward on the card: the JAX package "
                  "differentiates S > 512 through the composed VJP, and a flash "
                  "backward kernel is not ported yet (ROADMAP.md Queue 2 item 5, "
                  "slice 4)",
}

_vp, _int = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # qkv, ctx, B, S, heads, head_dim, causal, s_valid, dtype, device, stream
    "plip_mha_core": (_vp, _vp, _int, _int, _int, _int, _int, _int, _int, _int, _vp),
    # qkv, ctx, B, S, heads, head_dim, causal, dtype, device, stream
    "plip_flash_core": (_vp, _vp, _int, _int, _int, _int, _int, _int, _int, _vp),
}
_kernels = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _kernels
    if _kernels is None:
        _kernels = _build.bind(_SIGNATURES)
    return _kernels


def _core_reference(qkv, S, heads, causal, s_valid, defer):
    W = qkv.shape[-1] // 3
    D = W // heads
    dt = qkv.dtype
    q, k, v = qkv.reshape(-1, S, 3, heads, D).permute(2, 0, 3, 1, 4).unbind(0)
    q = (q.float() * D ** -0.5).to(dt)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits.masked_fill(~keep_mask(S, causal, s_valid, qkv.device), float("-inf"))
    ctx = softmax_pv_reference(logits, v, dt, defer)  # [B, H, S, D]
    return ctx.transpose(1, 2).reshape(*qkv.shape[:-1], W)


def mha_core_reference(qkv: torch.Tensor, S: int, heads: int, causal: bool = False,
                       s_valid: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version of ``mha_core``, on any device."""
    return _core_reference(qkv, S, heads, causal, s_valid, S > DEFER_ABOVE)


def flash_core_reference(qkv: torch.Tensor, S: int, heads: int,
                         causal: bool = False) -> torch.Tensor:
    """The plain PyTorch version of ``flash_core``, on any device."""
    return _core_reference(qkv, S, heads, causal, None, True)


def _launch_core(name: str, qkv: torch.Tensor, S: int, heads: int, causal: bool,
                 s_valid: Optional[int]) -> torch.Tensor:
    """Check the arguments, launch ``name``'s kernel, count it."""
    code = _dtype_code(name, qkv)
    W3 = qkv.shape[-1]
    if qkv.dim() not in (2, 3) or W3 % 3 or (qkv.dim() == 3 and qkv.shape[1] != S):
        raise ValueError(f"{name}: qkv of shape {tuple(qkv.shape)} is not [B, {S}, 3W] "
                         f"or [B*{S}, 3W]")
    N, W = qkv.numel() // W3, W3 // 3
    _check_geometry(N, S, W, heads, s_valid, MAX_SEQ if name == "mha_core" else S, name)
    D = W // heads
    if D != HEAD_DIM:
        raise ValueError(f"{name}: head_dim {D}; the kernel is built for {HEAD_DIM} only")
    _check(f"{name} qkv", qkv, qkv.device, qkv.dtype, qkv.shape)
    ctx = torch.empty((*qkv.shape[:-1], W), dtype=qkv.dtype, device=qkv.device)
    args = [qkv.data_ptr(), ctx.data_ptr(), N // S, S, heads, D, int(causal)]
    if name == "mha_core":
        args.append(S if s_valid is None else s_valid)
    fn = getattr(_lib(), f"plip_{name}")
    rc = fn(*args, code, qkv.device.index, _stream(qkv.device))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error {rc}")
    LAUNCHES[name] += 1
    return ctx


class AttentionCoreFn(torch.autograd.Function):
    """A core's kernel under autograd on the card. The backward raises: the
    kernels have none yet, and returning no grad would train silently wrong."""

    @staticmethod
    def forward(ctx, qkv, name, S, heads, causal, s_valid):
        ctx.name = name
        return _launch_core(name, qkv, S, heads, causal, s_valid)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(_NO_BACKWARD[ctx.name])


def mha_core(qkv: torch.Tensor, S: int, heads: int, causal: bool = False,
             s_valid: Optional[int] = None) -> torch.Tensor:
    """K3: masked multi-head attention of ``qkv`` (``[B, S, 3W]`` or ``[B*S,
    3W]``), S <= ``MAX_SEQ``. ``s_valid``: columns at or past it are padding
    and get no attention."""
    if _on_cpu(qkv, "mha_core"):
        return mha_core_reference(qkv, S, heads, causal, s_valid)
    return AttentionCoreFn.apply(qkv, "mha_core", S, heads, causal, s_valid)


def flash_core(qkv: torch.Tensor, S: int, heads: int, causal: bool = False) -> torch.Tensor:
    """K5: multi-head attention of ``qkv`` (``[B, S, 3W]`` or ``[B*S, 3W]``)
    at any S, the divide deferred past the P.v dot."""
    if _on_cpu(qkv, "flash_core"):
        return flash_core_reference(qkv, S, heads, causal)
    return AttentionCoreFn.apply(qkv, "flash_core", S, heads, causal, None)
