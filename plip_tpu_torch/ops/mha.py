"""Attention core of the composed towers: qkv ``[B, S, 3W]`` -> ctx ``[B, S, W]``.

The port of the TPU kernels that ``plip_tpu.ops.attention.fused_attention``
dispatches by S, and of its custom VJP. The composed sublayer takes them
where a tower is too wide for K1's flat sublayer (ViT-L/14 and L/14@336
vision serving and ``remat=False`` training; the hybrid training forward):

- ``mha_core``: K3, ``_mha_kernel``. S <= ``MAX_SEQ`` (512), causal and
  ``s_valid`` masks, the softmax normalized before the P.v dot up to
  ``DEFER_ABOVE`` tokens and the divide deferred past it above. Its backward
  is ``mha_core_bwd``: K4, ``_mha_bwd_kernel`` (``csrc/mha_bwd.cu``).
- ``flash_core``: K5, ``_flash_kernel`` at its shipped ``pipeline=True``. Any
  S (the towers take it above 512), deferred divide, causal order by global
  row, no ``s_valid``. The TPU's q blocks of 256 rows and its head groups
  (``hpp``) were there for its 128 lanes; here a block is one (sequence,
  head, 64-row q tile), so every head is its own block and none is skipped.
  Its backward is the JAX package's own above 512 tokens, which has no
  Pallas kernel: the VJP of ``_jnp_mha`` (``jnp_mha_reference``), run by
  autograd on the saved qkv (XLA there, PyTorch's own kernels here).
- ``headgrid_core``: K12, ``_headgrid_kernel``. Any S, K3's scale placement,
  the softmax normalized before the P.v dot at every S, no ``s_valid``: the
  forward of ``_jnp_mha`` (``jnp_mha_reference``). The TPU's head groups
  (``hpp``) were there for its 128 lanes and are not copied: every head is
  its own block. ``jnp_mha_core`` is it under autograd with ``_jnp_mha``'s
  VJP, the core of the JAX package's composed paths above 512 tokens where
  the sequence is padded (``s_valid`` set): the ``remat="block"`` fallback
  at ViT-L/14@336px (``ops.block_bwd.composed_block``).

On a CUDA tensor ``mha_core``, ``flash_core``, ``headgrid_core`` and
``mha_core_bwd`` launch ``csrc/mha.cu`` and ``csrc/mha_bwd.cu``; on the CPU
each is its plain PyTorch version (``*_reference``). ``LAUNCHES`` counts the
kernel launches.

Numerics are the TPU kernels'. K3 and K5 scale q by ``D**-0.5`` in fp32 and
cast it to the compute dtype *before* the q.k dot (K1 scales the fp32 logits
after it). Logits and softmax are fp32; P is cast to the compute dtype for
the P.v dot, which sums in fp32. K4 recomputes P with the logits scaled
*after* the dot and normalized first, so it is not the exact autograd of K3
in bf16, as on the TPU.

``qkv`` is ``[B, S, 3W]`` or flat ``[B*S, 3W]`` with the JAX package's
column layout ``[q heads | k heads | v heads]``; the context has qkv's rank.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .attention import (DEFER_ABOVE, TILED_HEAD_DIM, _check, _check_geometry, _dtype_code,
                        _on_cpu, _stream, keep_mask, softmax_pv_reference, tiled_plan,
                        wgmma_head)

# mha_core's longest sequence (the TPU dispatch boundary _PERROW_MAX_S).
MAX_SEQ = 512
# The head width of every tower of the config, the one bf16 runs on wgmma;
# the kernels take every head_dim (fp32, and bf16 at another head_dim, on
# the TF32 products, on the plan of attention.tiled_plan).
HEAD_DIM = TILED_HEAD_DIM

LAUNCHES = {"mha_core": 0, "flash_core": 0, "mha_core_bwd": 0, "headgrid_core": 0}

_vp, _int = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # qkv, ctx, B, S, heads, head_dim, causal, s_valid, win_tiles (attention.tiled_plan),
    # dtype, device, stream
    "plip_mha_core": (_vp, _vp, _int, _int, _int, _int, _int, _int, _int, _int, _int, _vp),
    # qkv, ctx, B, S, heads, head_dim, causal, win_tiles, dtype, device, stream
    "plip_flash_core": (_vp, _vp, _int, _int, _int, _int, _int, _int, _int, _int, _vp),
    "plip_headgrid_core": (_vp, _vp, _int, _int, _int, _int, _int, _int, _int, _int, _vp),
    # qkv, g, dqkv, stats, B, S, heads, head_dim, causal, s_valid, rows, win_tiles, dtype,
    # device, stream
    "plip_mha_core_bwd": (_vp, _vp, _vp, _vp, _int, _int, _int, _int, _int, _int, _int,
                          _int, _int, _int, _vp),
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


def _split(qkv, S, heads):
    """q, k, v ``[B, H, S, D]`` views of ``qkv``."""
    D = qkv.shape[-1] // 3 // heads
    return qkv.reshape(-1, S, 3, heads, D).permute(2, 0, 3, 1, 4).unbind(0)


def _merge(t, like):
    """``[B, H, S, D]`` -> ``like``'s leading shape with the heads' columns."""
    return t.transpose(1, 2).reshape(*like.shape[:-1], t.shape[1] * t.shape[-1])


def _core_reference(qkv, S, heads, causal, s_valid, defer):
    dt = qkv.dtype
    q, k, v = _split(qkv, S, heads)
    q = (q.float() * q.shape[-1] ** -0.5).to(dt)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits.masked_fill(~keep_mask(S, causal, s_valid, qkv.device), float("-inf"))
    return _merge(softmax_pv_reference(logits, v, dt, defer), qkv)


def mha_core_reference(qkv: torch.Tensor, S: int, heads: int, causal: bool = False,
                       s_valid: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version of ``mha_core``, on any device."""
    return _core_reference(qkv, S, heads, causal, s_valid, S > DEFER_ABOVE)


def flash_core_reference(qkv: torch.Tensor, S: int, heads: int,
                         causal: bool = False) -> torch.Tensor:
    """The plain PyTorch version of ``flash_core``, on any device."""
    return _core_reference(qkv, S, heads, causal, None, True)


def headgrid_core_reference(qkv: torch.Tensor, S: int, heads: int,
                            causal: bool = False) -> torch.Tensor:
    """The plain PyTorch version of ``headgrid_core``, on any device."""
    return _core_reference(qkv, S, heads, causal, None, False)


def jnp_mha_reference(qkv: torch.Tensor, S: int, heads: int,
                      causal: bool = False) -> torch.Tensor:
    """The port of the JAX package's ``_jnp_mha`` (the XLA formulation): q *
    D**-0.5 in the compute dtype, fp32 logits, normalize-first softmax, P cast,
    P.v summed in fp32. Its autograd is ``flash_core``'s backward."""
    dt = qkv.dtype
    q, k, v = _split(qkv, S, heads)
    logits = torch.matmul((q * q.shape[-1] ** -0.5).float(), k.float().transpose(-1, -2))
    logits = logits.masked_fill(~keep_mask(S, causal, None, qkv.device), float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(dt)
    return _merge(torch.matmul(probs.float(), v.float()).to(dt), qkv)


def mha_core_bwd_reference(qkv: torch.Tensor, g: torch.Tensor, S: int, heads: int,
                           causal: bool = False,
                           s_valid: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version of ``mha_core_bwd``: K4's dqkv from ``qkv``
    and the context's grad ``g``, in qkv's dtype and shape."""
    dt = qkv.dtype
    q, k, v = (t.float() for t in _split(qkv, S, heads))
    D = q.shape[-1]
    scale = D ** -0.5
    gh = g.reshape(-1, S, heads, D).transpose(1, 2).float()  # [B, H, S, D]
    logits = (q @ k.transpose(-1, -2) * scale).masked_fill(
        ~keep_mask(S, causal, s_valid, qkv.device), float("-inf"))
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)  # fp32, normalized first
    dv = (p.to(dt).float().transpose(-1, -2) @ gh).to(dt)
    dp = gh @ v.transpose(-1, -2)
    dsum = (dp * p).sum(-1, keepdim=True)
    ds = (p * (dp - dsum)).to(dt).float()
    dq = (ds @ k * scale).to(dt)
    dk = (ds.transpose(-1, -2) @ q * scale).to(dt)
    dqkv = torch.stack([dq, dk, dv], 2)  # [B, H, 3, S, D]
    return dqkv.permute(0, 3, 2, 1, 4).reshape(qkv.shape)


def _check_core(name: str, qkv: torch.Tensor, S: int, heads: int,
                s_valid: Optional[int]) -> int:
    """Check what ``name``'s kernel takes; return the token rows."""
    W3 = qkv.shape[-1]
    if qkv.dim() not in (2, 3) or W3 % 3 or (qkv.dim() == 3 and qkv.shape[1] != S):
        raise ValueError(f"{name}: qkv of shape {tuple(qkv.shape)} is not [B, {S}, 3W] "
                         f"or [B*{S}, 3W]")
    N, W = qkv.numel() // W3, W3 // 3
    _check_geometry(N, S, W, heads, s_valid,
                    MAX_SEQ if name in ("mha_core", "mha_core_bwd") else S, name)
    _check(f"{name} qkv", qkv, qkv.device, qkv.dtype, qkv.shape,
           align16=wgmma_head(qkv.dtype, W // heads))
    return N


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error {rc}")
    LAUNCHES[name] += 1


def _launch_core(name: str, qkv: torch.Tensor, S: int, heads: int, causal: bool,
                 s_valid: Optional[int]) -> torch.Tensor:
    """Check the arguments, launch ``name``'s forward kernel, count it."""
    code = _dtype_code(name, qkv)
    N = _check_core(name, qkv, S, heads, s_valid)
    W = qkv.shape[-1] // 3
    ctx = torch.empty((*qkv.shape[:-1], W), dtype=qkv.dtype, device=qkv.device)
    args = [qkv.data_ptr(), ctx.data_ptr(), N // S, S, heads, W // heads, int(causal)]
    if name == "mha_core":
        args.append(S if s_valid is None else s_valid)
    _launch(name, getattr(_lib(), f"plip_{name}"), *args, tiled_plan(S, W // heads)[1], code,
            qkv.device.index, _stream(qkv.device))
    return ctx


def mha_core_bwd(qkv: torch.Tensor, g: torch.Tensor, S: int, heads: int,
                 causal: bool = False, s_valid: Optional[int] = None) -> torch.Tensor:
    """K4: dqkv of ``mha_core`` from ``qkv`` and the context's grad ``g``
    (qkv's dtype, ``[.., W]``), P recomputed; S <= ``MAX_SEQ``."""
    if _on_cpu(qkv, "mha_core_bwd"):
        return mha_core_bwd_reference(qkv, g, S, heads, causal, s_valid)
    code = _dtype_code("mha_core_bwd", qkv)
    N = _check_core("mha_core_bwd", qkv, S, heads, s_valid)
    W = qkv.shape[-1] // 3
    _check("mha_core_bwd g", g, qkv.device, qkv.dtype, (*qkv.shape[:-1], W),
           align16=wgmma_head(qkv.dtype, W // heads))
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((3, N // S, heads, S), dtype=torch.float32, device=qkv.device)
    _launch("mha_core_bwd", _lib().plip_mha_core_bwd, qkv.data_ptr(), g.data_ptr(),
            dqkv.data_ptr(), stats.data_ptr(), N // S, S, heads, W // heads, int(causal),
            S if s_valid is None else s_valid, *tiled_plan(S, W // heads, backward=True), code,
            qkv.device.index, _stream(qkv.device))
    return dqkv


def headgrid_core(qkv: torch.Tensor, S: int, heads: int, causal: bool = False) -> torch.Tensor:
    """K12: multi-head attention of ``qkv`` (``[B, S, 3W]`` or ``[B*S, 3W]``)
    at any S, normalize-first, every head written. Not differentiable (the
    JAX package's ``_pallas_mha_headgrid`` is not); ``jnp_mha_core`` is."""
    if _on_cpu(qkv, "headgrid_core"):
        return headgrid_core_reference(qkv, S, heads, causal)
    return _launch_core("headgrid_core", qkv, S, heads, causal, None)


class AttentionCoreFn(torch.autograd.Function):
    """A core under autograd, as ``fused_attention``'s custom VJP makes it: the
    forward saves only qkv. ``mha_core``'s backward is K4 (``mha_core_bwd``);
    ``flash_core``'s and ``"jnp_mha"``'s are the JAX package's own path above
    512 tokens, the VJP of ``_jnp_mha`` recomputed from qkv
    (``attention.py:_bwd``): no hand-written kernel, since the reference has
    no Pallas kernel there. ``"jnp_mha"``'s forward is ``headgrid_core``."""

    @staticmethod
    def forward(ctx, qkv, name, S, heads, causal, s_valid):
        ctx.save_for_backward(qkv)
        ctx.geometry = (name, S, heads, causal, s_valid)
        if name == "jnp_mha":
            if _on_cpu(qkv, name):
                return jnp_mha_reference(qkv, S, heads, causal)
            return headgrid_core(qkv, S, heads, causal)
        if _on_cpu(qkv, name):
            return (mha_core_reference(qkv, S, heads, causal, s_valid) if name == "mha_core"
                    else flash_core_reference(qkv, S, heads, causal))
        return _launch_core(name, qkv, S, heads, causal, s_valid)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        name, S, heads, causal, s_valid = ctx.geometry
        if name == "mha_core":
            dqkv = mha_core_bwd(qkv, g.contiguous(), S, heads, causal, s_valid)
        else:
            with torch.enable_grad():
                leaf = qkv.detach().requires_grad_()
                (dqkv,) = torch.autograd.grad(jnp_mha_reference(leaf, S, heads, causal),
                                              leaf, g)
        return dqkv, None, None, None, None, None


def mha_core(qkv: torch.Tensor, S: int, heads: int, causal: bool = False,
             s_valid: Optional[int] = None) -> torch.Tensor:
    """K3: masked multi-head attention of ``qkv`` (``[B, S, 3W]`` or ``[B*S,
    3W]``), S <= ``MAX_SEQ``. ``s_valid``: columns at or past it are padding
    and get no attention. Differentiable: the backward is K4."""
    return AttentionCoreFn.apply(qkv, "mha_core", S, heads, causal, s_valid)


def flash_core(qkv: torch.Tensor, S: int, heads: int, causal: bool = False) -> torch.Tensor:
    """K5: multi-head attention of ``qkv`` (``[B, S, 3W]`` or ``[B*S, 3W]``)
    at any S, the divide deferred past the P.v dot. Differentiable: the
    backward is the VJP of ``jnp_mha_reference``."""
    return AttentionCoreFn.apply(qkv, "flash_core", S, heads, causal, None)


def jnp_mha_core(qkv: torch.Tensor, S: int, heads: int, causal: bool = False) -> torch.Tensor:
    """``_jnp_mha`` at any S (``[B, S, 3W]`` or ``[B*S, 3W]``): the forward is
    K12 (``headgrid_core``), the backward the VJP of ``jnp_mha_reference``."""
    return AttentionCoreFn.apply(qkv, "jnp_mha", S, heads, causal, None)
