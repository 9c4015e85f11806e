"""Attention sublayer of the CLIP towers: ``x + attn(LN1 x) . Wout + bout``.

The port of ``plip_tpu.ops.attention._attn_sublayer_kernel`` (K1), the one
TPU kernel on the inference path of both towers. On a CUDA tensor it runs
three hand-written kernels (``csrc/attention_sublayer.cu``):

- ``ln_rows``: LayerNorm over token rows, fp32 statistics;
- ``gemm_bias_residual``: the QKV and out-projection products, fp32
  accumulation, fp32 bias, optional residual;
- ``attn_core``: per (sequence, head) masked softmax attention, S <= 128.

Each has its plain PyTorch version beside it (``*_reference``). A wrapper
takes the plain version only for a tensor on the CPU; for a CUDA tensor it
launches its kernel or raises. ``LAUNCHES`` counts the kernel launches per
kernel, so a run can show that it went through them.

Numerics follow the TPU kernel, not the composed JAX path: the logits are
scaled by ``D**-0.5`` after the q.k dot, in fp32; the softmax normalizes
before the P.v dot; P is cast to the compute dtype before that dot; the
projections add their fp32 bias to the fp32 accumulator before the cast; the
residual is added in the compute dtype.

Layouts are the JAX package's: ``x`` is ``[B, S, W]`` or flat ``[B*S, W]``;
weights are ``[in, out]``; the qkv columns are ``[q heads | k heads | v
heads]`` with each head's ``D`` columns contiguous.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Mapping, Optional

import torch

from . import _build

# Longest sequence and widest head attn_core takes (four logits per lane of
# a warp; one head's k and v in shared memory).
MAX_SEQ = 128
MAX_HEAD_DIM = 128

LAUNCHES = {"ln_rows": 0, "gemm_bias_residual": 0, "attn_core": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_vp, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, scale, bias, out, rows, width, eps, dtype, device, stream
    "plip_ln_rows": (_vp, _vp, _vp, _vp, _int, _int, _float, _int, _int, _vp),
    # a, w, bias, residual, out, M, N, K, dtype, device, stream
    "plip_gemm_bias_residual": (_vp, _vp, _vp, _vp, _vp, _int, _int, _int,
                                _int, _int, _vp),
    # qkv, ctx, B, S, heads, head_dim, causal, s_valid, dtype, device, stream
    "plip_attn_core": (_vp, _vp, _int, _int, _int, _int, _int, _int, _int,
                       _int, _vp),
}
_kernels = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _kernels
    if _kernels is None:
        lib = _build.load()
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _kernels = lib
    return _kernels


def _on_cpu(t: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (plain path); False for CUDA; raises otherwise."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return False


def _check(name: str, t: torch.Tensor, device, dtype, shape, align16=False):
    if t.device != device:
        raise ValueError(f"{name}: tensor on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if align16 and t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _dtype_code(name: str, t: torch.Tensor) -> int:
    if t.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: no kernel for dtype {t.dtype}")
    return _DTYPE_CODES[t.dtype]


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error {rc}")
    LAUNCHES[name] += 1


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# ---------------------------------------------------------------------------
# ln_rows
# ---------------------------------------------------------------------------


def layer_norm_rows_reference(x: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics, cast back to x's dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(x.dtype)


def ln_rows(x2: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of each row of ``x2 [N, W]``; ``scale``/``bias`` fp32 ``[W]``."""
    if _on_cpu(x2, "ln_rows"):
        return layer_norm_rows_reference(x2, scale, bias, eps)
    code = _dtype_code("ln_rows", x2)
    rows, width = x2.shape
    _check("ln_rows x", x2, x2.device, x2.dtype, (rows, width))
    _check("ln_rows scale", scale, x2.device, torch.float32, (width,))
    _check("ln_rows bias", bias, x2.device, torch.float32, (width,))
    out = torch.empty_like(x2)
    _launch("ln_rows", _lib().plip_ln_rows, x2.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), out.data_ptr(), rows, width, eps, code,
            x2.device.index, _stream(x2.device))
    return out


# ---------------------------------------------------------------------------
# gemm_bias_residual
# ---------------------------------------------------------------------------


def gemm_bias_residual_reference(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``cast(a . w + bias) [+ residual]``: the product of the compute-dtype
    operands is summed in fp32 (exact products, fp32 accumulation) and the
    fp32 bias added before the one cast; the residual is added after it."""
    y = torch.addmm(bias.float(), a.float(), w.float()).to(a.dtype)
    return y if residual is None else residual + y


def gemm_bias_residual(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``a [M, K] . w [K, N] + bias [N]`` (+ ``residual [M, N]``) in a's dtype.

    ``w`` has a's dtype, ``bias`` is fp32. In bf16, K and N must be multiples
    of 8 (the kernel loads 16-byte chunks)."""
    if _on_cpu(a, "gemm_bias_residual"):
        return gemm_bias_residual_reference(a, w, bias, residual)
    code = _dtype_code("gemm_bias_residual", a)
    M, K = a.shape
    N = w.shape[-1]
    bf = a.dtype == torch.bfloat16
    if bf and (K % 8 or N % 8):
        raise ValueError(f"gemm_bias_residual: bf16 needs K % 8 == 0 and "
                         f"N % 8 == 0, got K={K}, N={N}")
    _check("gemm_bias_residual a", a, a.device, a.dtype, (M, K), align16=bf)
    _check("gemm_bias_residual w", w, a.device, a.dtype, (K, N), align16=bf)
    _check("gemm_bias_residual bias", bias, a.device, torch.float32, (N,))
    if residual is not None:
        _check("gemm_bias_residual residual", residual, a.device, a.dtype, (M, N))
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    _launch("gemm_bias_residual", _lib().plip_gemm_bias_residual, a.data_ptr(),
            w.data_ptr(), bias.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            M, N, K, code, a.device.index, _stream(a.device))
    return out


# ---------------------------------------------------------------------------
# attn_core
# ---------------------------------------------------------------------------


def attn_core_reference(qkv2: torch.Tensor, S: int, heads: int, causal: bool = False,
                        s_valid: Optional[int] = None) -> torch.Tensor:
    """``[B*S, 3W]`` qkv -> ``[B*S, W]`` context, in qkv's dtype."""
    N, W3 = qkv2.shape
    W = W3 // 3
    D = W // heads
    B = N // S
    q, k, v = qkv2.view(B, S, 3, heads, D).permute(2, 0, 3, 1, 4).unbind(0)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * D ** -0.5
    keep = torch.ones(S, S, dtype=torch.bool, device=qkv2.device)
    if causal:
        keep = keep.tril()
    if s_valid is not None and s_valid < S:
        keep[:, s_valid:] = False
    logits = logits.masked_fill(~keep, float("-inf"))
    p = torch.softmax(logits, dim=-1).to(qkv2.dtype)
    ctx = torch.matmul(p.float(), v.float()).to(qkv2.dtype)  # [B, H, S, D]
    return ctx.transpose(1, 2).reshape(N, W)


def attn_core(qkv2: torch.Tensor, S: int, heads: int, causal: bool = False,
              s_valid: Optional[int] = None) -> torch.Tensor:
    """Masked multi-head attention of ``qkv2 [B*S, 3W]`` -> ``[B*S, W]``.

    ``s_valid``: columns at or past it (within each sequence) are padding and
    get no attention."""
    if _on_cpu(qkv2, "attn_core"):
        return attn_core_reference(qkv2, S, heads, causal, s_valid)
    code = _dtype_code("attn_core", qkv2)
    N, W3 = qkv2.shape
    W = W3 // 3
    _check_geometry(N, S, W, heads, s_valid)
    _check("attn_core qkv", qkv2, qkv2.device, qkv2.dtype, (N, 3 * W))
    ctx = torch.empty((N, W), dtype=qkv2.dtype, device=qkv2.device)
    _launch("attn_core", _lib().plip_attn_core, qkv2.data_ptr(), ctx.data_ptr(),
            N // S, S, heads, W // heads, int(causal),
            S if s_valid is None else s_valid, code, qkv2.device.index,
            _stream(qkv2.device))
    return ctx


def _check_geometry(N: int, S: int, W: int, heads: int, s_valid: Optional[int]):
    if S < 1 or N % S:
        raise ValueError(f"{N} token rows do not split into sequences of {S}")
    if S > MAX_SEQ:
        raise ValueError(f"attn_core takes S <= {MAX_SEQ}, got S={S}")
    if W % heads or W // heads > MAX_HEAD_DIM:
        raise ValueError(f"width {W} with {heads} heads: head_dim must divide "
                         f"the width and be <= {MAX_HEAD_DIM}")
    if s_valid is not None and not 1 <= s_valid <= S:
        raise ValueError(f"s_valid={s_valid} outside [1, {S}]")


# ---------------------------------------------------------------------------
# The sublayer
# ---------------------------------------------------------------------------


def _sublayer(x, ln, attn, heads, causal, s_valid, eps, S,
              ln_fn: Callable, gemm_fn: Callable, core_fn: Callable):
    if x.dim() == 3:
        _, S, W = x.shape
    elif S is None:
        raise ValueError("flat [N, W] input needs the sequence length S")
    else:
        W = x.shape[1]
    x2 = x.reshape(-1, W)
    dt = x.dtype
    h = ln_fn(x2, ln["scale"], ln["bias"], eps)
    qkv = gemm_fn(h, attn["qkv"]["kernel"].to(dt), attn["qkv"]["bias"])
    ctx = core_fn(qkv, S, heads, causal, s_valid)
    out = gemm_fn(ctx, attn["out"]["kernel"].to(dt), attn["out"]["bias"], x2)
    return out.reshape(x.shape)


def attention_sublayer(x: torch.Tensor, ln: Mapping, attn: Mapping, heads: int,
                       causal: bool = False, s_valid: Optional[int] = None,
                       eps: float = 1e-5, S: Optional[int] = None) -> torch.Tensor:
    """``x + out_proj(attention(qkv_proj(LN(x))))`` through the CUDA kernels.

    ``x``: ``[B, S, W]``, or ``[B*S, W]`` with ``S`` given, in fp32 or bf16.
    ``ln``: ``{"scale", "bias"}`` fp32 ``[W]``. ``attn``: ``{"qkv": {"kernel"
    [W, 3W], "bias" [3W]}, "out": {"kernel" [W, W], "bias" [W]}}``, fp32
    (the kernels are cast to x's dtype here). On the CPU it is
    ``attention_sublayer_reference``."""
    return _sublayer(x, ln, attn, heads, causal, s_valid, eps, S,
                     ln_rows, gemm_bias_residual, attn_core)


def attention_sublayer_reference(x: torch.Tensor, ln: Mapping, attn: Mapping,
                                 heads: int, causal: bool = False,
                                 s_valid: Optional[int] = None, eps: float = 1e-5,
                                 S: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version of ``attention_sublayer``, on any device."""
    return _sublayer(x, ln, attn, heads, causal, s_valid, eps, S,
                     layer_norm_rows_reference, gemm_bias_residual_reference,
                     attn_core_reference)
