"""Attention sublayer of the CLIP towers: ``x + attn(LN1 x) . Wout + bout``.

The port of ``plip_tpu.ops.attention._attn_sublayer_kernel`` (K1), the one
TPU kernel on the inference path of both towers. On a CUDA tensor it runs
three hand-written kernels (``csrc/attention_sublayer.cu``):

- ``ln_rows``: LayerNorm over token rows, fp32 statistics, a row in the
  registers of one warp (a few at the widest rows) on the layout of
  ``ln_layout``; it is also every other LayerNorm of the towers
  (``layer_norm_rows``, whose backward is K2's ``ln_bwd_rows``);
- ``gemm_bias_residual``: the QKV and out-projection products, fp32
  accumulation, fp32 bias, optional residual;
- ``attn_core``: masked softmax attention, S <= ``MAX_SEQ``, on the route
  ``core_route`` picks: in bf16 at head_dim 64 the head on chip up to
  ``BF16_ROW_MAX_SEQ`` tokens (one q.k^T a 64-row q tile on ``wgmma``); in
  fp32, and in bf16 at another head_dim, up to ``ROW_MAX_SEQ`` tokens the
  one-block core on CUDA cores (64 query rows a block, the head's k and v
  in shared memory, both dots register-tiled; head_dim a multiple of 4 up
  to ``ONE_BLOCK_MAX_HEAD_DIM``); past those, and at every wider head, the
  key-tiled kernel of ``csrc/mha.cu`` with K1's scale placement (bf16 at
  head_dim 64 on ``wgmma``; fp32, and bf16 at every other head_dim, on the
  tensor cores' TF32 products of ``csrc/tf32_attn.cuh``, the logits of a
  block's query rows computed once into shared memory on the plan of
  ``tiled_plan``). Every route takes either softmax schedule (``defer``;
  the normalize-first context that ``ops.block_bwd`` recomputes at any S).

fp32 is the dtype ``PLIP`` and ``CLIPTuner`` take when the caller names
none, so the fp32 kernels (the one-block core, and ``gemm_bias_residual`` on
``csrc/simt_gemm.cuh``, 8 x 8 register micro-tiles on the block tile that
``simt_gemm_plan`` picks) carry the default path.

Each has its plain PyTorch version beside it (``*_reference``). A wrapper
takes the plain version only for a tensor on the CPU; for a CUDA tensor it
launches its kernel or raises. ``LAUNCHES`` counts the kernel launches per
kernel, so a run can show that it went through them.

``attention_sublayer`` is differentiable through ``AttentionSublayerFn``,
as the JAX package's custom VJP makes it: the forward saves only its input
and parameters, and the backward is the port of K2 (``attention_bwd``).
With ``hybrid=True`` the forward is instead the composed sublayer over K3
(``ops.mha.mha_core``) under the same backward: the JAX package's hybrid
training forward for towers wider than 768 (``_sub_flat_fwd`` with
``_train_fwd_composed``). ``BWD_MODE`` picks the backward as the JAX
package's ``_BWD_MODE`` does: ``"fused"`` K2; ``"dwsplit"`` K6
(``attention_bwd.attention_sublayer_bwd_split``, K2's chain under its own
launch count); ``"dwsplit_saveqkv"`` K6 reading the qkv that the forward
saved, the forward then K1's (never the hybrid's, as in ``_sub_flat_fwd``).

Numerics follow the TPU kernel, not the composed JAX path: the logits are
scaled by ``D**-0.5`` after the q.k dot, in fp32; P is cast to the compute
dtype before the P.v dot (fp32 sum); up to ``DEFER_ABOVE`` tokens the softmax
normalizes before that dot, above it the fp32 row sum divides the product
(``_pipe_fwd``'s deferred divide); the projections add their fp32 bias to
the fp32 accumulator before the cast; the residual is added in the compute
dtype.

Layouts are the JAX package's: ``x`` is ``[B, S, W]`` or flat ``[B*S, W]``;
weights are ``[in, out]``; the qkv columns are ``[q heads | k heads | v
heads]`` with each head's ``D`` columns contiguous.

Under tensor parallelism (``tp``, a ``parallel.distributed.TPGroup``; the
parameters this rank's shares, ``parallel.mesh``) the sublayer runs on the
rank's heads: ``ln_rows`` on all W, the qkv GEMM on the ``3W / tp`` columns
of its heads, the core on ``heads / tp`` heads (the route decided on the
head_dim, which tp leaves as it is), the out-projection on its ``W / tp``
input rows to an fp32 partial (``gemm_bias_residual``'s partial mode),
summed over the group before ``ops.tp.tp_epilogue``; the backward
all-reduces ``dln`` once (``attention_bwd``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Mapping, NamedTuple, Optional

import torch

from . import _build
from ..parallel.distributed import TPGroup, copy_to_tp
from .quant import linear_w8a8

# Longest sequence attn_core and attn_core_bwd take: the JAX package's flat
# sublayer bound (plip_tpu.ops.attention._MAX_FLAT_M).
MAX_SEQ = 1056
# attn_core holds a head on chip (core_route): in bf16 at head_dim
# TILED_HEAD_DIM up to BF16_ROW_MAX_SEQ tokens, two 64-key tiles of k and v
# on wgmma; in fp32, and in bf16 at another head_dim, up to ROW_MAX_SEQ,
# four 64-key tiles of k and v in shared memory (v over k where both would
# pass MAX_SMEM), head_dim a multiple of 4, on CUDA cores. attn_core_bwd's
# one-block kernels, a block holding the head's k and v and walking its
# query rows, take up to BWD_ROW_MAX_SEQ tokens; both, heads up to
# ONE_BLOCK_MAX_HEAD_DIM wide. Longer sequences, wider heads (and the
# forward at a head_dim that is not a multiple of 4) take the key-tiled
# kernels: on wgmma in bf16 at head_dim TILED_HEAD_DIM, on TF32 tensor-core
# products (csrc/tf32_attn.cuh) in fp32 and at every other head_dim, any
# width (a chunk of 128 columns at a time).
BF16_ROW_MAX_SEQ = 128
ROW_MAX_SEQ = 256
BWD_ROW_MAX_SEQ = 128
ONE_BLOCK_MAX_HEAD_DIM = 128
TILED_HEAD_DIM = 64
# The key-tiled kernels off wgmma (csrc/tf32_attn.cuh): keys a tile; query
# rows a tile of the backward's keys kernel (tiled_plan picks the forward's
# and the rows kernel's).
TILED_KEYS = 64
TILED_KEYS_ROWS = 32
# Above this many tokens the softmax divide is deferred past the P.v dot
# (plip_tpu.ops.attention._pipe_fwd); at or below it, normalize-first.
DEFER_ABOVE = 128
# Shared memory a block may use on Hopper (227 KB).
MAX_SMEM = 232448
# The SMs of an H100 SXM (the card's own count is used on the card).
H100_SMS = 132
# fp32 GEMM block tiles of csrc/simt_gemm.cuh (rows, columns of C), in the
# order its launch_gemm_f32 numbers them: 8 x 8, 4 x 8, 4 x 4 and 2 x 4
# outputs a thread of 256.
SIMT_GEMM_TILES = ((128, 128), (64, 128), (64, 64), (32, 64))

# ln_rows and ln_bwd_rows (csrc/layer_norm.cuh): a block is LN_THREADS
# threads (8 warps); a row is held by 1, 2, 4 or 8 warps, a lane's values in
# the register bucket of LN_BUCKETS that takes them, at most LN_MAX_VALUES
# (the forward: x, scale and bias a value) or LN_BWD_MAX_VALUES (the
# backward: x, dln, gamma and two sums a value) before a row takes more
# warps; widths past LN_MAX_WIDTH (8 warps x 32 lanes x 32 values) take one
# block a row. The forward's grid is at most LN_BLOCKS_PER_SM blocks an SM,
# the rows walked in strides.
LN_THREADS = 256
LN_BUCKETS = (8, 16, 24, 32)
LN_MAX_VALUES, LN_BWD_MAX_VALUES = 32, 16
LN_MAX_WIDTH = 8 * 32 * 32
LN_BLOCKS_PER_SM = 2

LAUNCHES = {"ln_rows": 0, "gemm_bias_residual": 0, "attn_core": 0}

# The sublayer's backward (the JAX package's _BWD_MODE, read when the
# forward runs): "fused" (K2), "dwsplit" or "dwsplit_saveqkv" (K6).
BWD_MODE = "fused"
BWD_MODES = ("fused", "dwsplit", "dwsplit_saveqkv")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_vp, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, scale, bias, out, rows, width, vec, values, warps, blocks (ln_rows_plan), eps,
    # dtype, device, stream
    "plip_ln_rows": (_vp, _vp, _vp, _vp, _int, _int, _int, _int, _int, _int, _float, _int,
                     _int, _vp),
    # a, w, bias, residual, out, M, N, K, tile, dtype, device, stream
    "plip_gemm_bias_residual": (_vp, _vp, _vp, _vp, _vp, _int, _int, _int, _int,
                                _int, _int, _vp),
    # a, w, out (fp32), M, N, K, tile, dtype, device, stream
    "plip_gemm_partial": (_vp, _vp, _vp, _int, _int, _int, _int, _int, _int, _vp),
    # qkv, ctx, B, S, heads, head_dim, causal, s_valid, defer, dtype, device, stream
    "plip_attn_core": (_vp, _vp, _int, _int, _int, _int, _int, _int, _int, _int,
                       _int, _vp),
    # ... defer, win_tiles (tiled_plan), dtype, device, stream
    "plip_attn_core_tiled": (_vp, _vp, _int, _int, _int, _int, _int, _int, _int, _int,
                             _int, _int, _vp),
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


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def simt_gemm_plan(M: int, N: int, sms: int = H100_SMS) -> int:
    """fp32's block tile for ``C [M, N]``, as an index into
    ``SIMT_GEMM_TILES``: the largest whose grid gives every one of ``sms``
    SMs a block, else the smallest."""
    for i, (bm, bn) in enumerate(SIMT_GEMM_TILES):
        if -(-M // bm) * -(-N // bn) >= sms:
            return i
    return len(SIMT_GEMM_TILES) - 1


def gemm_tile(a: torch.Tensor, M: int, N: int) -> int:
    """The ``tile`` argument of the epilogue GEMMs' entry points: fp32's
    planned block tile; bf16 (one 128 x 128 wgmma tile) takes 0."""
    return simt_gemm_plan(M, N, _sm_count(a.device)) if a.dtype == torch.float32 else 0


def sublayer_block_b(B: int, S: int, want: int) -> Optional[int]:
    """The JAX package's flat block picker (``plip_tpu.ops.attention.
    _sublayer_block_b``), copied: the batch rows a TPU program takes, or
    None where none is legal. The port has no such blocks; its gates copy the
    JAX package's through it (``ops.mlp``, ``ops.block_bwd``)."""
    cands = [bb for bb in range(1, B + 1)
             if B % bb == 0 and (bb * S) % 8 == 0 and bb * S <= MAX_SEQ]
    if not cands:
        return B if B * S <= MAX_SEQ else None
    ge = [bb for bb in cands if bb >= want]
    return min(ge) if ge else max(cands)


def _on_cpu(t: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (plain path); False for CUDA; raises otherwise."""
    if t.is_cuda:
        return False
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
    """The current CUDA stream of ``device`` as the kernels' entry points take
    it (the raw handle: ``torch.cuda.current_stream`` builds a Stream object
    each call, which took more host time than a small kernel's launch)."""
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(device.index))


# ---------------------------------------------------------------------------
# ln_rows, and the towers' LayerNorm
# ---------------------------------------------------------------------------


class LnLayout(NamedTuple):
    vec: int     # values a load: 16 bytes' worth, or 1 where W or a base does not allow it
    warps: int   # warps that hold a row (a block holds 8 / warps rows at once); 0: one
                 # block a row, past LN_MAX_WIDTH
    values: int  # values a lane holds: the register bucket (LN_BUCKETS)


@functools.lru_cache(maxsize=256)
def ln_layout(W: int, itemsize: int, aligned: bool, max_values: int = LN_MAX_VALUES
              ) -> LnLayout:
    """The register row layout of ``ln_rows`` and ``ln_bwd_rows``
    (csrc/layer_norm.cuh) for rows of W values of ``itemsize`` bytes:
    16-byte loads where W and every row tensor's base (``aligned``) allow
    them, else one value at a time; the fewest warps a row that leave a
    lane at most ``max_values`` values; the smallest bucket that holds
    them."""
    vec = 16 // itemsize if aligned and W % (16 // itemsize) == 0 else 1
    if W > LN_MAX_WIDTH:
        return LnLayout(1, 0, 0)
    chunks, warps = W // vec, 1
    while warps < 8 and -(-chunks // (32 * warps)) * vec > max_values:
        warps *= 2
    need = -(-chunks // (32 * warps)) * vec
    return LnLayout(vec, warps, next(b for b in LN_BUCKETS if b >= need))


def ln_rows_plan(N: int, layout: LnLayout, sms: int = H100_SMS) -> int:
    """``ln_rows``' grid for N rows: enough blocks for every row group up to
    ``LN_BLOCKS_PER_SM`` an SM (the rows walked in strides); one a row for
    the wide layout."""
    if not layout.warps:
        return N
    return min(-(-N // (LN_THREADS // 32 // layout.warps)), LN_BLOCKS_PER_SM * sms)


def _aligned(*ts) -> bool:
    """Every tensor given (None skipped) starts on a 16-byte boundary."""
    return all(t.data_ptr() % 16 == 0 for t in ts if t is not None)


def layer_norm_rows_reference(x: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics, cast back to x's dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(x.dtype)


def ln_rows(x2: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float = 1e-5, layout: Optional[LnLayout] = None) -> torch.Tensor:
    """LayerNorm of each row of ``x2 [N, W]``; ``scale``/``bias`` fp32 ``[W]``.
    ``layout``: ``ln_layout``'s by default (tests and tuning force others)."""
    if _on_cpu(x2, "ln_rows"):
        return layer_norm_rows_reference(x2, scale, bias, eps)
    code = _dtype_code("ln_rows", x2)
    rows, width = x2.shape
    _check("ln_rows x", x2, x2.device, x2.dtype, (rows, width))
    _check("ln_rows scale", scale, x2.device, torch.float32, (width,))
    _check("ln_rows bias", bias, x2.device, torch.float32, (width,))
    out = torch.empty_like(x2)
    layout = layout or ln_layout(width, x2.element_size(), _aligned(x2))
    _launch("ln_rows", _lib().plip_ln_rows, x2.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), out.data_ptr(), rows, width, layout.vec, layout.values,
            layout.warps, ln_rows_plan(rows, layout, _sm_count(x2.device)), eps, code,
            x2.device.index, _stream(x2.device))
    return out


class LayerNormRowsFn(torch.autograd.Function):
    """LayerNorm of flat rows ``x2 [N, W]`` under autograd: the forward is
    ``ln_rows`` and saves x2 and the fp32 scale; the backward is
    ``ln_bwd_rows`` without a residual (the incoming grad read in x2's
    dtype) and ``col_sum`` of its partials: dx in x2's dtype, fp32 dscale and
    dbias. On the CPU each is its plain version."""

    @staticmethod
    def forward(ctx, x2, scale, bias, eps):
        ctx.save_for_backward(x2, scale)
        ctx.eps = eps
        return ln_rows(x2, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        from .attention_bwd import col_sum, ln_bwd_rows  # imports this module

        x2, scale = ctx.saved_tensors
        dx, partial = ln_bwd_rows(x2, g.contiguous(), None, scale, ctx.eps)
        dgb = col_sum(partial)
        W = x2.shape[1]
        return dx, dgb[:W], dgb[W:], None


def layer_norm_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """The towers' LayerNorm (``LayerNormRowsFn``) of ``x [..., W]`` (any
    strides: made contiguous here): the JAX package's
    ``plip_tpu.models.layers.layer_norm``, fp32 statistics, the output in x's
    dtype. On a CUDA tensor it launches ``ln_rows`` (and ``ln_bwd_rows``,
    ``col_sum`` backward) or raises."""
    W = x.shape[-1]
    y = LayerNormRowsFn.apply(x.reshape(-1, W).contiguous(), scale.float(), bias.float(), eps)
    return y.view(x.shape)


# ---------------------------------------------------------------------------
# gemm_bias_residual
# ---------------------------------------------------------------------------


def gemm_bias_residual_reference(a: torch.Tensor, w: torch.Tensor,
                                 bias: Optional[torch.Tensor],
                                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``cast(a . w + bias) [+ residual]``: the product of the compute-dtype
    operands is summed in fp32 (exact products, fp32 accumulation) and the
    fp32 bias added before the one cast; the residual is added after it.
    ``bias`` None: the fp32 sum itself (no cast, no residual)."""
    if bias is None:
        return torch.matmul(a.float(), w.float())
    y = torch.addmm(bias.float(), a.float(), w.float()).to(a.dtype)
    return y if residual is None else residual + y


def gemm_bias_residual(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                       residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``a [M, K] . w [K, N] + bias [N]`` (+ ``residual [M, N]``) in a's dtype.

    ``w`` has a's dtype, ``bias`` is fp32. In bf16, K and N must be multiples
    of 8 and every tensor 16-byte aligned: the kernel (``csrc/gemm.cuh``, a
    128 x 128 tile on ``wgmma``) moves its operands, bias, residual and
    output in 16-byte chunks. fp32 runs the CUDA-core GEMM of
    ``csrc/simt_gemm.cuh`` on the block tile of ``simt_gemm_plan``.

    ``bias`` None is the fp32 partial mode: the fp32 sum ``a . w`` itself, no
    bias, no cast and no residual (the entry point ``plip_gemm_partial``, the
    same GEMM): a tensor-parallel rank's share of a row-parallel product,
    which ``ops.tp.row_parallel`` sums over the ranks before the epilogue."""
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
    if bias is None:
        if residual is not None:
            raise ValueError("gemm_bias_residual: the fp32 partial mode takes no residual")
        out = torch.empty((M, N), dtype=torch.float32, device=a.device)
        _launch("gemm_bias_residual", _lib().plip_gemm_partial, a.data_ptr(), w.data_ptr(),
                out.data_ptr(), M, N, K, gemm_tile(a, M, N), code, a.device.index,
                _stream(a.device))
        return out
    _check("gemm_bias_residual bias", bias, a.device, torch.float32, (N,), align16=bf)
    if residual is not None:
        _check("gemm_bias_residual residual", residual, a.device, a.dtype, (M, N),
               align16=bf)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    _launch("gemm_bias_residual", _lib().plip_gemm_bias_residual, a.data_ptr(),
            w.data_ptr(), bias.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            M, N, K, gemm_tile(a, M, N), code, a.device.index, _stream(a.device))
    return out


# ---------------------------------------------------------------------------
# attn_core
# ---------------------------------------------------------------------------


def keep_mask(S: int, causal: bool, s_valid: Optional[int], device) -> torch.Tensor:
    """``[S, S]`` bool: row i may attend column j (causal: j <= i; pad
    columns j >= ``s_valid`` dropped)."""
    keep = torch.ones(S, S, dtype=torch.bool, device=device)
    if causal:
        keep = keep.tril()
    if s_valid is not None and s_valid < S:
        keep[:, s_valid:] = False
    return keep


def softmax_pv_reference(logits: torch.Tensor, v: torch.Tensor, dtype: torch.dtype,
                         defer: bool) -> torch.Tensor:
    """fp32 masked ``logits [.., S, S]`` and ``v [.., S, D]`` -> the context in
    ``dtype``. P is cast to ``dtype`` before the P.v dot, which sums in fp32.
    ``defer=False``: P is normalized before the cast. ``defer=True``: P is
    ``exp(l - max)`` and the fp32 row sum divides the dot's result."""
    if not defer:
        p = torch.softmax(logits, dim=-1).to(dtype)
        return torch.matmul(p.float(), v.float()).to(dtype)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    ctx = torch.matmul(e.to(dtype).float(), v.float()) / e.sum(-1, keepdim=True)
    return ctx.to(dtype)


def attn_core_reference(qkv2: torch.Tensor, S: int, heads: int, causal: bool = False,
                        s_valid: Optional[int] = None,
                        defer: Optional[bool] = None) -> torch.Tensor:
    """``[B*S, 3W]`` qkv -> ``[B*S, W]`` context, in qkv's dtype."""
    N, W3 = qkv2.shape
    W = W3 // 3
    D = W // heads
    B = N // S
    q, k, v = qkv2.view(B, S, 3, heads, D).permute(2, 0, 3, 1, 4).unbind(0)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * D ** -0.5
    logits = logits.masked_fill(~keep_mask(S, causal, s_valid, qkv2.device), float("-inf"))
    defer = S > DEFER_ABOVE if defer is None else defer
    ctx = softmax_pv_reference(logits, v, qkv2.dtype, defer)  # [B, H, S, D]
    return ctx.transpose(1, 2).reshape(N, W)


def attn_core(qkv2: torch.Tensor, S: int, heads: int, causal: bool = False,
              s_valid: Optional[int] = None, defer: Optional[bool] = None) -> torch.Tensor:
    """Masked multi-head attention of ``qkv2 [B*S, 3W]`` -> ``[B*S, W]``,
    S <= ``MAX_SEQ``.

    ``s_valid``: columns at or past it (within each sequence) are padding and
    get no attention. ``defer``: whether the softmax divide is deferred past
    the P.v dot; by default it is above ``DEFER_ABOVE`` tokens (K1's
    forward). ``defer=False`` at any S is the normalize-first context that the
    whole-block backward (``ops.block_bwd``) recomputes."""
    if _on_cpu(qkv2, "attn_core"):
        return attn_core_reference(qkv2, S, heads, causal, s_valid, defer)
    code = _dtype_code("attn_core", qkv2)
    N, W3 = qkv2.shape
    W = W3 // 3
    D = W // heads
    _check_geometry(N, S, W, heads, s_valid)
    defer = S > DEFER_ABOVE if defer is None else defer
    route = core_route(S, D, qkv2.dtype)
    # 16-byte copies: wgmma's tiles, the one-block core's q, k and v rows
    _check("attn_core qkv", qkv2, qkv2.device, qkv2.dtype, (N, 3 * W),
           align16=route == "one_block" or wgmma_head(qkv2.dtype, D))
    ctx = torch.empty((N, W), dtype=qkv2.dtype, device=qkv2.device)
    args = (qkv2.data_ptr(), ctx.data_ptr(), N // S, S, heads, D, int(causal),
            S if s_valid is None else s_valid, int(defer))
    tail = (code, qkv2.device.index, _stream(qkv2.device))
    if route == "tiled":
        _launch("attn_core", _lib().plip_attn_core_tiled, *args, tiled_plan(S, D)[1], *tail)
    else:
        _launch("attn_core", _lib().plip_attn_core, *args, *tail)
    return ctx


def core_route(S: int, head_dim: int, dtype: torch.dtype, backward: bool = False) -> str:
    """The kernel ``attn_core`` (or, with ``backward``, ``attn_core_bwd``)
    runs for sequences of S tokens at ``head_dim`` in ``dtype``:

    - ``"wgmma"``: bf16 at head_dim ``TILED_HEAD_DIM`` up to
      ``BF16_ROW_MAX_SEQ`` tokens, the head on chip on ``wgmma``;
    - ``"one_block"``: fp32, and bf16 at any other head_dim, up to
      ``ROW_MAX_SEQ`` tokens (``BWD_ROW_MAX_SEQ`` backward) and head_dim
      ``ONE_BLOCK_MAX_HEAD_DIM`` on CUDA cores; the forward takes a head_dim
      that is a multiple of 4;
    - ``"tiled"``: the rest, the key-tiled kernels (``csrc/mha.cu``,
      ``csrc/mha_bwd.cu``): bf16 at head_dim ``TILED_HEAD_DIM`` on
      ``wgmma``; fp32, and bf16 at every other head_dim, on TF32
      tensor-core products, any width.

    Every route takes both softmax schedules, so ``defer`` does not enter.
    The one-block kernels fit shared memory at every head_dim they take
    (``core_v_over_k``, ``attention_bwd._core_bwd_smem_bytes``), the
    key-tiled ones at every S and head_dim (``tiled_plan``)."""
    if wgmma_head(dtype, head_dim):
        return "wgmma" if S <= BF16_ROW_MAX_SEQ else "tiled"
    if head_dim > ONE_BLOCK_MAX_HEAD_DIM or S > (BWD_ROW_MAX_SEQ if backward else ROW_MAX_SEQ):
        return "tiled"
    return "one_block" if backward or head_dim % 4 == 0 else "tiled"


def wgmma_head(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether the cores run on ``wgmma`` (bf16 at head_dim
    ``TILED_HEAD_DIM``), whose tiles are 16-byte copies (csrc/wgmma.cuh): qkv
    and g must then be 16-byte aligned. The TF32 key-tiled kernels take any
    alignment (16-byte copies where it allows, else a value at a time)."""
    return dtype == torch.bfloat16 and head_dim == TILED_HEAD_DIM


def _core_smem_bytes(S: int, D: int, v_over_k: bool = False) -> int:
    """The one-block core's shared memory (core_smem_bytes in the kernel), in
    fp32: the 64-row q tile, which P overwrites, and k (rows padded to an odd
    count of 16-byte units) and v of ceil(S/64) key tiles, v beside k or,
    ``v_over_k``, over it once the logits are in; and the row sums."""
    keys = 64 * -(-S // 64)
    ldk = D if (D // 4) % 2 else D + 4
    return 4 * (64 * max(ldk, keys + 4) + keys * ldk + (0 if v_over_k else keys * D) + 64)


def core_v_over_k(S: int, D: int) -> bool:
    """Whether the one-block core loads v over k after the logits
    (core_v_over_k in the kernel): where k and v side by side would pass
    ``MAX_SMEM``, at the widest heads past 128 tokens."""
    return _core_smem_bytes(S, D) > MAX_SMEM


def tiled_chunk(D: int) -> int:
    """The head columns a tile of the key-tiled TF32 kernels holds (their
    kDc): 64 up to head_dim 64, else 128; a wider head goes a chunk at a
    time."""
    return 64 if D <= 64 else 128


def tiled_smem(S: int, D: int, win_tiles: int, kernel: str = "fwd", rows: int = 64) -> int:
    """Shared memory of a block of a key-tiled TF32 kernel (FwdSmem,
    RowsSmem, KeysSmem in the kernels), in bytes: ``"fwd"`` (csrc/mha.cu,
    ``rows`` query rows), the backward's ``"rows"`` (``rows`` query rows)
    and ``"keys"`` kernels (csrc/mha_bwd.cu); ``win_tiles`` key tiles a
    window of the strips. Tiles are fp32 rows of the chunk plus 4 floats;
    strip rows the window's keys (at most S rounded up to 32) plus 4; the
    key spans' row statistics a few hundred floats; a head wider than one
    chunk streams q's (and g's) chunks through the ring instead of keeping
    them."""
    dc = tiled_chunk(D)
    streamed = D > dc
    kt, qk = TILED_KEYS, TILED_KEYS_ROWS
    ld_t, ld_s = dc + 4, min(kt * win_tiles, -(-S // 32) * 32) + 4
    if kernel == "fwd":
        floats = (rows * ld_s + (0 if streamed else rows * ld_t) + 2 * 2 * 64
                  + 2 * (kt * ld_t + (rows * ld_t if streamed else 0)))
    elif kernel == "rows":
        floats = (2 * rows * ld_s + (0 if streamed else 2 * rows * ld_t) + 3 * 2 * 64
                  + 2 * (kt * ld_t + (rows * ld_t if streamed else 0)))
    else:
        floats = ((0 if streamed else 2 * kt * ld_t) + 2 * qk * (kt + 8) + 2 * 3 * qk
                  + 2 * ((kt + qk) * ld_t if streamed else 2 * qk * ld_t))
    return 4 * floats


def _widest_window(S: int, D: int, rows: int, kernel: str) -> int:
    """The most key tiles a window of ``rows`` query rows holds in
    ``MAX_SMEM`` (0 if not one)."""
    win = -(-S // TILED_KEYS)
    while win and tiled_smem(S, D, win, kernel, rows) > MAX_SMEM:
        win -= 1
    return win


@functools.lru_cache(maxsize=None)
def tiled_plan(S: int, D: int, backward: bool = False):
    """(query rows a block, key tiles a window) of the key-tiled TF32
    kernels at S tokens and head_dim D, as their entry points take them.
    Each logit is computed once where the window holds every key, twice
    (once for the row statistics, once for P or dS) where it does not. The
    forward takes 64 rows (8 warps, two to a row group) and the widest
    window; the backward's rows kernel 64 rows if a window holds every key,
    else 128 (8 warps, one to a row group) if one tile fits, else 64, at the
    widest window: the fastest plans on an H100 at the towers' shapes
    (PERF.md section 6)."""
    tiles = -(-S // TILED_KEYS)
    if not backward:
        return 64, _widest_window(S, D, 64, "fwd")
    if _widest_window(S, D, 64, "rows") == tiles:
        return 64, tiles
    for rows in (128, 64):
        win = _widest_window(S, D, rows, "rows")
        if win:
            return rows, win
    raise ValueError(f"no plan fits {MAX_SMEM} bytes at S={S}, head_dim={D}")


def _check_geometry(N: int, S: int, W: int, heads: int, s_valid: Optional[int],
                    max_seq: int = MAX_SEQ, name: str = "attn_core"):
    if S < 1 or N % S:
        raise ValueError(f"{N} token rows do not split into sequences of {S}")
    if S > max_seq:
        raise ValueError(f"{name} takes S <= {max_seq}, got S={S}")
    if W % heads:
        raise ValueError(f"width {W} with {heads} heads: head_dim must divide the width")
    if s_valid is not None and not 1 <= s_valid <= S:
        raise ValueError(f"s_valid={s_valid} outside [1, {S}]")


# ---------------------------------------------------------------------------
# The sublayer
# ---------------------------------------------------------------------------


def linear(x: torch.Tensor, p: Mapping) -> torch.Tensor:
    """x @ kernel + bias, in x's dtype; a W8A8 linear (``kernel_q``,
    ``ops.quant``) takes ``linear_w8a8``."""
    if "kernel_q" in p:
        return linear_w8a8(x, p)
    y = torch.matmul(x, p["kernel"].to(x.dtype))
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def composed_sublayer(x: torch.Tensor, ln: Mapping, attn: Mapping, heads: int,
                      causal: bool, s_valid: Optional[int], eps: float, S: int,
                      core: Callable, ln_fn: Optional[Callable] = None,
                      tp: Optional[TPGroup] = None) -> torch.Tensor:
    """``x + linear(core(linear(LN1 x, qkv)), out)`` on ``[B, S, W]`` or flat
    ``[B*S, W]`` tokens: the JAX package's ``_jnp_attn_sublayer``, the
    projections in the compute dtype, ``core(qkv, S, heads, causal[,
    s_valid])`` the attention core (``s_valid`` passed only when given),
    LN1 ``ln_fn`` (``layer_norm_rows`` unless given). Under ``tp``, ``attn``
    holds this rank's shares and ``heads`` its heads: ``copy_to_tp`` on
    LN1's output, the qkv columns and the core local, the out-projection
    ``ops.tp.row_linear``."""
    ln_fn = ln_fn or layer_norm_rows
    qkv = linear(copy_to_tp(ln_fn(x, ln["scale"], ln["bias"], eps), tp), attn["qkv"])
    ctx = (core(qkv, S, heads, causal) if s_valid is None
           else core(qkv, S, heads, causal, s_valid))
    if tp is None:
        return x + linear(ctx, attn["out"])
    from .tp import row_linear  # ops.tp imports this module

    return row_linear(ctx, attn["out"], x, tp)


def _sublayer(x, ln, attn, heads, causal, s_valid, eps, S,
              ln_fn: Callable, gemm_fn: Callable, core_fn: Callable, emit_qkv: bool = False,
              tp: Optional[TPGroup] = None, epi_fn: Callable = None):
    """K1's chain; with ``emit_qkv`` also its ``[B*S, 3W]`` qkv. Under ``tp``
    (``attn`` this rank's shares, ``heads`` its heads) the out-projection is
    ``ops.tp.row_parallel`` with ``gemm_fn``'s partial mode and ``epi_fn``
    (``ops.tp.tp_epilogue`` unless given)."""
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
    wout = attn["out"]["kernel"].to(dt)
    if tp is None:
        out = gemm_fn(ctx, wout, attn["out"]["bias"], x2)
    else:
        from .tp import row_parallel  # ops.tp imports this module

        out = row_parallel(ctx, wout, attn["out"]["bias"], x2, tp, gemm_fn, epi_fn)
    out = out.reshape(x.shape)
    return (out, qkv) if emit_qkv else out


class AttentionSublayerFn(torch.autograd.Function):
    """The sublayer on flat ``[B*S, W]`` tokens as an autograd function, as
    the JAX package's custom VJP makes it: the forward is K1 (the CUDA
    kernels on the card, the plain versions on the CPU) and saves only ``x``
    and the parameters; the backward is K2 (``attention_bwd``), which
    recomputes the rest with K1's formulation. It takes the fp32 parameters,
    casts the two weight matrices to x's dtype inside, and returns fp32
    parameter grads. ``hybrid``: the forward is the composed sublayer over
    K3 instead (the JAX package's hybrid), the backward the same K2.
    ``BWD_MODE`` (the module doc) picks the backward, and under
    ``"dwsplit_saveqkv"`` the forward, which then also saves its qkv.
    ``tp`` (an optional last argument, a ``parallel.distributed.TPGroup``):
    the parameters are this rank's shares and ``heads`` its heads; the
    out-projection is ``ops.tp.row_parallel`` and the backward all-reduces
    ``dln`` (``attention_bwd``)."""

    @staticmethod
    def forward(ctx, x2, ln_scale, ln_bias, wqkv, bqkv, wout, bout, S, heads, causal,
                s_valid, eps, hybrid, *tp):
        if BWD_MODE not in BWD_MODES:
            raise ValueError(f"BWD_MODE={BWD_MODE!r}: one of {BWD_MODES}")
        ctx.geometry = (S, heads, causal, s_valid, eps)
        ctx.mode, ctx.n_tp = BWD_MODE, len(tp)
        tp = ctx.tp = tp[0] if tp else None
        ln = {"scale": ln_scale, "bias": ln_bias}
        attn = {"qkv": {"kernel": wqkv, "bias": bqkv}, "out": {"kernel": wout, "bias": bout}}
        saved = (x2, ln_scale, ln_bias, wqkv, bqkv, wout)
        if BWD_MODE == "dwsplit_saveqkv":  # before the hybrid, as _sub_flat_fwd
            out, qkv = _sublayer(x2, ln, attn, heads, causal, s_valid, eps, S, ln_rows,
                                 gemm_bias_residual, attn_core, emit_qkv=True, tp=tp)
            ctx.save_for_backward(*saved, qkv)
            return out
        ctx.save_for_backward(*saved)
        if hybrid:
            from .mha import mha_core  # ops.mha imports this module

            return composed_sublayer(x2, ln, attn, heads, causal, s_valid, eps, S, mha_core,
                                     tp=tp)
        return _sublayer(x2, ln, attn, heads, causal, s_valid, eps, S,
                         ln_rows, gemm_bias_residual, attn_core, tp=tp)

    @staticmethod
    def backward(ctx, g2):
        from . import attention_bwd  # imports this module

        x2, ln_scale, ln_bias, wqkv, bqkv, wout, *qkv2 = ctx.saved_tensors
        args = (x2, g2.contiguous(), {"scale": ln_scale, "bias": ln_bias},
                {"qkv": {"kernel": wqkv, "bias": bqkv}, "out": {"kernel": wout}},
                *ctx.geometry)
        bwd = (attention_bwd.attention_sublayer_bwd if ctx.mode == "fused"
               else attention_bwd.attention_sublayer_bwd_split)
        dx, dln, dattn = bwd(*args, qkv2=qkv2[0] if qkv2 else None, tp=ctx.tp)
        return (dx, dln["scale"], dln["bias"], dattn["qkv"]["kernel"],
                dattn["qkv"]["bias"], dattn["out"]["kernel"], dattn["out"]["bias"],
                None, None, None, None, None, None) + (None,) * ctx.n_tp


def attention_sublayer(x: torch.Tensor, ln: Mapping, attn: Mapping, heads: int,
                       causal: bool = False, s_valid: Optional[int] = None,
                       eps: float = 1e-5, S: Optional[int] = None,
                       hybrid: bool = False, tp: Optional[TPGroup] = None) -> torch.Tensor:
    """``x + out_proj(attention(qkv_proj(LN(x))))`` through the CUDA kernels,
    differentiable through ``AttentionSublayerFn``; ``hybrid``: the forward
    is the composed sublayer over K3, the backward K2 all the same. ``tp``:
    ``attn`` holds this rank's shares (``parallel.mesh``) and ``heads`` its
    heads.

    ``x``: ``[B, S, W]``, or ``[B*S, W]`` with ``S`` given, in fp32 or bf16.
    ``ln``: ``{"scale", "bias"}`` fp32 ``[W]``. ``attn``: ``{"qkv": {"kernel"
    [W, 3W], "bias" [3W]}, "out": {"kernel" [W, W], "bias" [W]}}``, fp32
    (the kernels are cast to x's dtype here). On the CPU it is
    ``attention_sublayer_reference`` forward, and
    ``attention_bwd.attention_sublayer_bwd_reference`` backward."""
    if x.dim() == 3:
        S = x.shape[1]
    elif S is None:
        raise ValueError("flat [N, W] input needs the sequence length S")
    x2 = x.reshape(-1, x.shape[-1])
    out = AttentionSublayerFn.apply(
        x2, ln["scale"], ln["bias"], attn["qkv"]["kernel"], attn["qkv"]["bias"],
        attn["out"]["kernel"], attn["out"]["bias"], S, heads, causal, s_valid, eps, hybrid, tp)
    return out.reshape(x.shape)


def attention_sublayer_reference(x: torch.Tensor, ln: Mapping, attn: Mapping,
                                 heads: int, causal: bool = False,
                                 s_valid: Optional[int] = None, eps: float = 1e-5,
                                 S: Optional[int] = None, hybrid: bool = False,
                                 tp: Optional[TPGroup] = None) -> torch.Tensor:
    """The plain PyTorch version of ``attention_sublayer``'s forward, on any
    device (differentiable by autograd)."""
    if hybrid:
        from .mha import mha_core_reference  # ops.mha imports this module

        S = x.shape[1] if x.dim() == 3 else S
        return composed_sublayer(x, ln, attn, heads, causal, s_valid, eps, S,
                                 mha_core_reference, layer_norm_rows_reference, tp)
    epi_fn = None
    if tp is not None:
        from .tp import tp_epilogue_reference as epi_fn  # ops.tp imports this module
    return _sublayer(x, ln, attn, heads, causal, s_valid, eps, S,
                     layer_norm_rows_reference, gemm_bias_residual_reference,
                     attn_core_reference, tp=tp, epi_fn=epi_fn)
