"""Backward of the attention sublayer ``x + attn(LN1 x) . Wout + bout``.

The port of ``plip_tpu.ops.attention._attn_sublayer_bwd_kernel`` (K2) with
its core ``_core_fwd_bwd_block``: from the sublayer's input ``x`` and the
grad ``g`` of its output it recomputes LN1, qkv and the softmax and returns
``dx`` and the fp32 grads of the LN and projection parameters. On a CUDA
tensor it runs K1's ``ln_rows`` and ``gemm_bias_residual`` (the recompute)
and four hand-written kernels (``csrc/attention_sublayer_bwd.cu``):

- ``grad_gemm``: the products of the backward, fp32 accumulation, one
  operand transposed: ``dctx = g . Wout^T``, ``dln = dqkv . Wqkv^T`` (NT) and
  ``dWout = ctx^T . g``, ``dWqkv = ln^T . dqkv`` (TN, summed over the token
  rows in slices that ``col_sum`` adds, as many as the card's SMs need,
  ``tn_slice_rows``). bf16 on ``wgmma``; fp32, ``CLIPTuner``'s default
  dtype, on the CUDA-core main loop of ``csrc/simt_gemm.cuh``, NT cut into
  K slices too (``f32_slice_rows``);
- ``attn_core_bwd``: the context and dqkv, S <= ``MAX_SEQ`` (1056, as K1's
  forward), on the route ``attention.core_route`` picks: one block per
  (sequence, head) up to ``BWD_ROW_MAX_SEQ`` tokens (in bf16 at head_dim 64 on
  ``wgmma``, with the head's q, g, k, v, e_c and ds_u on chip and one
  launch; in fp32 and in bf16 at another head_dim up to 128 on CUDA cores,
  k and v resident and the query rows walked in tiles, every product
  register-tiled), and above it (or at a wider head) the key-tiled kernels
  of ``csrc/mha_bwd.cu`` in this schedule (off wgmma on TF32 tensor-core
  products: s and dp computed once a query tile into shared memory, on the
  plan of ``attention.tiled_plan``);
- ``ln_bwd_rows``: the LN backward plus the residual, and per block of rows
  (``ln_bwd_split``) partial sums of dgamma and dbeta; a row in a warp's
  registers, as ``ln_rows`` holds it; it is also the backward of every
  other LayerNorm of the towers (``attention.layer_norm_rows``, no
  residual, the grad in the compute dtype);
- ``col_sum``: fp32 column sums (bias grads, the LN partials, the slices),
  in the column strips and row splits of ``col_sum_plan`` (16-byte loads,
  several blocks on every SM), the splits added in a fixed order.

Each has its plain PyTorch version beside it (``*_reference``), which a
wrapper takes only for a tensor on the CPU; for a CUDA tensor it launches its
kernel or raises. ``LAUNCHES`` counts the launches per kernel.

``attention_sublayer_bwd_split`` is the port of K6,
``_attn_sublayer_bwd_split_kernel``, the backward the JAX package takes under
``_BWD_MODE`` ``"dwsplit"`` and ``"dwsplit_saveqkv"`` (here
``ops.attention.BWD_MODE``): K2's function, its kernel owning only the dx
chain and emitting (ln, ctx, dqkv) for the weight products outside it. Here
K2 already runs those products as their own launches, so the split backward
is K2's chain: an alias that counts its calls under its own name. The one
difference of ``"dwsplit_saveqkv"``, the qkv that the forward saved and the
backward reads instead of recomputing it, is ``attention_sublayer_bwd``'s
``qkv2`` argument, which either name takes.

Rounding points are K2's, with its core's pipelined, deferred-divide
schedule (the TPU kernel takes it at every S): ``e = exp(l - m)`` stays fp32
and is cast once as ``e_c``; the context is recomputed as
``(e_c . v) / denom``; ``ghn = (g / denom)`` cast, ``dv = e_c^T . ghn``,
``dp = g . v^T``, ``ds_u = (e * (dp - rowsum(dp * e) / denom))`` cast,
``dq = (ds_u . k) * scale / denom``, ``dk = ds_u^T . ((q / denom) cast) *
scale``; ``dctx`` is cast to the compute dtype and ``dln`` stays fp32; the LN
backward runs in fp32 and ``dx = g + cast(dx_ln)``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping, NamedTuple, Optional

import torch

from . import _build
from .attention import (H100_SMS, LN_BWD_MAX_VALUES, MAX_SEQ, MAX_SMEM, SIMT_GEMM_TILES,
                        LnLayout, _aligned, _check, _check_geometry, _dtype_code, _on_cpu,
                        _sm_count, _stream, core_route, gemm_bias_residual,
                        gemm_bias_residual_reference, keep_mask, layer_norm_rows_reference,
                        ln_layout, ln_rows, tiled_plan, wgmma_head)

LAUNCHES = {"grad_gemm": 0, "attn_core_bwd": 0, "ln_bwd_rows": 0, "col_sum": 0,
            # calls on the card, so that a step shows which backward ran
            "attention_sublayer_bwd": 0, "attention_sublayer_bwd_split": 0}

# The bf16 TN products take at most ceil(K / K_SLICE) slices.
K_SLICE = 1024
# The bf16 products' block tile (rows and columns of C) and K step
# (csrc/wgmma_gemm.cuh).
GEMM_TILE, GEMM_K_STEP = 128, 64
# The fp32 products' K step (csrc/simt_gemm.cuh kBK), its blocks an SM
# (__launch_bounds__), the fewest token rows and the most slices of an fp32
# product's plan, and how close to the best wave fill its slice count comes.
SIMT_K_STEP, SIMT_BLOCKS_PER_SM, SIMT_MIN_SLICE, SIMT_MAX_SLICES = 8, 2, 128, 16
SIMT_FILL_SLACK = 0.95
# tn_slice_rows takes the fewest TN slices whose blocks leave the last wave
# over the SMs at least this full.
WAVE_FILL = 0.75
# ln_bwd_rows' plan aims at this many blocks an SM, each summing its rows
# into one partial row of dgamma/dbeta (ln_bwd_split): its kernel holds a
# lane's values in at most 128 registers (two blocks an SM) up to
# LN_BWD_MAX_VALUES values a lane, the widths up to 256 lanes times that.
LN_BWD_BLOCKS_PER_SM = 2
# col_sum (csrc/attention_sublayer_bwd.cu): threads a block, loads in flight a
# thread, the most row splits and the most rows a block reads at once
# (kSumThreads, kSumUnroll, kSumMaxSplits, the largest ty); its plan aims at
# COL_SUM_BLOCKS_PER_SM blocks on every SM.
COL_SUM_THREADS, COL_SUM_UNROLL, COL_SUM_MAX_SPLITS, COL_SUM_ROWS = 256, 4, 32, 32
COL_SUM_BLOCKS_PER_SM = 4

_vp, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # a, b, out, M, N, K, kslice, tn, out_f32, dtype, device, stream
    "plip_grad_gemm": (_vp, _vp, _vp, _int, _int, _int, _int, _int, _int, _int, _int,
                       _vp),
    # qkv, dctx, ctx, dqkv, B, S, heads, head_dim, causal, s_valid, dtype, device, stream
    "plip_attn_core_bwd": (_vp, _vp, _vp, _vp, _int, _int, _int, _int, _int, _int, _int,
                           _int, _vp),
    # qkv, dctx, ctx, dqkv, stats, B, S, heads, head_dim, causal, s_valid, rows, win_tiles
    # (attention.tiled_plan), dtype, device, stream
    "plip_attn_core_bwd_tiled": (_vp, _vp, _vp, _vp, _vp, _int, _int, _int, _int, _int,
                                 _int, _int, _int, _int, _int, _vp),
    # x, dln, g, gamma, dx, partial, rows, width, vec, values, warps, rows_per_block
    # (ln_bwd_split), eps, dtype, dln_f32, device, stream
    "plip_ln_bwd_rows": (_vp, _vp, _vp, _vp, _vp, _vp, _int, _int, _int, _int, _int, _int,
                         _float, _int, _int, _int, _vp),
    # in, out, partial, counters, rows, cols, vec, ty, split_rows, dtype, device, stream
    "plip_col_sum": (_vp, _vp, _vp, _vp, _int, _int, _int, _int, _int, _int, _int, _vp),
}
_kernels = None
_col_sum_scratch = {}  # (device index, stream) -> (partial sums, strip counters)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _kernels
    if _kernels is None:
        _kernels = _build.bind(_SIGNATURES)
    return _kernels


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error {rc}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# grad_gemm
# ---------------------------------------------------------------------------


def grad_gemm_nt_reference(a: torch.Tensor, b: torch.Tensor,
                           out_dtype: torch.dtype) -> torch.Tensor:
    """``a [M, K] . b [N, K]^T``: exact products of the operands, fp32 sum,
    one cast to ``out_dtype``."""
    return torch.matmul(a.float(), b.float().t()).to(out_dtype)


def grad_gemm_tn_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [K, M]^T . b [K, N]`` in fp32 (exact products, fp32 sum)."""
    return torch.matmul(a.float().t(), b.float())


def _fewest_slices(tiles: int, max_slices: int, slots: int) -> int:
    """The fewest slices (at most ``max_slices``) whose blocks, ``tiles`` a
    slice, leave the last wave over ``slots`` block slots at least
    ``WAVE_FILL`` full (each slice adds an fp32 ``[M, N]`` that ``col_sum``
    reads again)."""
    n = 1
    while n < max_slices and tiles * n < WAVE_FILL * slots * -(-tiles * n // slots):
        n += 1
    return n


def tn_slice_rows(M: int, N: int, K: int, dtype: torch.dtype, sms: int = H100_SMS) -> int:
    """The token rows of each slice of a TN product ``[K, M]^T . [K, N]``
    (the last slice takes the rest), whole K steps. bf16: the fewest slices
    of 128 x 128 wgmma tiles, one block an SM, at most ``ceil(K /
    K_SLICE)``, that fill the card (``_fewest_slices``). fp32: as
    ``f32_slice_rows``."""
    if dtype == torch.bfloat16:
        tiles = -(-M // GEMM_TILE) * -(-N // GEMM_TILE)
        n = _fewest_slices(tiles, -(-K // K_SLICE), sms)
        return -(-K // (GEMM_K_STEP * n)) * GEMM_K_STEP
    return f32_slice_rows(M, N, K, sms)


def f32_slice_rows(M: int, N: int, K: int, sms: int = H100_SMS) -> int:
    """The token rows of each K slice of an fp32 product (either layout) on
    the 128 x 128 tile of ``csrc/simt_gemm.cuh``, ``SIMT_BLOCKS_PER_SM``
    blocks an SM: the fewest slices (at most ``SIMT_MAX_SLICES``, each at
    least ``SIMT_MIN_SLICE`` rows) whose blocks fill their waves over the
    card at least ``SIMT_FILL_SLACK`` as well as the best such count does.
    A wave of 128 x 128 blocks runs a K row in about the same time however
    full it is, so the fill sets the time; each slice adds an fp32 ``[M,
    N]`` that ``col_sum`` reads again, small beside it at the towers'
    shapes."""
    bm, bn = SIMT_GEMM_TILES[0]
    tiles, slots = -(-M // bm) * -(-N // bn), SIMT_BLOCKS_PER_SM * sms
    counts = range(1, max(1, min(SIMT_MAX_SLICES, K // SIMT_MIN_SLICE)) + 1)
    fill = {n: tiles * n / (slots * -(-tiles * n // slots)) for n in counts}
    n = min(k for k in counts if fill[k] >= SIMT_FILL_SLACK * max(fill.values()))
    return -(-K // (SIMT_K_STEP * n)) * SIMT_K_STEP


def tn_slices(M: int, N: int, K: int, dtype: torch.dtype, sms: int = H100_SMS):
    """``[(start, stop), ...]``: the token rows each slice of a TN product sums."""
    rows = tn_slice_rows(M, N, K, dtype, sms)
    return [(k, min(K, k + rows)) for k in range(0, K, rows)]


def _grad_gemm(a, b, M, N, K, tn, out_dtype):
    """bf16: NT (``tn`` False) one run over K, TN the slices of
    ``tn_slice_rows``; fp32 both in the slices of ``f32_slice_rows``."""
    code = _dtype_code("grad_gemm", a)
    bf = a.dtype == torch.bfloat16
    contiguous = (M, N) if tn else (K, K)  # of a, of b
    if bf and (contiguous[0] % 8 or contiguous[1] % 8):
        raise ValueError(f"grad_gemm: bf16 needs the operands' rows to be multiples "
                         f"of 8 elements, got {contiguous}")
    _check("grad_gemm a", a, a.device, a.dtype, (K, M) if tn else (M, K), bf)
    _check("grad_gemm b", b, a.device, a.dtype, (K, N) if tn else (N, K), bf)
    sms = _sm_count(a.device)
    if bf:  # NT one run over K
        rows = tn_slice_rows(M, N, K, a.dtype, sms) if tn else K
    else:
        rows = f32_slice_rows(M, N, K, sms)
    splits = -(-K // rows)
    out = torch.empty((splits, M, N) if splits > 1 else (M, N), dtype=out_dtype,
                      device=a.device)
    _launch("grad_gemm", _lib().plip_grad_gemm, a.data_ptr(), b.data_ptr(),
            out.data_ptr(), M, N, K, rows, int(tn), int(out_dtype == torch.float32), code,
            a.device.index, _stream(a.device))
    return col_sum(out.view(splits, M * N)).view(M, N) if splits > 1 else out


def grad_gemm_nt(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """``a [M, K] . b [N, K]^T`` -> ``[M, N]`` in ``out_dtype`` (fp32 or a's
    dtype), fp32 accumulation. In bf16, K must be a multiple of 8."""
    if _on_cpu(a, "grad_gemm"):
        return grad_gemm_nt_reference(a, b, out_dtype)
    if out_dtype not in (torch.float32, a.dtype):
        raise ValueError(f"grad_gemm: output dtype {out_dtype} for {a.dtype} operands")
    (M, K), N = a.shape, b.shape[0]
    return _grad_gemm(a, b, M, N, K, False, out_dtype)


def grad_gemm_tn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [K, M]^T . b [K, N]`` -> fp32 ``[M, N]``: the sum over the K rows
    runs in the slices of ``tn_slices``, added by ``col_sum``. In bf16, M and
    N must be multiples of 8."""
    if _on_cpu(a, "grad_gemm"):
        return grad_gemm_tn_reference(a, b)
    (K, M), N = a.shape, b.shape[1]
    return _grad_gemm(a, b, M, N, K, True, torch.float32)


# ---------------------------------------------------------------------------
# attn_core_bwd
# ---------------------------------------------------------------------------


def _core_bwd_smem_bytes(S: int, D: int) -> int:
    """Shared memory of one block of attn_core_bwd's CUDA-core kernel
    (core_bwd_smem_bytes in the kernel), in fp32 whatever the dtype: k and v
    of the head (S rounded up to 16 rows), the q and g rows of a query tile
    (64 rows, or 32 past 64 tokens or 64 columns), each row D rounded up to
    4 and padded to an odd count of 16-byte units; e_c and ds_u of the tile
    over the keys (plus 4); the tile's denominators. The wgmma kernel's
    (head_dim 64, S <= 128) always fits."""
    nk, dp = -(-S // 16) * 16, -(-D // 4) * 4
    ldk = dp if (dp // 4) % 2 else dp + 4
    qt = 64 if S <= 64 and dp <= 64 else 32
    return 4 * (2 * nk * ldk + 2 * qt * ldk + 2 * qt * (nk + 4) + qt)


def _check_bwd_geometry(N: int, S: int, W: int, heads: int, s_valid: Optional[int],
                        dtype: torch.dtype = torch.float32) -> str:
    """The geometry checks of attn_core_bwd; returns its route."""
    _check_geometry(N, S, W, heads, s_valid, max_seq=MAX_SEQ, name="attn_core_bwd")
    return core_route(S, W // heads, dtype, backward=True)


def attn_core_bwd_reference(qkv2: torch.Tensor, dctx2: torch.Tensor, S: int,
                            heads: int, causal: bool = False,
                            s_valid: Optional[int] = None):
    """``qkv [B*S, 3W]`` and ``dctx [B*S, W]`` -> (``ctx [B*S, W]``, ``dqkv
    [B*S, 3W]``) in qkv's dtype, through the pipelined schedule."""
    N, W3 = qkv2.shape
    W = W3 // 3
    D = W // heads
    B = N // S
    dt = qkv2.dtype
    scale = D ** -0.5
    q, k, v = qkv2.view(B, S, 3, heads, D).permute(2, 0, 3, 1, 4).float().unbind(0)
    g = dctx2.view(B, S, heads, D).transpose(1, 2).float()  # [B, H, S, D]
    keep = keep_mask(S, causal, s_valid, qkv2.device)
    logits = (q @ k.transpose(-1, -2) * scale).masked_fill(~keep, float("-inf"))
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    denom = e.sum(-1, keepdim=True)
    e_c = e.to(dt).float()
    ctx = (e_c @ v / denom).to(dt)
    ghn = (g / denom).to(dt).float()
    dv = (e_c.transpose(-1, -2) @ ghn).to(dt)
    dp = g @ v.transpose(-1, -2)
    dsum = (dp * e).sum(-1, keepdim=True)
    ds = (e * (dp - dsum / denom)).to(dt).float()
    dq = (ds @ k * scale / denom).to(dt)
    qn = (q / denom).to(dt).float()
    dk = (ds.transpose(-1, -2) @ qn * scale).to(dt)
    dqkv = torch.stack([dq, dk, dv], 2)  # [B, H, 3, S, D]
    return (ctx.transpose(1, 2).reshape(N, W),
            dqkv.permute(0, 3, 2, 1, 4).reshape(N, W3))


def attn_core_bwd(qkv2: torch.Tensor, dctx2: torch.Tensor, S: int, heads: int,
                  causal: bool = False, s_valid: Optional[int] = None):
    """Backward of the masked multi-head attention core: the context of
    ``qkv2 [B*S, 3W]`` (recomputed) and dqkv from ``dctx2 [B*S, W]``."""
    if _on_cpu(qkv2, "attn_core_bwd"):
        return attn_core_bwd_reference(qkv2, dctx2, S, heads, causal, s_valid)
    code = _dtype_code("attn_core_bwd", qkv2)
    N, W3 = qkv2.shape
    W = W3 // 3
    route = _check_bwd_geometry(N, S, W, heads, s_valid, qkv2.dtype)
    if route == "one_block":
        smem = _core_bwd_smem_bytes(S, W // heads)
        if smem > MAX_SMEM:
            raise ValueError(f"attn_core_bwd: S={S}, head_dim={W // heads} needs {smem} "
                             f"bytes of shared memory, more than {MAX_SMEM}")
    align16 = wgmma_head(qkv2.dtype, W // heads)
    _check("attn_core_bwd qkv", qkv2, qkv2.device, qkv2.dtype, (N, 3 * W), align16=align16)
    _check("attn_core_bwd dctx", dctx2, qkv2.device, qkv2.dtype, (N, W), align16=align16)
    ctx = torch.empty((N, W), dtype=qkv2.dtype, device=qkv2.device)
    dqkv = torch.empty_like(qkv2)
    geometry = (N // S, S, heads, W // heads, int(causal), S if s_valid is None else s_valid)
    tail = (code, qkv2.device.index, _stream(qkv2.device))
    if route == "tiled":  # per-row fp32 statistics in a scratch buffer
        stats = torch.empty((3, N // S, heads, S), dtype=torch.float32, device=qkv2.device)
        _launch("attn_core_bwd", _lib().plip_attn_core_bwd_tiled, qkv2.data_ptr(),
                dctx2.data_ptr(), ctx.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
                *geometry, *tiled_plan(S, W // heads, backward=True), *tail)
    else:
        _launch("attn_core_bwd", _lib().plip_attn_core_bwd, qkv2.data_ptr(),
                dctx2.data_ptr(), ctx.data_ptr(), dqkv.data_ptr(), *geometry, *tail)
    return ctx, dqkv


# ---------------------------------------------------------------------------
# ln_bwd_rows
# ---------------------------------------------------------------------------


def ln_bwd_split(N: int, W: int, sms: int = H100_SMS) -> int:
    """The rows each block of ``ln_bwd_rows`` takes (the last the rest), one
    partial row of dgamma/dbeta a block: N split over the blocks the card
    holds at once (``LN_BWD_BLOCKS_PER_SM`` an SM, one past the widths whose
    lanes hold more than ``LN_BWD_MAX_VALUES`` values), so the partial has
    about that many rows at any N."""
    per_sm = LN_BWD_BLOCKS_PER_SM if W <= 256 * LN_BWD_MAX_VALUES else 1
    return -(-N // (per_sm * sms))


def ln_bwd_rows_reference(x2: torch.Tensor, dln: torch.Tensor, g2: Optional[torch.Tensor],
                          scale: torch.Tensor, eps: float = 1e-5):
    """(``dx = g + cast(dx_ln)``, or ``cast(dx_ln)`` without ``g2``; fp32
    partials ``[blocks, 2W]`` of ``[sum dln * xhat | sum dln]`` over the rows
    of each block of ``ln_bwd_split``, on the card's SMs or an H100's)."""
    N, W = x2.shape
    x32, dln = x2.float(), dln.float()
    mean = x32.mean(-1, keepdim=True)
    rstd = torch.rsqrt((x32 - mean).square().mean(-1, keepdim=True) + eps)
    xhat = (x32 - mean) * rstd
    dxhat = dln * scale
    dx_ln = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                    - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    dx = dx_ln.to(x2.dtype) if g2 is None else g2 + dx_ln.to(g2.dtype)
    rows = ln_bwd_split(N, W, _sm_count(x2.device) if x2.is_cuda else H100_SMS)
    sums = torch.cat([dln * xhat, dln], 1)
    sums = torch.nn.functional.pad(sums, (0, 0, 0, (-N) % rows))
    return dx, sums.view(-1, rows, 2 * W).sum(1)


def ln_bwd_rows(x2: torch.Tensor, dln: torch.Tensor, g2: Optional[torch.Tensor],
                scale: torch.Tensor, eps: float = 1e-5, layout: Optional[LnLayout] = None):
    """LayerNorm backward of each row of ``x2 [N, W]`` given ``dln`` (fp32, or
    x2's dtype: it is converted in the kernel's registers) and ``scale``
    (fp32 gamma), plus the residual grad ``g2`` (x2's dtype) where given:
    (dx in x2's dtype, fp32 partial sums of dgamma and dbeta, one row per
    block of ``ln_bwd_split``'s rows). ``layout``: ``ln_layout``'s with
    ``LN_BWD_MAX_VALUES`` by default (tests and tuning force others)."""
    if _on_cpu(x2, "ln_bwd_rows"):
        return ln_bwd_rows_reference(x2, dln, g2, scale, eps)
    code = _dtype_code("ln_bwd_rows", x2)
    N, W = x2.shape
    if dln.dtype not in (torch.float32, x2.dtype):
        raise ValueError(f"ln_bwd_rows dln: dtype {dln.dtype}, expected float32 or {x2.dtype}")
    _check("ln_bwd_rows dln", dln, x2.device, dln.dtype, (N, W))
    if g2 is not None:
        _check("ln_bwd_rows g", g2, x2.device, x2.dtype, (N, W))
    _check("ln_bwd_rows scale", scale, x2.device, torch.float32, (W,))
    _check("ln_bwd_rows x", x2, x2.device, x2.dtype, (N, W))
    dx = torch.empty_like(x2)
    layout = layout or ln_layout(W, x2.element_size(), _aligned(x2, dln, g2),
                                 LN_BWD_MAX_VALUES)
    rows = ln_bwd_split(N, W, _sm_count(x2.device))
    partial = torch.empty((-(-N // rows), 2 * W), dtype=torch.float32, device=x2.device)
    _launch("ln_bwd_rows", _lib().plip_ln_bwd_rows, x2.data_ptr(), dln.data_ptr(),
            None if g2 is None else g2.data_ptr(), scale.data_ptr(), dx.data_ptr(),
            partial.data_ptr(), N, W, layout.vec, layout.values, layout.warps, rows, eps,
            code, int(dln.dtype == torch.float32), x2.device.index, _stream(x2.device))
    return dx, partial


# ---------------------------------------------------------------------------
# col_sum
# ---------------------------------------------------------------------------


class ColSumPlan(NamedTuple):
    vec: int         # columns a load: 16 bytes' worth, or fewer where C or the base need it
    ty: int          # rows a block reads at once (its lanes are 256 / ty across the strip)
    split_rows: int  # rows a block sums
    splits: int      # row splits (grid.y), added in index order
    strips: int      # column strips of 256 / ty * vec columns (grid.x)


@functools.lru_cache(maxsize=256)
def col_sum_plan(R: int, C: int, itemsize: int, address: int = 0,
                 sms: int = H100_SMS) -> ColSumPlan:
    """col_sum's grid for ``[R, C]`` of ``itemsize`` bytes at ``address``: the
    widest load (at most 16 bytes) that C and the base allow; ty doubled while
    each of its rows keeps ``COL_SUM_UNROLL`` loads of the column's rows in
    flight; then as many row splits (each with that many rows a thread, at
    most ``COL_SUM_MAX_SPLITS``) as bring the blocks to
    ``COL_SUM_BLOCKS_PER_SM`` an SM. Only ``address % 16`` matters."""
    vec = 16 // itemsize
    while C % vec or address % (vec * itemsize):
        vec //= 2
    ty = 1
    while ty < COL_SUM_ROWS and 2 * ty * COL_SUM_UNROLL <= R:
        ty *= 2
    strips = -(-C // (COL_SUM_THREADS // ty * vec))
    want = -(-COL_SUM_BLOCKS_PER_SM * sms // strips)
    splits = max(1, min(want, COL_SUM_MAX_SPLITS, R // (ty * COL_SUM_UNROLL)))
    split_rows = -(-R // splits)
    return ColSumPlan(vec, ty, split_rows, -(-R // split_rows), strips)


def _scratch(device, stream: ctypes.c_void_p, n: int):
    """col_sum's scratch on this stream, kept between calls (launches on one
    stream run in order): the split plans' fp32 partial sums (at least ``n``)
    and the strip counters (one per strip of a split plan, which has fewer
    strips than blocks on every SM; each launch leaves them zero)."""
    key = (device.index, stream.value)
    partial, counters = _col_sum_scratch.get(key, (None, None))
    if counters is None:
        counters = torch.zeros(COL_SUM_BLOCKS_PER_SM * _sm_count(device), dtype=torch.int32,
                               device=device)
    if partial is None or partial.numel() < n:
        partial = torch.empty(n, dtype=torch.float32, device=device)
    _col_sum_scratch[key] = partial, counters
    return partial, counters


def col_sum_reference(t: torch.Tensor) -> torch.Tensor:
    return t.float().sum(0)


def col_sum(t: torch.Tensor) -> torch.Tensor:
    """fp32 sums of the columns of ``t [R, C]`` (fp32 or bf16) -> ``[C]``,
    in ``col_sum_plan``'s fixed order (a rerun gives the same bits)."""
    if _on_cpu(t, "col_sum"):
        return col_sum_reference(t)
    code = _dtype_code("col_sum", t)
    if t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"col_sum: needs a contiguous [R, C] tensor, got shape "
                         f"{tuple(t.shape)}, strides {t.stride()}")
    # (this wrapper's host time sets a small call's time: it does no more
    # than it must)
    R, C = t.shape
    device, ptr = t.device, t.data_ptr()
    plan = col_sum_plan(R, C, t.element_size(), ptr % 16, _sm_count(device))
    out = torch.empty(C, dtype=torch.float32, device=device)
    stream = _stream(device)
    partial = counters = None
    if plan.splits > 1:
        partial, counters = (x.data_ptr() for x in _scratch(device, stream, plan.splits * C))
    _launch("col_sum", _lib().plip_col_sum, ptr, out.data_ptr(), partial, counters, R, C,
            plan.vec, plan.ty, plan.split_rows, code, device.index, stream)
    return out


# ---------------------------------------------------------------------------
# The sublayer backward
# ---------------------------------------------------------------------------


KERNEL_FNS = (ln_rows, gemm_bias_residual, attn_core_bwd, grad_gemm_nt, grad_gemm_tn,
              ln_bwd_rows, col_sum)
REFERENCE_FNS = (layer_norm_rows_reference, gemm_bias_residual_reference,
                 attn_core_bwd_reference, grad_gemm_nt_reference, grad_gemm_tn_reference,
                 ln_bwd_rows_reference, col_sum_reference)


def _sublayer_bwd(x2, g2, ln, attn, S, heads, causal, s_valid, eps, fns, qkv2=None,
                  tp=None):
    """K2's chain; K6's with the saved ``qkv2``: the dx chain, then the weight
    grads from the operands it emits (ln, ctx, dqkv). Under ``tp`` (``attn``
    this rank's shares, ``heads`` its heads) all of it is local but ``dln``,
    the fp32 sum over the tp group of the ranks' ``dqkv . Wqkv^T``, taken
    before the LN backward; dWqkv and dbqkv come out for this rank's
    columns, dWout for its rows, dbout and the LN grads whole on every
    rank."""
    ln_fn, gemm_fn, core_bwd_fn, nt_fn, tn_fn, ln_bwd_fn, sum_fn = fns
    W = x2.shape[1]
    dt = x2.dtype
    wqkv = attn["qkv"]["kernel"].to(dt)
    h = ln_fn(x2, ln["scale"], ln["bias"], eps)
    qkv = gemm_fn(h, wqkv, attn["qkv"]["bias"]) if qkv2 is None else qkv2
    dctx = nt_fn(g2, attn["out"]["kernel"].to(dt), dt)
    ctx, dqkv = core_bwd_fn(qkv, dctx, S, heads, causal, s_valid)
    dln = nt_fn(dqkv, wqkv, torch.float32)
    if tp is not None:
        tp.all_reduce_(dln)
    dx, partial = ln_bwd_fn(x2, dln, g2, ln["scale"], eps)
    dgb = sum_fn(partial)
    return dx, {"scale": dgb[:W], "bias": dgb[W:]}, {
        "qkv": {"kernel": tn_fn(h, dqkv), "bias": sum_fn(dqkv)},
        "out": {"kernel": tn_fn(ctx, g2), "bias": sum_fn(g2)}}


def _counted(name, x2, g2, ln, attn, S, heads, causal, s_valid, eps, qkv2=None, tp=None):
    """``_sublayer_bwd`` through the kernels on the card, where it raises
    before any launch for a geometry ``attn_core_bwd`` does not take and
    counts the call as ``name``; the plain versions on the CPU."""
    if _on_cpu(x2, name):
        return _sublayer_bwd(x2, g2, ln, attn, S, heads, causal, s_valid, eps, REFERENCE_FNS,
                             qkv2, tp)
    W_local = attn["out"]["kernel"].shape[0]  # heads * head_dim of this rank's heads
    _check_bwd_geometry(x2.shape[0], S, W_local, heads, s_valid, x2.dtype)
    out = _sublayer_bwd(x2, g2, ln, attn, S, heads, causal, s_valid, eps, KERNEL_FNS, qkv2,
                        tp)
    LAUNCHES[name] += 1
    return out


def attention_sublayer_bwd(x2: torch.Tensor, g2: torch.Tensor, ln: Mapping,
                           attn: Mapping, S: int, heads: int, causal: bool = False,
                           s_valid: Optional[int] = None, eps: float = 1e-5,
                           qkv2: Optional[torch.Tensor] = None, tp=None):
    """The sublayer's backward through the CUDA kernels (K2): from the flat
    input ``x2 [B*S, W]`` and output grad ``g2`` (both in the compute dtype)
    and the fp32 parameters (cast here), returns ``(dx2, dln, dattn)``:
    ``dx2`` in the compute dtype, the parameter grads fp32 in
    ``ln``/``attn``'s tree. ``qkv2 [B*S, 3W]``: the qkv the forward saved
    (``"dwsplit_saveqkv"``), read instead of recomputed. On the CPU it is
    ``attention_sublayer_bwd_reference``; on the card it raises before any
    launch for a geometry ``attn_core_bwd`` does not take. ``tp``: a
    ``parallel.distributed.TPGroup`` (``_sublayer_bwd``)."""
    return _counted("attention_sublayer_bwd", x2, g2, ln, attn, S, heads, causal, s_valid,
                    eps, qkv2, tp)


def attention_sublayer_bwd_split(x2: torch.Tensor, g2: torch.Tensor, ln: Mapping,
                                 attn: Mapping, S: int, heads: int, causal: bool = False,
                                 s_valid: Optional[int] = None, eps: float = 1e-5,
                                 qkv2: Optional[torch.Tensor] = None, tp=None):
    """K6: an alias of ``attention_sublayer_bwd`` (the module doc), counted
    under its own name so that a step shows which backward ran."""
    return _counted("attention_sublayer_bwd_split", x2, g2, ln, attn, S, heads, causal,
                    s_valid, eps, qkv2, tp)


def attention_sublayer_bwd_reference(x2: torch.Tensor, g2: torch.Tensor, ln: Mapping,
                                     attn: Mapping, S: int, heads: int,
                                     causal: bool = False, s_valid: Optional[int] = None,
                                     eps: float = 1e-5, qkv2: Optional[torch.Tensor] = None,
                                     tp=None):
    """The plain PyTorch version of ``attention_sublayer_bwd`` (and of its
    alias ``attention_sublayer_bwd_split``), on any device."""
    return _sublayer_bwd(x2, g2, ln, attn, S, heads, causal, s_valid, eps, REFERENCE_FNS,
                         qkv2, tp)


attention_sublayer_bwd_split_reference = attention_sublayer_bwd_reference
