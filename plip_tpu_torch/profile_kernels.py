"""K1's and K2's kernels in fp32 at the main path's shapes, on one CUDA card.

fp32 is the dtype ``PLIP`` and ``CLIPTuner`` take when the caller names none.
For each case below this prints the kernel's CUDA-event ms (30 calls, in
turns with its plain version: plain, kernel, kernel, plain), its device ms
(the kernel events' time under ``torch.profiler``), the plain version's ms,
the bound (the larger of its FLOPs at the 67 TFLOP/s of fp32 outside the
tensor cores and its bytes at 3.35 TB/s, H100 SXM; each input read once,
each output written once) and the CUDA-event and device ms of one PyTorch
call that computes the same function (a yardstick the port never calls:
``torch.addmm`` or ``torch.matmul`` with TF32 off, ``F.layer_norm``,
``F.scaled_dot_product_attention`` with the same mask and its autograd
backward, with the kernels SDPA ran). Then the launches of each kernel in
the fp32 path's runs: one ``PLIP("random:ViT-B/32")`` request of 64 tiles in
batches of 32 and one of 8 prompts, and one ``make_train_step`` step at
batch 128 (remat "mlp"). The last line is a JSON object of every row:

    python -m plip_tpu_torch.profile_kernels

Cases (ViT-B/32 unless named; M token rows):
- ``gemm_bias_residual``: the QKV product and the out-projection with its
  residual at vision W=768 (M = 1,600 and 12,800: batch 32 and 256) and text
  W=512 (M = 616 and 19,712: 8 and 256 prompts);
- ``attn_core``: vision S=50 at batch 32 and 256, text S=77 causal at batch
  32 (and with ``s_valid`` 70), ViT-B/16 vision S=197 at batch 32;
- ``ln_rows``: vision at batch 32 and 256;
- ``grad_gemm``: its four products at vision batch 128 (M = 6,400), each
  with the ``col_sum`` of its slices;
- ``attn_core_bwd``: vision at batch 32 and 128, text at batch 128.

``--ln`` takes the LayerNorm kernels instead (``LN_SHAPES``, bf16 and fp32,
without the path's launches): ``ln_rows``, ``ln_bwd_rows`` as K2 calls it
(dln fp32, the residual g) beside ``F.layer_norm``'s forward and its
autograd backward, and the towers' LayerNorm ``layer_norm_rows`` forward and
backward (``ln_rows``, ``ln_bwd_rows`` on the grad in the compute dtype,
``col_sum``) beside ``F.layer_norm``'s; each with the plain version's device
ms (the towers ran that composition before every LayerNorm went to the
kernels). ``--layouts`` adds a row for each register layout the kernels
take at those shapes (``ln_layout``'s warps a row and buckets), which is
how ``LN_MAX_VALUES`` and ``LN_BWD_MAX_VALUES`` were chosen:

    python -m plip_tpu_torch.profile_kernels --ln [--layouts]

``--tiled`` takes the key-tiled attention cores instead (``csrc/mha.cu``,
``csrc/mha_bwd.cu``; ``TILED_CASES``), without the path's launches: in fp32
at head_dim 64, ``mha_core`` (K3) and its backward (K4) at ViT-L/14 vision
batch 64, ``attn_core`` (K1's core past 256 tokens) at L/14 batch 64 and
@336 batch 32, ``flash_core`` (K5) and ``headgrid_core`` (K12) at @336 batch
32, ``attn_core_bwd`` (K2's core past 128) at L/14 batch 64, @336 batch 32
and ViT-B/16 batch 32; K3 and K4 at ViT-H/14's head_dim 80 in fp32; in bf16
at ViT-H/14's 80 and ViT-bigG/14's 104 (K3 and K4 at S=257, K5 and K2's
core at S=577). bf16 rows take their bound at 989 TFLOP/s (the tensor
cores), fp32 rows at 67. ``--only k1,k2`` keeps the cases of those kernels:

    python -m plip_tpu_torch.profile_kernels --tiled [--only mha_core]

``--preprocess`` takes K11 instead (``preprocess_batch(fused=True)``,
``csrc/preprocess.cu``; ``PREPROCESS_CASES``, random uint8 tiles, without
the path's launches: one a call): 256 tiles 256x256 -> 224 with fp32 and with
bf16 out, 300x400 -> 224, 1024x700 -> 224 and 256x256 -> 336, and 64 tiles
2048x2048 -> 224, each beside the plain path (the two-matmul
``preprocess_batch``, in the same dtype) in device ms. The bound is its bytes
(each byte of the input rectangle that the output depends on read once,
each output value written once) or its FLOPs
over each row's nonzero extent at 67 TFLOP/s; no one PyTorch call computes
the function (PIL's bicubic with its two uint8 stores, the crop and the
normalize), so there is no library column. Each row also prints the sha256
of the output's bytes, to hold two trees' kernels bit for bit:

    python -m plip_tpu_torch.profile_kernels --preprocess
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .ops import attention as att
from .ops import attention_bwd as bwd
from .ops import mha

# H100 SXM: fp32 outside the tensor cores, bf16 dense on them, HBM3
PEAK_FP32, PEAK_BF16, PEAK_BYTES = 67e12, 989e12, 3.35e12
ITERS = 30
PROFILE_TRIES = 4  # profiler windows a device_time may take (its doc)
WINDOWS = {"taken": 0, "short": 0, "refused": 0}  # device_time's profiler windows

# (label, W, token rows)
GEMM_CASES = (("vision W=768", 768, (1600, 12800)), ("text W=512", 512, (616, 19712)))
# (label, B, S, W, heads, causal, s_valid)
CORE_CASES = (("vision B=32", 32, 50, 768, 12, False, None),
              ("vision B=256", 256, 50, 768, 12, False, None),
              ("text B=32", 32, 77, 512, 8, True, None),
              ("text B=32 s_valid=70", 32, 77, 512, 8, True, 70),
              ("ViT-B/16 vision B=32", 32, 197, 768, 12, False, None))
LN_CASES = (("vision B=32", 1600, 768), ("vision B=256", 12800, 768))
# --ln: ViT-B/32 vision at batch 32 and 128, text at batch 128 (the "mlp"
# step's rows)
LN_SHAPES = (("vision B=32", 1600, 768), ("vision B=128", 6400, 768),
             ("text B=128", 9856, 512))
GRAD_GEMM_CASE = ("vision B=128", 6400, 768)
CORE_BWD_CASES = (("vision B=32", 32, 50, 768, 12, False, None),
                  ("vision B=128", 128, 50, 768, 12, False, None),
                  ("text B=128", 128, 77, 512, 8, True, None))
# The key-tiled cores (--tiled): (kernel, label, dtype, B, S, W, heads)
F32, BF16 = torch.float32, torch.bfloat16
TILED_CASES = (("mha_core", "ViT-L/14 B=64", F32, 64, 257, 1024, 16),
               ("attn_core", "ViT-L/14 B=64", F32, 64, 257, 1024, 16),
               ("attn_core", "ViT-L/14@336px B=32", F32, 32, 577, 1024, 16),
               ("flash_core", "ViT-L/14@336px B=32", F32, 32, 577, 1024, 16),
               ("headgrid_core", "ViT-L/14@336px B=32", F32, 32, 577, 1024, 16),
               ("mha_core_bwd", "ViT-L/14 B=64", F32, 64, 257, 1024, 16),
               ("attn_core_bwd", "ViT-L/14 B=64", F32, 64, 257, 1024, 16),
               ("attn_core_bwd", "ViT-L/14@336px B=32", F32, 32, 577, 1024, 16),
               ("attn_core_bwd", "ViT-B/16 B=32", F32, 32, 197, 768, 12),
               ("mha_core", "ViT-H/14 B=8 head_dim 80", F32, 8, 257, 1280, 16),
               ("mha_core_bwd", "ViT-H/14 B=8 head_dim 80", F32, 8, 257, 1280, 16),
               ("mha_core", "ViT-H/14 B=8 head_dim 80", BF16, 8, 257, 1280, 16),
               ("mha_core_bwd", "ViT-H/14 B=8 head_dim 80", BF16, 8, 257, 1280, 16),
               ("mha_core", "ViT-bigG/14 B=4 head_dim 104", BF16, 4, 257, 1664, 16),
               ("mha_core_bwd", "ViT-bigG/14 B=4 head_dim 104", BF16, 4, 257, 1664, 16),
               ("flash_core", "ViT-bigG/14@336px B=2 head_dim 104", BF16, 2, 577, 1664, 16),
               ("attn_core_bwd", "ViT-bigG/14@336px B=2 head_dim 104", BF16, 2, 577, 1664,
                16))
# --preprocess: K11 at (tiles, H, W, out, dtype)
PREPROCESS_CASES = ((256, 256, 256, 224, F32), (256, 256, 256, 224, BF16),
                    (256, 300, 400, 224, F32), (256, 1024, 700, 224, F32),
                    (256, 256, 256, 336, F32), (64, 2048, 2048, 224, F32))


@dataclass
class Case:
    kernel: str  # the wrapper's name in LAUNCHES
    label: str
    fn: Callable
    plain: Callable
    library: Optional[Callable]  # None: no one PyTorch call computes the function
    library_name: str
    flops: float
    nbytes: float
    peak: float = PEAK_FP32  # the FLOP rate of the bound
    dtype: torch.dtype = torch.float32


def time_ms(fn, iters: int = ITERS, warmup: int = 3) -> float:
    """CUDA-event ms of one call of fn, over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_time(fn, iters: int = 20):
    """(device ms of one call of fn: its kernels' own time under
    torch.profiler, averaged over ``iters`` calls; the names of those
    kernels). Unlike ``time_ms`` it leaves out the host's time between
    launches, which sets the CUDA-event time of a call that is shorter than
    its launch.

    A window may come back short of some of its device records, and now and
    then of all of them (seen on an H100), so each kernel counts as its
    records' mean time times its launches a call (its records over the
    calls, rounded), not as their sum over the calls. A window with fewer
    records than half the calls is taken again, up to ``PROFILE_TRIES``
    times; if none holds that many the time is NaN, "not measured", never 0.
    ``WINDOWS`` counts the windows taken, those with fewer records than
    calls, and those refused for fewer than half."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name: dict = {}  # kernel name: (records, us)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                n, us = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        records = sum(n for n, _ in by_name.values())
        WINDOWS["taken"] += 1
        WINDOWS["short"] += records < iters
        if 2 * records >= iters:
            return (sum(us / n * max(1, round(n / iters)) for n, us in by_name.values()) / 1e3,
                    sorted({name[:60] for name in by_name}))
        WINDOWS["refused"] += 1
    return float("nan"), []


def device_ms(fn, iters: int = 20) -> float:
    """``device_time``'s ms alone."""
    return device_time(fn, iters)[0]


def in_turns(kernel_fn, plain_fn, iters: int = ITERS):
    """(kernel ms, plain ms): plain, kernel, kernel, plain; the means."""
    p1, k1, k2, p2 = (time_ms(f, iters) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn))
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(flops: float, nbytes: float, peak: float):
    """(the least ms the card could take, what sets it): the larger of the
    FLOPs at ``peak`` and the bytes at the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sdpa_mask(S: int, causal: bool, s_valid: Optional[int], device):
    """The keep mask as SDPA takes it (None where every pair is kept)."""
    if not causal and (s_valid is None or s_valid == S):
        return None
    return att.keep_mask(S, causal, s_valid, device)


def qkv_heads(qkv, B, S, heads):
    """q, k, v ``[B, heads, S, D]`` views of qkv."""
    return qkv.reshape(B, S, 3, heads, -1).permute(2, 0, 3, 1, 4).unbind(0)


def sdpa_forward(qkv, B, S, heads, mask=None):
    q, k, v = qkv_heads(qkv, B, S, heads)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def sdpa_backward(qkv, g, B, S, heads, mask=None):
    """The autograd backward of SDPA on qkv (its forward run once, outside)."""
    q, k, v = (t.detach().requires_grad_() for t in qkv_heads(qkv, B, S, heads))
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    go = g.reshape(B, S, heads, -1).transpose(1, 2)
    return lambda: torch.autograd.grad(out, (q, k, v), go, retain_graph=True)


def kept_pairs(S: int, causal: bool, s_valid: Optional[int]) -> int:
    return int(att.keep_mask(S, causal, s_valid, "cpu").sum())


def cases(device, gen: torch.Generator, dtype=torch.float32) -> list:
    """Every case of the module doc, its inputs made from ``gen``."""
    it = torch.tensor([], dtype=dtype).element_size()

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to(device, dtype)

    def bias(n):
        return (torch.randn(n, generator=gen) * 0.02).to(device)

    out = []
    for label, W, rows in GEMM_CASES:
        wqkv, wout = rnd(W, 3 * W, std=W ** -0.5), rnd(W, W, std=W ** -0.5)
        bqkv, bout = bias(3 * W), bias(W)
        for M in rows:
            h, ctx, x = rnd(M, W), rnd(M, W), rnd(M, W)
            out.append(Case(
                "gemm_bias_residual", f"qkv {label} M={M}",
                lambda h=h, w=wqkv, b=bqkv: att.gemm_bias_residual(h, w, b),
                lambda h=h, w=wqkv, b=bqkv: att.gemm_bias_residual_reference(h, w, b),
                lambda h=h, w=wqkv, b=bqkv: torch.addmm(b.to(dtype), h, w), "torch.addmm",
                2 * M * W * 3 * W, it * (M * W + 3 * W * W + 3 * M * W) + 4 * 3 * W))
            out.append(Case(
                "gemm_bias_residual", f"out-projection + R {label} M={M}",
                lambda c=ctx, w=wout, b=bout, x=x: att.gemm_bias_residual(c, w, b, x),
                lambda c=ctx, w=wout, b=bout, x=x: att.gemm_bias_residual_reference(c, w, b,
                                                                                    x),
                lambda c=ctx, w=wout, b=bout: torch.addmm(b.to(dtype), c, w), "torch.addmm",
                2 * M * W * W, it * (M * W + W * W + 2 * M * W) + 4 * W))
    for label, B, S, W, heads, causal, s_valid in CORE_CASES:
        qkv = rnd(B * S, 3 * W)
        args = (S, heads, causal, s_valid)
        mask = sdpa_mask(S, causal, s_valid, device)
        out.append(Case(
            "attn_core", f"{label} S={S}{' causal' if causal else ''}",
            lambda q=qkv, a=args: att.attn_core(q, *a),
            lambda q=qkv, a=args: att.attn_core_reference(q, *a),
            sdpa_forward(qkv, B, S, heads, mask), "SDPA",
            4 * B * kept_pairs(S, causal, s_valid) * W, it * 4 * B * S * W))
    for label, N, W in LN_CASES:
        x = rnd(N, W)
        s, b = 1 + bias(W), bias(W)
        out.append(Case(
            "ln_rows", f"{label} [{N}, {W}]",
            lambda x=x, s=s, b=b: att.ln_rows(x, s, b),
            lambda x=x, s=s, b=b: att.layer_norm_rows_reference(x, s, b),
            lambda x=x, s=s, b=b, W=W: F.layer_norm(x, (W,), s.to(dtype), b.to(dtype)),
            "F.layer_norm", 8 * N * W, it * 2 * N * W + 4 * 2 * W))
    label, N, W = GRAD_GEMM_CASE
    g, ctx, h, dqkv = rnd(N, W), rnd(N, W), rnd(N, W), rnd(N, 3 * W)
    wout, wqkv = rnd(W, W, std=W ** -0.5), rnd(W, 3 * W, std=W ** -0.5)
    products = (  # (label, kernel, plain, torch.matmul, M, N, K)
        ("NT dctx = g . Wout^T", lambda: bwd.grad_gemm_nt(g, wout, dtype),
         lambda: bwd.grad_gemm_nt_reference(g, wout, dtype), lambda: torch.matmul(g, wout.t()),
         N, W, W),
        ("NT dln = dqkv . Wqkv^T", lambda: bwd.grad_gemm_nt(dqkv, wqkv, torch.float32),
         lambda: bwd.grad_gemm_nt_reference(dqkv, wqkv, torch.float32),
         lambda: torch.matmul(dqkv, wqkv.t()), N, W, 3 * W),
        ("TN dWout = ctx^T . g", lambda: bwd.grad_gemm_tn(ctx, g),
         lambda: bwd.grad_gemm_tn_reference(ctx, g), lambda: torch.matmul(ctx.t(), g),
         W, W, N),
        ("TN dWqkv = ln^T . dqkv", lambda: bwd.grad_gemm_tn(h, dqkv),
         lambda: bwd.grad_gemm_tn_reference(h, dqkv), lambda: torch.matmul(h.t(), dqkv),
         W, 3 * W, N),
    )
    for plabel, fn, plain, library, M_, N_, K_ in products:
        out.append(Case("grad_gemm", f"{plabel} {label}", fn, plain, library, "torch.matmul",
                        2 * M_ * N_ * K_, it * (M_ + N_) * K_ + 4 * M_ * N_))
    for label, B, S, W, heads, causal, s_valid in CORE_BWD_CASES:
        qkv, dctx = rnd(B * S, 3 * W), rnd(B * S, W)
        args = (S, heads, causal, s_valid)
        mask = sdpa_mask(S, causal, s_valid, device)
        out.append(Case(
            "attn_core_bwd", f"{label} S={S}{' causal' if causal else ''}",
            lambda q=qkv, d=dctx, a=args: bwd.attn_core_bwd(q, d, *a),
            lambda q=qkv, d=dctx, a=args: bwd.attn_core_bwd_reference(q, d, *a),
            sdpa_backward(qkv, dctx, B, S, heads, mask), "SDPA backward",
            2 * 6 * kept_pairs(S, causal, s_valid) * B * W, it * 8 * B * S * W))
    return out


def tiled_cases(device, gen: torch.Generator) -> list:
    """The key-tiled cores of ``TILED_CASES`` (module doc), inputs from
    ``gen``. FLOPs: 4 (forward), 10 (K4: q.k^T, dp and the three grads) or 12
    (K2's core, which recomputes the context too) times the kept (row, key)
    pairs and head_dim of every (sequence, head); bytes: qkv and g read,
    ctx and dqkv written."""
    out = []
    for kernel, label, dtype, B, S, W, heads in TILED_CASES:
        it = torch.tensor([], dtype=dtype).element_size()
        qkv = torch.randn(B * S, 3 * W, generator=gen).to(device, dtype)
        g = torch.randn(B * S, W, generator=gen).to(device, dtype)
        work = B * S * S * W  # (row, key) pairs times head_dim over the heads: no mask
        peak = PEAK_FP32 if dtype == torch.float32 else PEAK_BF16
        tag = f"{label} S={S} {str(dtype)[6:]}"
        if kernel == "attn_core":
            fn = lambda q=qkv, S=S, h=heads: att.attn_core(q, S, h)
            plain = lambda q=qkv, S=S, h=heads: att.attn_core_reference(q, S, h)
        elif kernel == "attn_core_bwd":
            fn = lambda q=qkv, g=g, S=S, h=heads: bwd.attn_core_bwd(q, g, S, h)
            plain = lambda q=qkv, g=g, S=S, h=heads: bwd.attn_core_bwd_reference(q, g, S, h)
        elif kernel == "mha_core_bwd":
            fn = lambda q=qkv, g=g, S=S, h=heads: mha.mha_core_bwd(q, g, S, h)
            plain = lambda q=qkv, g=g, S=S, h=heads: mha.mha_core_bwd_reference(q, g, S, h)
        else:  # the composed cores' forwards
            fn = lambda q=qkv, S=S, h=heads, k=kernel: getattr(mha, k)(q, S, h)
            plain = lambda q=qkv, S=S, h=heads, k=kernel: getattr(mha, f"{k}_reference")(q, S, h)
        if kernel.endswith("_bwd"):
            out.append(Case(kernel, tag, fn, plain, sdpa_backward(qkv, g, B, S, heads),
                            "SDPA backward", (12 if kernel == "attn_core_bwd" else 10) * work,
                            it * (8 if kernel == "attn_core_bwd" else 7) * B * S * W, peak,
                            dtype))
        else:
            out.append(Case(kernel, tag, fn, plain, sdpa_forward(qkv, B, S, heads), "SDPA",
                            4 * work, it * 4 * B * S * W, peak, dtype))
    return out


def preprocess_work(tiles: int, h: int, w: int, out: int, out_bytes: int):
    """(FLOPs, bytes) of K11 on ``tiles`` h x w images to out x out: the
    multiply-adds over each resize row's nonzero extent (the width pass over
    the input rows the output needs); each byte of the input rectangle that
    the output depends on (the crop's support) read once and each output
    value written once."""
    from .ops.preprocess_fused import _extents
    from .ops.resize import resize_crop_matrices

    R, C = resize_crop_matrices(h, w, out, out)
    (r_lo, r_hi), (c_lo, c_hi) = _extents(R), _extents(C)
    rows, cols = int(r_hi.max() - r_lo.min()), int(c_hi.max() - c_lo.min())
    flops = 2 * tiles * 3 * (rows * int((c_hi - c_lo).sum()) + out * int((r_hi - r_lo).sum()))
    return flops, tiles * (rows * cols * 3 + out * out * 3 * out_bytes)


def preprocess_case(imgs: torch.Tensor, out: int, dtype: torch.dtype) -> Case:
    """K11 on ``imgs`` (uint8 [B, H, W, 3]) to ``out`` in ``dtype``, beside
    the plain path."""
    from .ops import preprocess as pre

    B, h, w, _ = imgs.shape
    return Case("preprocess_fused", f"{B} tiles {h}x{w} -> {out} {str(dtype)[6:]} out",
                lambda: pre.preprocess_batch(imgs, out, fused=True, dtype=dtype),
                lambda: pre.preprocess_batch(imgs, out, dtype=dtype), None,
                "none (no one call computes it)",
                *preprocess_work(B, h, w, out, dtype.itemsize), PEAK_FP32, dtype)


def preprocess_cases(device, seed: int = 0, tiles: Optional[int] = None) -> list:
    """``PREPROCESS_CASES`` on random tiles made on ``device`` from ``seed``;
    ``tiles`` in place of each case's count."""
    out = []
    for n, h, w, size, dtype in PREPROCESS_CASES:
        gen = torch.Generator(device).manual_seed(seed)
        imgs = torch.randint(0, 256, (tiles or n, h, w, 3), dtype=torch.uint8, device=device,
                             generator=gen)
        out.append(preprocess_case(imgs, size, dtype))
    return out


def library_sass(pattern: str, arch: str = "sm_90") -> dict:
    """{kernel: (HMMA, FFMA instruction counts, the HMMA forms)} in the
    ``arch`` SASS of the kernels of PyTorch's CUDA library whose names hold
    ``pattern`` (``cuobjdump -sass -fun`` on ``libtorch_cuda.so``): whether a
    library call runs on the tensor cores or the FMA pipes, e.g. fp32 SDPA's
    ``fmha_cutlassF_f32``."""
    import glob
    import os

    from .ops._build import _toolkit_binary

    lib = glob.glob(os.path.join(os.path.dirname(torch.__file__), "lib", "libtorch_cuda.so"))[0]
    tool = _toolkit_binary("cuobjdump")
    sections = subprocess.run([tool, "--list-text", lib], capture_output=True, text=True,
                              check=True).stdout
    names = sorted({sec[2:sec.index(f".{arch}.")] for sec in
                    (line.split(":")[-1].strip() for line in sections.splitlines())
                    if pattern in sec and f".{arch}." in sec})
    found = {}
    for name in names:
        sass = subprocess.run([tool, "-sass", "-fun", name, lib], capture_output=True,
                              text=True).stdout
        ops, mine = [], False
        for line in sass.splitlines():
            if line.strip().startswith("arch = "):
                mine = line.strip() == f"arch = {arch}"
            elif mine and "*/" in line:
                words = line.split("*/", 1)[1].split()
                ops += words[:1]
        hmma = sorted({op for op in ops if op.startswith("HMMA")})
        found[name] = (sum(op.startswith("HMMA") for op in ops),
                       sum(op.startswith("FFMA") for op in ops), hmma)
    return found


def layer_norm_backward(x, scale, bias, dy):
    """The autograd backward of ``F.layer_norm`` in x's dtype (its forward run
    once, outside)."""
    xl = x.detach().requires_grad_()
    w, b = (t.to(x.dtype).requires_grad_() for t in (scale, bias))
    y = F.layer_norm(xl, (x.shape[-1],), w, b)
    return lambda: torch.autograd.grad(y, (xl, w, b), dy.to(x.dtype), retain_graph=True)


def forward_backward(fn, x, scale, bias, dy):
    """One forward and autograd backward of a LayerNorm ``fn(x, scale, bias)``."""
    def run():
        xl, s, b = (t.detach().requires_grad_() for t in (x, scale, bias))
        torch.autograd.grad(fn(xl, s, b), (xl, s, b), dy)
    return run


def ln_cases(device, gen: torch.Generator, layouts: bool = False) -> list:
    """The LayerNorm rows of ``--ln`` (module doc), inputs from ``gen``; with
    ``layouts`` also each register layout at every shape. Bytes: each input
    read once and each output written once (dgamma and dbeta, not the
    partial rows that hold them on the way)."""
    out = []
    for dtype in (BF16, F32):
        it = torch.tensor([], dtype=dtype).element_size()
        for label, N, W in LN_SHAPES:
            x = (torch.randn(N, W, generator=gen) * 2 + 0.5).to(device, dtype)
            dln = torch.randn(N, W, generator=gen).to(device)
            g, dy = (torch.randn(N, W, generator=gen).to(device, dtype) for _ in range(2))
            s = (1 + 0.1 * torch.randn(W, generator=gen)).to(device)
            b = (0.1 * torch.randn(W, generator=gen)).to(device)
            tag = f"{label} [{N}, {W}] {str(dtype)[6:]}"
            fwd_bytes, bwd_bytes = it * 2 * N * W + 8 * W, (3 * it + 4) * N * W + 12 * W
            fwd_lib = lambda x=x, s=s, b=b, W=W, dt=dtype: F.layer_norm(  # noqa: E731
                x, (W,), s.to(dt), b.to(dt))
            out.append(Case("ln_rows", tag, lambda x=x, s=s, b=b: att.ln_rows(x, s, b),
                            lambda x=x, s=s, b=b: att.layer_norm_rows_reference(x, s, b),
                            fwd_lib, "F.layer_norm", 8 * N * W, fwd_bytes, dtype=dtype))
            out.append(Case(
                "ln_bwd_rows", f"{tag} (dln fp32, + g)",
                lambda x=x, d=dln, g=g, s=s: bwd.ln_bwd_rows(x, d, g, s),
                lambda x=x, d=dln, g=g, s=s: bwd.ln_bwd_rows_reference(x, d, g, s),
                layer_norm_backward(x, s, b, dln), "F.layer_norm backward", 12 * N * W,
                bwd_bytes, dtype=dtype))
            if hasattr(att, "layer_norm_rows"):  # the towers' LayerNorm, this tree on
                out.append(Case(
                    "layer_norm_rows", f"{tag} forward + backward",
                    forward_backward(att.layer_norm_rows, x, s, b, dy),
                    forward_backward(att.layer_norm_rows_reference, x, s, b, dy),
                    forward_backward(lambda x, s, b, W=W: F.layer_norm(x, (W,), s, b),
                                     x, s.to(dtype), b.to(dtype), dy),
                    "F.layer_norm + backward", 20 * N * W,
                    it * 5 * N * W + 16 * W, dtype=dtype))
            if not layouts:
                continue
            for kernel, cap in (("ln_rows", att.LN_MAX_VALUES),
                                ("ln_bwd_rows", bwd.LN_BWD_MAX_VALUES)):
                for lay in layout_choices(W, it):
                    fn = ((lambda x=x, s=s, b=b, lay=lay: att.ln_rows(x, s, b, layout=lay))
                          if kernel == "ln_rows" else
                          (lambda x=x, d=dln, g=g, s=s, lay=lay:
                           bwd.ln_bwd_rows(x, d, g, s, layout=lay)))
                    planned = lay == att.ln_layout(W, it, True, cap)
                    out.append(Case(kernel, f"{tag} layout {tuple(lay)}"
                                    f"{' (planned)' if planned else ''}", fn, fn, fwd_lib,
                                    "F.layer_norm", 8 * N * W,
                                    fwd_bytes if kernel == "ln_rows" else bwd_bytes,
                                    dtype=dtype))
    return out


def layout_choices(W: int, itemsize: int) -> list:
    """Every 16-byte-load layout of the LayerNorm kernels at width W: each
    warps a row with the smallest bucket that holds the row."""
    vec, out = 16 // itemsize, []
    for warps in (1, 2, 4, 8):
        need = -(-(W // vec) // (32 * warps)) * vec
        out += [att.LnLayout(vec, warps, b) for b in att.LN_BUCKETS if b >= need][:1]
    return out


def measure(case: Case, plain_device: bool = False) -> dict:
    """One row: the kernel and its plain version in turns, device ms, bound
    and the PyTorch call; ``plain_device``: the plain version's device ms
    too."""
    ms, plain_ms = in_turns(case.fn, case.plain)
    dev = device_ms(case.fn)
    plain_dev = device_ms(case.plain) if plain_device else float("nan")
    library_ms, library_dev, library_kernels = None, None, []
    if case.library is not None:
        library_ms = time_ms(case.library)
        library_dev, library_kernels = device_time(case.library)
    bound_ms, bound_by = bound(case.flops, case.nbytes, case.peak)
    return {"kernel": case.kernel, "case": case.label, "ms": ms, "device_ms": dev,
            "plain_ms": plain_ms, "plain_device_ms": plain_dev, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "tflops": case.flops / ms / 1e9, "bound_share": bound_ms / ms,
            "library": case.library_name, "library_ms": library_ms,
            "library_device_ms": library_dev, "library_kernels": library_kernels}


def path_launches(device, arch: str = "ViT-B/32", tiles: int = 64, batch: int = 32,
                  train_batch: int = 128) -> dict:
    """Launches of each K1 and K2 kernel in the fp32 path's runs (module doc)."""
    from .api import PLIP
    from .models.clip import CLIP
    from .models.config import ARCHITECTURES
    from .tokenizer import default_tokenizer
    from .train.contrastive import init_train_state, make_optimizer, make_train_step

    model = PLIP(f"random:{arch}", dtype=torch.float32, device=device)
    images = np.random.default_rng(0).integers(0, 256, (tiles, 256, 256, 3), np.uint8)
    prompts = [f"an H&E image of tissue {i}" for i in range(8)]
    out = {}
    for label, fn in ((f"encode_images, {tiles} tiles in batches of {batch}",
                       lambda: model.encode_images(list(images), batch_size=batch)),
                      ("encode_text, 8 prompts", lambda: model.encode_text(prompts))):
        att.reset_launch_counts()
        fn()
        out[label] = dict(att.LAUNCHES)
    del model

    cfg = ARCHITECTURES[arch]()
    clip = CLIP(cfg).init_params(torch.Generator().manual_seed(0)).to(device)
    side = cfg.vision.image_size
    rng = np.random.default_rng(1)
    pixels = torch.from_numpy(rng.standard_normal((train_batch, side, side, 3),
                                                  np.float32)).to(device)
    captions = [f"an H&E image of tissue, case {i}" for i in range(train_batch)]
    ids = torch.as_tensor(default_tokenizer().tokenize(captions, cfg.text.context_length),
                          dtype=torch.long, device=device)
    opt = make_optimizer(base_lr=1e-6, warmup=1, total_steps=10)
    step = make_train_step(cfg, opt, dtype=torch.float32, remat="mlp")
    state = init_train_state(clip, opt)
    att.reset_launch_counts()
    bwd.reset_launch_counts()
    step(state, pixels, ids)
    out[f"train step, batch {train_batch}, remat mlp"] = {**att.LAUNCHES, **bwd.LAUNCHES}
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tiled", action="store_true",
                        help="the key-tiled cores (TILED_CASES) instead, no launches")
    parser.add_argument("--ln", action="store_true",
                        help="the LayerNorm kernels (LN_SHAPES) instead, no launches")
    parser.add_argument("--preprocess", action="store_true",
                        help="K11 (PREPROCESS_CASES) instead, no launches")
    parser.add_argument("--layouts", action="store_true",
                        help="with --ln: a row for every register layout")
    parser.add_argument("--only", default="", help="comma-separated kernel names to keep")
    parser.add_argument("--sass", default="",
                        help="print the HMMA and FFMA counts of the library kernels whose "
                             "names hold this (e.g. fmha_cutlassF_f32) and stop")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    if args.sass:
        for name, (hmma, ffma, forms) in library_sass(args.sass).items():
            print(f"HMMA {hmma:5d} FFMA {ffma:5d} {' '.join(forms)}  {name[:90]}")
        return
    rows = []
    only = set(filter(None, args.only.split(",")))
    gen = torch.Generator().manual_seed(0)
    if args.ln:
        case_list = ln_cases("cuda", gen, args.layouts)
    elif args.preprocess:
        case_list = preprocess_cases("cuda")
    else:
        case_list = (tiled_cases if args.tiled else cases)("cuda", gen)
    for case in case_list:
        if only and case.kernel not in only:
            continue
        row = measure(case, plain_device=(args.ln and "layout" not in case.label)
                      or args.preprocess)
        rows.append(row)
        library = "none" if row["library_ms"] is None else (
            f"{row['library_ms']:.4f} (device {row['library_device_ms']:.4f}: "
            f"{', '.join(row['library_kernels'])})")
        if args.preprocess:  # to hold two trees' kernels bit for bit
            row["sha256"] = hashlib.sha256(case.fn().cpu().view(torch.uint8).numpy()).hexdigest()
        print(f"{row['kernel']} {row['case']}: kernel {row['ms']:.4f} ms (device "
              f"{row['device_ms']:.4f}), plain {row['plain_ms']:.4f} (device "
              f"{row['plain_device_ms']:.4f}), bound "
              f"{row['bound_ms']:.4f} ({row['bound_by']}; {row['bound_share']:.1%} of it, "
              f"{row['bound_ms'] / row['device_ms']:.1%} in device ms, {row['tflops']:.1f} "
              f"TFLOP/s), {row['library']} {library}"
              + (f", output sha256 {row['sha256'][:16]}" if args.preprocess else ""))
    launches = {} if args.tiled or args.ln or args.preprocess else path_launches("cuda")
    for label, counts in launches.items():
        print(f"launches, {label}: {counts}")
    print(json.dumps({"card": card, "rows": rows, "launches": launches}))


if __name__ == "__main__":
    main()
