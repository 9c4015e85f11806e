#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (plip_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with an H100 (sm_90a), the
CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

1. Set-up: builds the port's CUDA kernels from plip_tpu_torch/csrc/ with
   nvcc and prints the card's name and power limit.
2. Kernel phase: each CUDA kernel of the attention sublayer, and the whole
   sublayer, against its plain PyTorch version on the card, at the serving
   path's shapes (vision B=32 S=50 W=768 12 heads; text B=32 and B=8, S=77
   W=512 8 heads causal; text with s_valid < S). fp32: allclose atol 1e-4,
   rtol 1e-4, with TF32 off for every fp32 product. bf16: per-row cosine
   >= 0.999 and allclose atol 3e-2, rtol 1e-2 (one bf16 rounding step is
   2^-8 of the value). Times with CUDA events, plain and kernel in turns.
3. Serving phase: PLIP("random:ViT-B/32", bf16) at full width (12 layers
   in both towers) encodes 64 synthetic 256x256 images in batches of 32 and
   8 prompts, classifies zero-shot and retrieves top-5. Every kernel must have been
   launched by that run, and the embeddings must match the same model run
   through the plain sublayer (row cosine >= 0.999). The same model in fp32
   must match its plain run to cosine >= 0.9999 with the same zero-shot
   argmax on every image (in bf16 the two paths' scores differ by more than
   the gap between a random model's top two labels on some images, so there
   the count of differing labels is printed). Then images/s and texts/s,
   kernels and plain sublayer in turns.

Exits non-zero, printing no result, when there is no CUDA device or any check
fails. The line before the last is a JSON summary of the kernels; the last
line is {"ok": true, "device": {...}}.
"""

import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "plip_tpu_torch/csrc/attention_sublayer.cu"
REPLACES = "plip_tpu/ops/attention.py:644"  # _attn_sublayer_kernel (K1)
KERNELS = ("ln_rows", "gemm_bias_residual", "attn_core")

# (name, B, S, W, heads, causal, s_valid)
CASES = (
    ("vision", 32, 50, 768, 12, False, None),
    ("text", 32, 77, 512, 8, True, None),
    ("text s_valid=70", 32, 77, 512, 8, True, 70),
    ("text, 8 prompts", 8, 77, 512, 8, True, None),  # the requests below
)
IMAGE_BATCH = 32  # the vision case above, and PLIP.encode_images' default
TIMED_CASE, TIMED_DTYPE = "vision", torch.bfloat16  # the numbers in the JSON line

PROMPTS = [
    "an H&E image of benign tissue",
    "an H&E image of malignant tumor",
    "an H&E image of normal colon mucosa",
    "an H&E image of adipose tissue",
    "an H&E image of lymphocytes",
    "an H&E image of necrosis",
    "an H&E image of smooth muscle",
    "an H&E image of stroma",
]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(kernel_fn, plain_fn):
    """(kernel ms, plain ms): plain, kernel, kernel, plain; the means."""
    p1, k1, k2, p2 = (time_ms(f) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn))
    return (k1 + k2) / 2, (p1 + p2) / 2


def compare(label, got, want, dtype) -> float:
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    if dtype == torch.float32:
        ok = torch.allclose(got, want, atol=1e-4, rtol=1e-4)
        extra = ""
    else:
        cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).min().item()
        ok = cos >= 0.999 and torch.allclose(got, want, atol=3e-2, rtol=1e-2)
        extra = f" min_row_cos={cos:.6f}"
    print(f"  {label}: max_abs_err={err:.3e}{extra} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with its plain version")
    return err


def make_case(B, S, W, gen):
    dev = "cuda"

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to(dev)

    x = rnd(B * S, W)
    ln = {"scale": 1 + rnd(W, std=0.1), "bias": rnd(W, std=0.05)}
    attn = {"qkv": {"kernel": rnd(W, 3 * W, std=W ** -0.5), "bias": rnd(3 * W, std=0.02)},
            "out": {"kernel": rnd(W, W, std=W ** -0.5), "bias": rnd(W, std=0.02)}}
    return x, ln, attn


def kernel_phase(att):
    worst = {k: 0.0 for k in KERNELS}
    timed = {}
    gen = torch.Generator().manual_seed(0)
    for name, B, S, W, heads, causal, s_valid in CASES:
        x32, ln, attn = make_case(B, S, W, gen)
        for dtype in (torch.float32, torch.bfloat16):
            print(f"[kernels] {name} B={B} S={S} W={W} heads={heads} "
                  f"causal={causal} s_valid={s_valid} {str(dtype)[6:]}")
            x = x32.to(dtype)
            wqkv = attn["qkv"]["kernel"].to(dtype)
            wout = attn["out"]["kernel"].to(dtype)
            bqkv, bout = attn["qkv"]["bias"], attn["out"]["bias"]
            h = att.layer_norm_rows_reference(x, ln["scale"], ln["bias"])
            qkv = att.gemm_bias_residual_reference(h, wqkv, bqkv)
            ctx = att.attn_core_reference(qkv, S, heads, causal, s_valid)
            calls = {
                "ln_rows": (lambda: att.ln_rows(x, ln["scale"], ln["bias"]),
                            lambda: att.layer_norm_rows_reference(x, ln["scale"], ln["bias"])),
                "gemm_bias_residual": (
                    lambda: att.gemm_bias_residual(h, wqkv, bqkv),
                    lambda: att.gemm_bias_residual_reference(h, wqkv, bqkv)),
                "attn_core": (
                    lambda: att.attn_core(qkv, S, heads, causal, s_valid),
                    lambda: att.attn_core_reference(qkv, S, heads, causal, s_valid)),
                "gemm_bias_residual +residual (out-proj)": (
                    lambda: att.gemm_bias_residual(ctx, wout, bout, x),
                    lambda: att.gemm_bias_residual_reference(ctx, wout, bout, x)),
                "attention_sublayer": (
                    lambda: att.attention_sublayer(x, ln, attn, heads, causal, s_valid, S=S),
                    lambda: att.attention_sublayer_reference(x, ln, attn, heads, causal,
                                                             s_valid, S=S)),
            }
            for label, (kernel_fn, plain_fn) in calls.items():
                got = kernel_fn()
                torch.cuda.synchronize()  # a fault in the kernel shows here
                err = compare(label, got, plain_fn(), dtype)
                kname = label.split(" ")[0]
                if kname in worst:
                    worst[kname] = max(worst[kname], err)
                ms, plain_ms = in_turns(kernel_fn, plain_fn)
                print(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
                if name == TIMED_CASE and dtype == TIMED_DTYPE and label in KERNELS:
                    timed[label] = (ms, plain_ms)
            if dtype == torch.bfloat16:  # context: the library GEMM, not a port
                cublas = time_ms(lambda: torch.addmm(bqkv.to(dtype), h, wqkv))
                print(f"  torch.addmm bf16 at the QKV shape (cuBLAS): {cublas:.4f} ms")
    return worst, timed


def synthetic_images(n: int, seed: int = 0) -> np.ndarray:
    """Smooth colour fields with noise: images that differ from each other."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float32) / 255.0
    base = rng.uniform(0, 255, (n, 1, 1, 3)).astype(np.float32)
    tilt = rng.uniform(-120, 120, (n, 2, 1, 1, 3)).astype(np.float32)
    img = base + tilt[:, 0] * yy[None, :, :, None] + tilt[:, 1] * xx[None, :, :, None]
    img += rng.normal(0, 12, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def row_cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def against_plain(model, images, plain, att, img, txt, cos_bar, same_argmax):
    """Hold the kernel path's embeddings and zero-shot argmax against the same
    model run through the plain sublayer; return the kernel path's labels."""
    launches = dict(att.LAUNCHES)
    with plain:
        img_ref = model.encode_images(images, batch_size=IMAGE_BATCH)
        txt_ref = model.encode_text(PROMPTS)
    if dict(att.LAUNCHES) != launches:
        raise AssertionError("the plain run launched a CUDA kernel")
    tag = f"[serving {str(model.dtype)[6:]}]"
    ci, ct = row_cos(img, img_ref).min(), row_cos(txt, txt_ref).min()
    print(f"{tag} kernel vs plain sublayer: image row cosine min {ci:.7f}, "
          f"text row cosine min {ct:.7f} (bar {cos_bar})")
    if ci < cos_bar or ct < cos_bar:
        raise AssertionError("embeddings disagree with the plain path")
    # zero_shot_classification's scores: images normalized, texts not
    sim = model._cosine_similarity(img, txt)
    sim_ref = model._cosine_similarity(img_ref, txt_ref)
    pred, pred_ref = sim.argmax(-1), sim_ref.argmax(-1)
    srt = np.sort(sim_ref, axis=-1)
    differ = int((pred != pred_ref).sum())
    print(f"{tag} zero-shot: {np.unique(pred_ref).size} distinct labels, smallest "
          f"top-2 score gap {(srt[:, -1] - srt[:, -2]).min():.3e}, largest "
          f"|score - score_plain| {np.abs(sim - sim_ref).max():.3e}, argmax differs "
          f"on {differ}/{len(pred)} images")
    if same_argmax and differ:
        raise AssertionError("zero-shot argmax differs from the plain path")
    return pred


def serving_phase(att, layers, PLIP):
    t0 = time.perf_counter()
    model = PLIP("random:ViT-B/32", dtype=torch.bfloat16, device="cuda")
    print(f"[serving] PLIP random:ViT-B/32 bf16 built in {time.perf_counter() - t0:.2f} s")
    images = synthetic_images(64)
    plain = mock.patch.object(layers, "attention_sublayer", att.attention_sublayer_reference)

    model.encode_images(images, batch_size=IMAGE_BATCH)  # warm-up: cuBLAS, allocator
    model.encode_text(PROMPTS)
    torch.cuda.synchronize()

    att.reset_launch_counts()
    img = model.encode_images(images, batch_size=IMAGE_BATCH)
    txt = model.encode_text(PROMPTS)
    labels = model.zero_shot_classification(images, PROMPTS, batch_size=IMAGE_BATCH)
    model.build_image_index(images, batch_size=IMAGE_BATCH)
    top = model.retrieval(PROMPTS, top_k=5)
    torch.cuda.synchronize()
    launches = dict(att.LAUNCHES)
    print(f"[serving] kernel launches in the serving run: {launches}")
    for k in KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"{k} was never launched by the serving path")

    if img.shape != (64, 512) or txt.shape != (8, 512):
        raise AssertionError(f"embedding shapes {img.shape}, {txt.shape}")
    if not (np.isfinite(img).all() and np.isfinite(txt).all()):
        raise AssertionError("non-finite embeddings")
    if len(labels) != 64 or not set(labels) <= set(PROMPTS):
        raise AssertionError("zero-shot labels malformed")
    if top.shape != (8, 5) or top.min() < 0 or top.max() >= 64:
        raise AssertionError(f"retrieval indices malformed: {top.shape}")

    pred = against_plain(model, images, plain, att, img, txt, cos_bar=0.999,
                         same_argmax=False)
    if [PROMPTS[i] for i in pred] != labels:
        raise AssertionError("zero_shot_classification disagrees with the embeddings")

    # fp32 through the same path: the kernels and the plain versions then
    # differ by summation order only, and the zero-shot labels must agree.
    model32 = PLIP("random:ViT-B/32", dtype=torch.float32, device="cuda")
    img32 = model32.encode_images(images, batch_size=IMAGE_BATCH)
    against_plain(model32, images, plain, att, img32, model32.encode_text(PROMPTS),
                  cos_bar=0.9999, same_argmax=True)
    del model32

    def rate(fn, n, reps=3):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return n / statistics.median(times)

    texts = PROMPTS * 32
    runs = {
        "images/s (64 images in batches of 32, 256x256 uint8 in, preprocess on card)":
            lambda: rate(lambda: model.encode_images(images, batch_size=IMAGE_BATCH), 64),
        "texts/s (8 prompts)": lambda: rate(lambda: model.encode_text(PROMPTS), 8),
        "texts/s (256 texts, batch 256)":
            lambda: rate(lambda: model.encode_text(texts, batch_size=256), 256),
    }
    for label, fn in runs.items():
        k1 = fn()
        with plain:
            p1 = fn()
            p2 = fn()
        k2 = fn()
        print(f"[serving] {label}: kernels {k1:.1f} / {k2:.1f}, "
              f"plain sublayer {p1:.1f} / {p2:.1f}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from plip_tpu_torch.api import PLIP
    from plip_tpu_torch.models import layers
    from plip_tpu_torch.ops import _build
    from plip_tpu_torch.ops import attention as att

    # fp32 products are the reference: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib = _build.build()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    worst, timed = kernel_phase(att)
    launches = serving_phase(att, layers, PLIP)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    print(f"card: {card}")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
         "launches": launches[k], "max_abs_err": worst[k],
         "ms": timed[k][0], "plain_ms": timed[k][1]}
        for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
