"""Where the time of a train step goes, on one CUDA card.

Runs ``make_train_step`` on one architecture (ViT-B/32 by default) with
random weights (seed 0) and one fixed batch of synthetic tiles and captions,
augmented on the card to the architecture's image size, then prints the wall time of an
unprofiled step, the wall and summed device (kernel) time of a step under
``torch.profiler``, the idle share ``1 - device / profiled wall``, the
kernel launches a step, and the kernels that take the most device time:

    python -m plip_tpu_torch.profile_train [--arch ViT-L/14] [--batch 128] [--remat mlp]

``--remat``: ``mlp``, ``block``, ``mlp_h1``, ``true`` or ``false``
(``models.layers``).
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .models.clip import CLIP
from .models.config import ARCHITECTURES
from .ops.augment import AugmentConfig, augment_batch
from .tokenizer import default_tokenizer
from .train.contrastive import init_train_state, make_optimizer, make_train_step

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def kernel_times(prof, calls: int) -> dict:
    """``{kernel name: (launches, device ms)}`` per call, from a profile that
    ran ``calls`` calls. ``record_function`` ranges, which the profiler also
    lists on the device, are not work and are left out."""
    by_name: dict = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1 / calls, t + e.time_range.elapsed_us() / 1e3 / calls)
    return by_name


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(ARCHITECTURES), default="ViT-B/32")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    ap.add_argument("--remat", choices=("mlp", "block", "mlp_h1", "true", "false"),
                    default="mlp")
    ap.add_argument("--steps", type=int, default=5, help="unprofiled steps timed")
    ap.add_argument("--profiled", type=int, default=2, help="steps under the profiler")
    ap.add_argument("--top", type=int, default=25, help="kernels listed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    remat = {"true": True, "false": False}.get(args.remat, args.remat)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()

    cfg = ARCHITECTURES[args.arch]()
    model = CLIP(cfg).init_params(torch.Generator().manual_seed(0)).to("cuda")
    rng = np.random.default_rng(0)
    side = max(256, cfg.vision.image_size)  # the random crop needs side >= image size
    images = torch.from_numpy(rng.integers(0, 256, (args.batch, side, side, 3), np.uint8))
    pixels = augment_batch(torch.Generator().manual_seed(0), images.to("cuda"),
                           AugmentConfig(out_size=cfg.vision.image_size))
    captions = [f"an H&E image of tissue, case {i}" for i in range(args.batch)]
    ids = torch.as_tensor(default_tokenizer().tokenize(captions, cfg.text.context_length),
                          dtype=torch.long, device="cuda")
    opt = make_optimizer(base_lr=1e-6, warmup=1, total_steps=100)
    step = make_train_step(cfg, opt, dtype=DTYPES[args.dtype], remat=remat)
    state = init_train_state(model, opt)

    def run(n):
        nonlocal state
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            state, _ = step(state, pixels, ids)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e3

    run(3)  # warm-up: kernel build, cuBLAS, allocator
    wall = run(args.steps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_prof = run(args.profiled)
    by_name = kernel_times(prof, args.profiled)
    device = sum(t for _, t in by_name.values())
    launches = sum(n for n, _ in by_name.values())

    print(f"card: {card}")
    print(f"{args.arch} {args.dtype} batch {args.batch} remat {args.remat}: unprofiled "
          f"{wall:.3f} ms/step ({args.batch / wall * 1e3:.1f} pairs/s); profiled wall "
          f"{wall_prof:.3f} ms/step, device {device:.3f} ms/step, idle share of the "
          f"profiled wall {1 - device / wall_prof:.3f}, device / unprofiled wall "
          f"{device / wall:.3f}, {launches:.0f} kernel launches/step")
    print("device ms/step, launches/step, kernel:")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:args.top]:
        print(f"  {t:9.3f}  {n:6.0f}  {name[:110]}")


if __name__ == "__main__":
    main()
