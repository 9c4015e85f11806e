"""Where the time of a serving request goes, on one CUDA card.

Builds ``PLIP("random:<arch>")`` (weights from seed 0) and, for two requests,
``encode_images`` of synthetic 256x256 uint8 tiles and ``encode_text`` of 8
prompts, prints the wall time unprofiled, the wall and summed device (kernel)
time under ``torch.profiler``, the idle share ``1 - device / profiled wall``,
the kernel launches of a request, and the kernels that take the most device
time. The encode's preprocessing is also run alone, as ``encode_images``
runs it (``preprocess_images`` a batch at a time: the default two-matmul
path) and with ``fused=True`` (K11, ``csrc/preprocess.cu``), for its share of
the encode's device time:

    python -m plip_tpu_torch.profile_serve [--arch ViT-L/14@336px] [--batch 32] \
        [--tiles 64] [--dtype bf16]

``--dtype``: ``bf16`` (this script's default) or ``fp32`` (``PLIP``'s own
default). 2 warm-up calls, the median of 5 unprofiled calls, and
2 calls under the profiler.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .api import PLIP
from .ops.preprocess import preprocess_batch, preprocess_images
from .profile_train import DTYPES, kernel_times

PROMPTS = [f"an H&E image of {t}" for t in (
    "benign tissue", "malignant tumor", "normal colon mucosa", "adipose tissue",
    "lymphocytes", "necrosis", "smooth muscle", "stroma")]
REPS, PROFILED = 5, 2  # unprofiled and profiled calls


def profile_request(fn):
    """(median unprofiled wall ms, profiled wall ms, {kernel: (launches, ms)})
    of one call of ``fn``, the profiled figures averaged over ``PROFILED``."""

    def run(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e3

    run(2)  # warm-up: kernel build, cuBLAS, allocator
    wall = statistics.median(run(1) for _ in range(REPS))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_prof = run(PROFILED)
    return wall, wall_prof, kernel_times(prof, PROFILED)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="ViT-L/14@336px")
    ap.add_argument("--batch", type=int, default=32, help="encode_images batch size")
    ap.add_argument("--tiles", type=int, default=64, help="tiles an encode_images request")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    ap.add_argument("--top", type=int, default=12, help="kernels listed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}")

    model = PLIP(f"random:{args.arch}", dtype=DTYPES[args.dtype], device="cuda")
    tiles = list(np.random.default_rng(0).integers(0, 256, (args.tiles, 256, 256, 3),
                                                   np.uint8))
    n_px, batches = model.cfg.vision.image_size, range(0, args.tiles, args.batch)
    requests = {
        f"encode_images, {args.tiles} tiles in batches of {args.batch}":
            lambda: model.encode_images(tiles, batch_size=args.batch),
        f"its preprocessing alone, {args.tiles} tiles in batches of {args.batch}": lambda: [
            preprocess_images(tiles[i:i + args.batch], n_px, device="cuda") for i in batches],
        f"its preprocessing with fused=True (K11), {args.tiles} tiles": lambda: [
            preprocess_batch(np.stack(tiles[i:i + args.batch]), n_px, device="cuda", fused=True)
            for i in batches],
        f"encode_text, {len(PROMPTS)} prompts": lambda: model.encode_text(PROMPTS),
    }
    for label, fn in requests.items():
        wall, wall_prof, by_name = profile_request(fn)
        device = sum(t for _, t in by_name.values())
        launches = sum(n for n, _ in by_name.values())
        print(f"{args.arch} {args.dtype} {label}: unprofiled {wall:.3f} ms, profiled wall "
              f"{wall_prof:.3f} ms, device {device:.3f} ms, idle share of the profiled "
              f"wall {1 - device / wall_prof:.3f}, {launches:.0f} kernel launches")
        print("  device ms/call, launches/call, kernel:")
        for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:args.top]:
            print(f"  {t:9.3f}  {n:6.0f}  {name[:110]}")


if __name__ == "__main__":
    main()
