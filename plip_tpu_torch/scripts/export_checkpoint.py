"""Export a native checkpoint as a PyTorch state_dict of the reference
ecosystem: the port of ``plip_tpu.scripts.export_checkpoint``.

The reference's eval harness loads tuned weights with ``torch.load`` +
``load_state_dict``, in the layout its trainer publishes each epoch. This CLI
turns a native ``.npz`` (written by either package, e.g. a ``CLIPTuner``
epoch) into such a file, in either naming.

Usage::

    python -m plip_tpu_torch.scripts.export_checkpoint SRC.npz OUT.pt
        [--naming openai|hf] [--device cpu]

The model is loaded on ``--device`` (default: the CUDA device) and exported
from there. Orbax train-state directories are not read.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..models.clip import CLIP
from ..utils import resolve_device
from ..utils.checkpoint import load_checkpoint, save_torch_checkpoint


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(
        description="Export a native .npz checkpoint as a PyTorch state_dict the "
        "reference harness can torch.load.")
    parser.add_argument("src", type=str, help="native .npz checkpoint")
    parser.add_argument("out", type=str, help="output torch file (.pt)")
    parser.add_argument(
        "--naming", choices=("openai", "hf"), default="openai",
        help="state_dict key layout: 'openai' (the reference repro harness's "
        "format, default) or 'hf' (transformers.CLIPModel)")
    parser.add_argument("--device", type=str, default=None,
                        help="where the model is loaded (default: the CUDA device)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device, "export_checkpoint")
    if os.path.isdir(args.src):
        raise NotImplementedError(
            f"{args.src!r} is a directory: orbax train-state checkpoints come with the "
            "distributed port (ROADMAP.md Queue 1 item 9); export a native .npz")
    state, cfg = load_checkpoint(args.src)
    model = CLIP(cfg)
    model.load_state_dict(state)
    path = save_torch_checkpoint(args.out, model.to(device), cfg, naming=args.naming)
    print(f"wrote {args.naming} state_dict: {path}")
    return path


if __name__ == "__main__":
    main(sys.argv[1:])
