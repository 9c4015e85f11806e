"""Export a native checkpoint as a PyTorch state_dict of the reference
ecosystem: the port of ``plip_tpu.scripts.export_checkpoint``.

The reference's eval harness loads tuned weights with ``torch.load`` +
``load_state_dict``, in the layout its trainer publishes each epoch. This CLI
turns a native ``.npz`` (written by either package, e.g. a ``CLIPTuner``
epoch) into such a file, in either naming.

Usage::

    python -m plip_tpu_torch.scripts.export_checkpoint SRC.npz OUT.pt
        [--naming openai|hf] [--device cpu]

``SRC`` may also be the full-state directory ``CLIPTuner.tuner(
save_full_state="orbax")`` writes (a ``torch.distributed.checkpoint``
directory; its parameters are exported). A JAX orbax directory is refused:
export its ``.npz`` full state instead. The model is loaded on ``--device``
(default: the CUDA device) and exported from there.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..models.clip import CLIP
from ..train.contrastive import load_train_state_sharded, make_optimizer
from ..utils import resolve_device
from ..utils.checkpoint import load_checkpoint, save_torch_checkpoint


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(
        description="Export a native .npz checkpoint as a PyTorch state_dict the "
        "reference harness can torch.load.")
    parser.add_argument("src", type=str, help="native .npz checkpoint, or a sharded "
                        "full-state directory")
    parser.add_argument("out", type=str, help="output torch file (.pt)")
    parser.add_argument(
        "--naming", choices=("openai", "hf"), default="openai",
        help="state_dict key layout: 'openai' (the reference repro harness's "
        "format, default) or 'hf' (transformers.CLIPModel)")
    parser.add_argument("--device", type=str, default=None,
                        help="where the model is loaded (default: the CUDA device)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device, "export_checkpoint")
    if os.path.isdir(args.src):  # the optimizer's settings do not touch the params
        state, cfg = load_train_state_sharded(args.src, make_optimizer(), device)
        model = state.model
    else:
        sd, cfg = load_checkpoint(args.src)
        model = CLIP(cfg)
        model.load_state_dict(sd)
    path = save_torch_checkpoint(args.out, model.to(device), cfg, naming=args.naming)
    print(f"wrote {args.naming} state_dict: {path}")
    return path


if __name__ == "__main__":
    main(sys.argv[1:])
