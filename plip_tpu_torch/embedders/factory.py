"""Embedder factory: the port of ``plip_tpu.embedders.factory`` (the
reference harness's ``embedders/factory.py``).

Dispatch on ``args.model_name``:

- ``plip``: the CLIP architecture of ``$PC_CLIP_ARCH`` with weights from
  ``args.backbone`` (a native ``.npz`` or a torch state_dict in HF or
  OpenAI naming, ``utils.checkpoint.load_any_checkpoint``), else random
  weights of that architecture;
- ``clip``: base weights from ``PLIP_TPU_CHECKPOINT`` where it is set, else
  random weights (there is no network to fetch them from);
- ``mudipath``: the DenseNet backbone is not ported yet; it raises.

The model runs on ``args.device`` where the caller gives one, else on the
card.
"""

from __future__ import annotations

import os
from types import SimpleNamespace
from typing import Union

from ..api import PLIP
from .clip_embedder import CLIPEmbedder


class EmbedderFactory:
    def __init__(self):
        pass

    def factory(self, args: Union[SimpleNamespace, object]):
        name = args.model_name
        path = getattr(args, "backbone", "") or ""
        device = getattr(args, "device", None)

        if name in ("plip", "clip"):
            arch = os.environ.get("PC_CLIP_ARCH", "ViT-B/32")
            if name == "plip" and path and os.path.exists(path):
                model = PLIP(path, device=device)
            elif name == "clip" and os.environ.get("PLIP_TPU_CHECKPOINT"):
                model = PLIP(os.environ["PLIP_TPU_CHECKPOINT"], device=device)
            else:
                model = PLIP(f"random:{arch}", device=device)
            return CLIPEmbedder(model, name, path)

        if name == "mudipath":
            raise NotImplementedError(
                "model_name='mudipath': the DenseNet-121 backbone is not ported to "
                "plip_tpu_torch yet (ROADMAP.md, Queue 1 item 8)")

        raise ValueError(f"unknown model_name {name!r}")
