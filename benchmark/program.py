"""The system under test, built from a configuration file and the run's
seed: the PyTorch and CUDA package ``plip_tpu_torch``. Nothing else of the
benchmark imports it.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from .weights import make_weights


def program_config(cfg: Mapping):
    """The program's ``CLIPConfig`` of a configuration file."""
    from plip_tpu_torch.models.config import CLIPConfig, TextConfig, VisionConfig

    v, t = cfg["vision"], cfg["text"]
    return CLIPConfig(
        vision=VisionConfig(width=v["width"], layers=v["layers"], heads=v["heads"],
                            image_size=v["image_size"], patch_size=v["patch_size"]),
        text=TextConfig(width=t["width"], layers=t["layers"], heads=t["heads"],
                        vocab_size=t["vocab_size"], context_length=t["context_length"]),
        embed_dim=cfg["embed_dim"], logit_scale_max=cfg["logit_scale_max"],
        ln_eps=cfg["ln_eps"])


def build_model(cfg: Mapping, weights: Mapping[str, torch.Tensor], device):
    """The program's ``CLIP``, allocated on ``device``, holding ``weights``."""
    from plip_tpu_torch.models.clip import CLIP

    with torch.device(device):
        model = CLIP(program_config(cfg))
    model.load_state_dict(weights)
    return model


def build_plip(cfg: Mapping, seed: int, dtype: torch.dtype, device,
               quantize: Optional[str] = None):
    """``plip_tpu_torch.api.PLIP`` over the seed's weights. ``PLIP`` loads a
    model only by name (a checkpoint file, or ``random:`` weights drawn on
    the host from a fixed seed), so the benchmark hands it the model it built
    in place of the load and leaves the rest of ``PLIP.__init__`` as it is."""
    from plip_tpu_torch.api import PLIP

    weights = make_weights(cfg, seed, device)
    model = build_model(cfg, weights, device)
    del weights

    class SeededPLIP(PLIP):
        def _load_model(self, model_name):
            return model, model.cfg

    return SeededPLIP(f"seed:{seed}", dtype=dtype, device=device, quantize=quantize)
