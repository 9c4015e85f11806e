"""MuDiPath (DenseNet) embedder: the port of ``plip_tpu.embedders.mudipath``
(the reference harness's ``embedders/mudipath.py``).

The reference builds a headless torchvision DenseNet-121 with
multi-task-digital-pathology weights fetched from hardcoded URLs (unusable
offline) and mirrors ``CLIPEmbedder``'s caching. Here the tower is
``models.densenet`` on the device; weights load from a local torch
state_dict (torchvision or mtdp ``module./features.`` naming, read with
torch's ``weights_only=True`` loader), else random weights from the seed.
Images are preprocessed on the device with ImageNet's mean and std
(factory.py:41-46); the embeddings are L2-normalized. The image cache is
``clip_embedder``'s by-name layout.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..data.datasets import ImageDataset
from ..data.loader import PrefetchLoader
from ..models import densenet as tdense
from ..ops.preprocess import IMAGENET_MEAN, IMAGENET_STD, preprocess_images
from ..utils import resolve_device
from ..utils.cacher import cache_hit_or_miss_raw_filename, cache_numpy_object_raw_filename
from ..utils.checkpoint import load_torch_file
from .abst import AbstractEmbedder


def build_resnet(weights_path: Optional[str] = None, arch: str = "resnet50", seed: int = 0,
                 device=None):
    """(model, arch): a headless ResNet in eval mode on ``device`` (default
    the card), the reference's NoHeadResNet (mudipath.py:49-86): features +
    global average pool, ``models.resnet.ResNet.forward_features``."""
    from ..models import resnet as tres

    if weights_path:
        model = tres.from_torch_state_dict(load_torch_file(weights_path), arch)
    else:
        model = tres.ResNet(arch).init_params(torch.Generator().manual_seed(seed))
    return model.to(resolve_device(device, "build_resnet")).eval(), arch


def build_densenet(weights_path: Optional[str] = None, arch: str = "densenet121",
                   seed: int = 0, device=None):
    """(model, arch): from a local state_dict if given, else random weights
    from ``seed``; in eval mode on ``device`` (default the card). Replaces
    the reference's ``build_densenet(download_dir, pretrained='mtdp')`` URL
    fetch (mudipath.py:103-122)."""
    if weights_path:
        model = tdense.from_torch_state_dict(load_torch_file(weights_path), arch)
    else:
        model = tdense.DenseNet(arch).init_params(torch.Generator().manual_seed(seed))
    return model.to(resolve_device(device, "build_densenet")).eval(), arch


class DenseNetEmbedder(AbstractEmbedder):
    """model: a ``models.densenet.DenseNet`` (``build_densenet``); it runs
    where its parameters are."""

    def __init__(self, model, arch: str, name: str, backbone: str):
        self.model = model.eval()
        self.arch = arch
        self.name = name
        self.backbone = backbone

    def image_embedder(
        self,
        list_of_images: Sequence,
        device=None,
        num_workers: int = 8,
        batch_size: int = 32,
        additional_cache_name: str = "",
    ) -> np.ndarray:
        """Cache first; ``device`` is the reference's argument, unused."""
        hit = cache_hit_or_miss_raw_filename(
            self.name + "img" + additional_cache_name, self.backbone
        )
        if hit is not None:
            return hit
        emb = self.embed_images(list_of_images, num_workers=num_workers, batch_size=batch_size)
        cache_numpy_object_raw_filename(
            emb, self.name + "img" + additional_cache_name, self.backbone
        )
        return emb

    def text_embedder(self, *args, **kwargs):
        raise NotImplementedError(
            "DenseNet embedder has no text tower (mudipath is image-only; "
            "the reference's DenseNetEmbedder likewise lacks text_embedder)"
        )

    def embed_images(
        self, list_of_images: Sequence, num_workers: int = 8, batch_size: int = 32
    ) -> np.ndarray:
        """L2-normalized ``[N, n_features]`` features of the images (paths,
        PIL images or arrays, any mix of sizes)."""
        device = next(self.model.parameters()).device
        loader = PrefetchLoader(ImageDataset(list_of_images), batch_size,
                                num_workers=num_workers, collate=lambda items, bs: list(items))
        outs: List[np.ndarray] = []
        for batch, _ in loader:
            pixels = preprocess_images(batch, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                                       device=device)
            with torch.inference_mode():
                outs.append(self.model.forward_features(pixels).cpu().numpy())
        emb = np.concatenate(outs, axis=0)
        return emb / np.linalg.norm(emb, axis=1, keepdims=True)
