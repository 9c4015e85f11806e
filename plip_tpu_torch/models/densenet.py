"""DenseNet towers (torchvision-compatible weights): the port of
``plip_tpu.models.densenet``.

The mudipath baseline embedder wraps a headless DenseNet-121
(``embedders/mudipath.py:89-133`` of the reference harness: torchvision
``densenet121`` features + ReLU + global average pool, 1024-d, with
multi-task-digital-pathology weights). Plain ``nn.Module``s with
torchvision's module names under ``features.``, held without that prefix
(``conv0``, ``norm0``, ``denseblockN.denselayerM``, ``transitionN``,
``norm5``): ``from_torch_state_dict`` strips ``module.`` and ``features.``
(the mtdp cleaning at mudipath.py:43-46) and drops the classifier. BatchNorm
is ``models.resnet``'s (``nn.BatchNorm2d``). Inputs are NHWC.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from .resnet import _oihw, bn_state, conv, init_cnn_, load_bn_state_dict

ARCHS = {
    "densenet121": {"growth": 32, "blocks": [6, 12, 24, 16], "init_feats": 64},
    "densenet169": {"growth": 32, "blocks": [6, 12, 32, 32], "init_feats": 64},
    "densenet201": {"growth": 32, "blocks": [6, 12, 48, 32], "init_feats": 64},
}


class DenseLayer(nn.Module):
    """BN-ReLU-Conv1x1(4g) - BN-ReLU-Conv3x3(g); concatenated onto the input."""

    def __init__(self, c: int, g: int):
        super().__init__()
        self.norm1 = nn.BatchNorm2d(c)
        self.conv1 = conv(c, 4 * g, 1)
        self.norm2 = nn.BatchNorm2d(4 * g)
        self.conv2 = conv(4 * g, g, 3)

    def forward(self, x):
        y = self.conv1(torch.relu(self.norm1(x)))
        y = self.conv2(torch.relu(self.norm2(y)))
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = nn.BatchNorm2d(c)
        self.conv = conv(c, c // 2, 1)

    def forward(self, x):
        return torch.nn.functional.avg_pool2d(self.conv(torch.relu(self.norm(x))), 2, 2)


class DenseNet(nn.Module):
    """``forward_features``: NHWC image -> pooled features ``[B, C]`` (the
    reference's headless ``NoHeadDenseNet``, mudipath.py:125-130)."""

    def __init__(self, arch: str = "densenet121"):
        super().__init__()
        spec = ARCHS[arch]
        self.arch = arch
        g, c = spec["growth"], spec["init_feats"]
        self.conv0 = conv(3, c, 7, 2)
        self.norm0 = nn.BatchNorm2d(c)
        for bi, n_layers in enumerate(spec["blocks"]):
            block = nn.Module()
            for li in range(n_layers):
                block.add_module(f"denselayer{li + 1}", DenseLayer(c, g))
                c += g
            self.add_module(f"denseblock{bi + 1}", block)
            if bi < len(spec["blocks"]) - 1:
                self.add_module(f"transition{bi + 1}", Transition(c))
                c //= 2
        self.norm5 = nn.BatchNorm2d(c)

    def forward_features(self, pixels: torch.Tensor) -> torch.Tensor:
        y = pixels.permute(0, 3, 1, 2)  # NHWC -> NCHW (a channels-last view)
        y = torch.relu(self.norm0(self.conv0(y)))
        y = torch.nn.functional.max_pool2d(y, 3, 2, 1)
        n_blocks = len(ARCHS[self.arch]["blocks"])
        for bi in range(n_blocks):
            for layer in getattr(self, f"denseblock{bi + 1}").children():
                y = layer(y)
            if bi < n_blocks - 1:
                y = getattr(self, f"transition{bi + 1}")(y)
        y = torch.relu(self.norm5(y))
        return y.mean(dim=(2, 3))

    forward = forward_features

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "DenseNet":
        """The JAX package's scheme: convolutions N(0, 2 / fan_in), BN the
        identity, drawn from ``generator``."""
        init_cnn_(self, generator)
        return self


def n_features(arch: str = "densenet121") -> int:
    spec = ARCHS[arch]
    c = spec["init_feats"]
    for bi, n_layers in enumerate(spec["blocks"]):
        c += n_layers * spec["growth"]
        if bi < len(spec["blocks"]) - 1:
            c //= 2
    return c


def from_torch_state_dict(sd: Mapping[str, Any], arch: str = "densenet121") -> DenseNet:
    """A torchvision or mtdp densenet state_dict -> a ``DenseNet``: keys with
    or without ``module.`` and ``features.``; ``classifier.*`` dropped; the
    rest loaded strictly (``models.resnet.load_bn_state_dict``)."""
    clean = {}
    for k, v in sd.items():
        for prefix in ("module.", "features."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        if not k.startswith("classifier."):
            clean[k] = v
    model = DenseNet(arch)
    load_bn_state_dict(model, clean)
    return model


def from_jax_params(params: Mapping, arch: str = "densenet121") -> DenseNet:
    """The JAX package's DenseNet tree (HWIO kernels; ``denseblockN`` lists)
    -> a ``DenseNet`` holding the same numbers."""
    spec = ARCHS[arch]
    sd: Dict[str, np.ndarray] = {"conv0.weight": _oihw(params["conv0"]),
                                 **bn_state("norm0", params["norm0"])}
    for bi in range(len(spec["blocks"])):
        for li, p in enumerate(params[f"denseblock{bi + 1}"]):
            pre = f"denseblock{bi + 1}.denselayer{li + 1}"
            for i in (1, 2):
                sd[f"{pre}.conv{i}.weight"] = _oihw(p[f"conv{i}"])
                sd.update(bn_state(f"{pre}.norm{i}", p[f"norm{i}"]))
        if f"transition{bi + 1}" in params:
            p = params[f"transition{bi + 1}"]
            sd[f"transition{bi + 1}.conv.weight"] = _oihw(p["conv"])
            sd.update(bn_state(f"transition{bi + 1}.norm", p["norm"]))
    sd.update(bn_state("norm5", params["norm5"]))
    model = DenseNet(arch)
    load_bn_state_dict(model, sd)
    return model
