"""ResNet towers (torchvision-compatible weights): the port of
``plip_tpu.models.resnet``.

The reference's fine-tune backbones (resnet18/50/101, ``fine_tuning/
finetune.py:82-101``) and the ResNet half of the mudipath baseline
(``embedders/mudipath.py:49-86``: headless features + global average pool).

Plain ``nn.Module``s of ``torch.nn`` layers (torchvision is not a dependency)
whose module names are torchvision's, so a torchvision state_dict loads with
a checked ``load_state_dict`` (``from_torch_state_dict``). The convolutions
are ``F.conv2d`` (cuDNN on the card), as the JAX package's are XLA's.
Inputs are NHWC, as in the JAX package.

BatchNorm is ``nn.BatchNorm2d`` (momentum 0.1, eps 1e-5): in eval mode it
normalizes with the running statistics; in train mode with the batch's and
it updates the running statistics, buffers no optimizer steps. The running
variance takes the batch's unbiased variance, as torchvision's BatchNorm
does under the reference's ``model.train()``; the JAX package's functional
BN takes the biased one (``plip_tpu/models/resnet.py:53-58``), a fault the
port does not copy.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

ARCHS = {
    "resnet18": {"block": "basic", "layers": [2, 2, 2, 2]},
    "resnet34": {"block": "basic", "layers": [3, 4, 6, 3]},
    "resnet50": {"block": "bottleneck", "layers": [3, 4, 6, 3]},
    "resnet101": {"block": "bottleneck", "layers": [3, 4, 23, 3]},
}


def conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    """A bias-free k x k convolution with torchvision's padding (k // 2)."""
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, width: int, stride: int):
        super().__init__()
        self.conv1 = conv(cin, width, 3, stride)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = conv(width, width, 3)
        self.bn2 = nn.BatchNorm2d(width)
        self.downsample = _downsample(cin, width, stride)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + (x if self.downsample is None else self.downsample(x)))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int):
        super().__init__()
        self.conv1 = conv(cin, width, 1)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = conv(width, width, 3, stride)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = conv(width, width * 4, 1)
        self.bn3 = nn.BatchNorm2d(width * 4)
        self.downsample = _downsample(cin, width * 4, stride)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return torch.relu(y + (x if self.downsample is None else self.downsample(x)))


def _downsample(cin: int, cout: int, stride: int) -> Optional[nn.Sequential]:
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(conv(cin, cout, 1, stride), nn.BatchNorm2d(cout))


class ResNet(nn.Module):
    """``forward_features``: NHWC image -> pooled features ``[B, C]``;
    ``forward``: those through the ``fc`` head where the model has one."""

    def __init__(self, arch: str = "resnet50", num_classes: Optional[int] = None):
        super().__init__()
        spec = ARCHS[arch]
        self.arch = arch
        block = BasicBlock if spec["block"] == "basic" else Bottleneck
        self.conv1 = conv(3, 64, 7, 2)
        self.bn1 = nn.BatchNorm2d(64)
        cin, width = 64, 64
        for li, n_blocks in enumerate(spec["layers"]):
            blocks = []
            for bi in range(n_blocks):
                blocks.append(block(cin, width, 2 if (li > 0 and bi == 0) else 1))
                cin = width * block.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
            width *= 2
        self.fc = nn.Linear(cin, num_classes) if num_classes else None

    def forward_features(self, pixels: torch.Tensor) -> torch.Tensor:
        y = pixels.permute(0, 3, 1, 2)  # NHWC -> NCHW (a channels-last view)
        y = torch.relu(self.bn1(self.conv1(y)))
        y = torch.nn.functional.max_pool2d(y, 3, 2, 1)
        for li in range(len(ARCHS[self.arch]["layers"])):
            y = getattr(self, f"layer{li + 1}")(y)
        return y.mean(dim=(2, 3))  # global average pool

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        feats = self.forward_features(pixels)
        return feats if self.fc is None else self.fc(feats)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "ResNet":
        """The JAX package's scheme, drawn from ``generator``: convolutions
        N(0, 2 / fan_in), BN scale 1, bias 0, mean 0, var 1, ``fc`` N(0, 0.01^2)
        and bias 0."""
        init_cnn_(self, generator)
        if self.fc is not None:
            self.fc.weight.copy_(torch.randn(self.fc.weight.shape, generator=generator) * 0.01)
            self.fc.bias.zero_()
        return self


@torch.no_grad()
def init_cnn_(model: nn.Module, generator: torch.Generator) -> None:
    """Convolutions N(0, 2 / fan_in) in module order; BN to the identity."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * np.sqrt(2.0 / fan_in))
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


def n_features(arch: str) -> int:
    return 512 if ARCHS[arch]["block"] == "basic" else 2048


def from_torch_state_dict(sd: Mapping[str, Any], arch: str,
                          include_fc: bool = False) -> ResNet:
    """A torchvision resnet state_dict (``conv1.weight``, ``bn1.*``,
    ``layerN.M.convK/bnK/downsample.{0,1}``, ``fc.*``) -> a ``ResNet``, by a
    strict ``load_state_dict``: every key the model has must be there, and no
    other (``fc.*`` only with ``include_fc``; a missing
    ``num_batches_tracked`` counts 0)."""
    sd = dict(sd)
    num_classes = None
    if include_fc and "fc.weight" in sd:
        num_classes = sd["fc.weight"].shape[0]
    else:
        sd = {k: v for k, v in sd.items() if not k.startswith("fc.")}
    model = ResNet(arch, num_classes)
    load_bn_state_dict(model, sd)
    return model


def load_bn_state_dict(model: nn.Module, sd: Mapping[str, Any]) -> None:
    """``model.load_state_dict(sd)``, strict, with values as tensors and a
    missing BatchNorm ``num_batches_tracked`` counted 0."""
    sd = {k: v if torch.is_tensor(v) else torch.tensor(np.asarray(v)) for k, v in sd.items()}
    for k in model.state_dict():
        if k.endswith("num_batches_tracked"):
            sd.setdefault(k, torch.zeros((), dtype=torch.long))
    model.load_state_dict(sd)


def _oihw(w) -> np.ndarray:
    """JAX conv weight HWIO -> torch OIHW."""
    return np.ascontiguousarray(np.asarray(w, np.float32).transpose(3, 2, 0, 1))


def bn_state(prefix: str, p: Mapping) -> Dict[str, np.ndarray]:
    """The JAX package's BN leaves ``scale/bias/mean/var`` -> torch names."""
    return {f"{prefix}.{t}": np.asarray(p[j], np.float32) for t, j in (
        ("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
        ("running_var", "var"))}


def from_jax_params(params: Mapping, arch: str) -> ResNet:
    """The JAX package's ResNet tree (HWIO kernels; ``layerN`` lists; ``fc``
    where it has one) -> a ``ResNet`` holding the same numbers."""
    spec = ARCHS[arch]
    n_convs = 2 if spec["block"] == "basic" else 3
    sd = {"conv1.weight": _oihw(params["conv1"]), **bn_state("bn1", params["bn1"])}
    for li in range(len(spec["layers"])):
        for bi, p in enumerate(params[f"layer{li + 1}"]):
            pre = f"layer{li + 1}.{bi}"
            for ci in range(1, n_convs + 1):
                sd[f"{pre}.conv{ci}.weight"] = _oihw(p[f"conv{ci}"])
                sd.update(bn_state(f"{pre}.bn{ci}", p[f"bn{ci}"]))
            if "downsample" in p:
                sd[f"{pre}.downsample.0.weight"] = _oihw(p["downsample"]["conv"])
                sd.update(bn_state(f"{pre}.downsample.1", p["downsample"]["bn"]))
    num_classes = None
    if "fc" in params:
        kernel = np.asarray(params["fc"]["kernel"], np.float32)
        num_classes = kernel.shape[1]
        sd["fc.weight"] = np.ascontiguousarray(kernel.T)
        sd["fc.bias"] = np.asarray(params["fc"]["bias"], np.float32)
    model = ResNet(arch, num_classes)
    load_bn_state_dict(model, sd)
    return model
