"""Checkpoints in the JAX package's native format, and its parameters.

The native format (``plip_tpu.utils.checkpoint.save_checkpoint``) is one
flat ``.npz``: every fp32 leaf of the parameter tree under its ``/``-joined
path, the transformer blocks stacked on a leading layer axis
(``visual/blocks/attn/qkv/kernel`` is ``[layers, W, 3W]``), and the config as
JSON bytes under ``__config__``. A file saved by either package loads in the
other.

The port's state is a ``CLIP`` state_dict: the same names with ``.`` for
``/`` and one entry per layer (``visual.blocks.3.attn.qkv.kernel``). The
layouts are kept as they are: ``[in, out]`` weight matrices, the
``[patch*patch*3, W]`` patch embed over row-major ``(ph, pw, C)`` patches,
qkv columns ``[q heads | k heads | v heads]``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch

from ..models.clip import CLIP
from ..models.config import CLIPConfig, TextConfig, VisionConfig

StateDict = Dict[str, torch.Tensor]


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, val in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def _layers(cfg: CLIPConfig, tower: str) -> int:
    return {"visual": cfg.vision.layers, "text": cfg.text.layers}[tower]


def _state_from_flat(flat: Mapping[str, np.ndarray], cfg: CLIPConfig) -> StateDict:
    sd = {}
    for path, arr in flat.items():
        parts = path.split("/")
        if len(parts) > 2 and parts[1] == "blocks":
            rest = ".".join(parts[2:])
            if arr.shape[0] != _layers(cfg, parts[0]):
                raise ValueError(f"{path}: {arr.shape[0]} stacked layers, config "
                                 f"says {_layers(cfg, parts[0])}")
            for i in range(arr.shape[0]):
                sd[f"{parts[0]}.blocks.{i}.{rest}"] = torch.tensor(arr[i])
        else:
            sd[".".join(parts)] = torch.tensor(arr)
    return sd


def from_jax_params(params: Mapping, cfg: CLIPConfig) -> StateDict:
    """The JAX package's parameter tree (numpy leaves, e.g.
    ``jax.device_get(plip_tpu.models.clip.init_params(...))``) -> a ``CLIP``
    state_dict."""
    return _state_from_flat(_flatten(params), cfg)


def to_jax_params(state: Union[StateDict, CLIP], cfg: CLIPConfig) -> dict:
    """A ``CLIP`` (or its state_dict) -> the JAX package's parameter tree,
    numpy fp32 leaves with the blocks restacked on a leading layer axis."""
    if isinstance(state, CLIP):
        state = state.state_dict()
    flat, stacks = {}, {}
    for name, t in state.items():
        parts = name.split(".")
        arr = t.detach().to("cpu", torch.float32).numpy()
        if len(parts) > 3 and parts[1] == "blocks":
            key = "/".join([parts[0], "blocks", *parts[3:]])
            stacks.setdefault(key, {})[int(parts[2])] = arr
        else:
            flat["/".join(parts)] = arr
    for key, per_layer in stacks.items():
        if sorted(per_layer) != list(range(_layers(cfg, key.split("/")[0]))):
            raise ValueError(f"{key}: layers {sorted(per_layer)} do not match the config")
        flat[key] = np.stack([per_layer[i] for i in range(len(per_layer))])
    return _unflatten(flat)


def cfg_to_json(cfg: CLIPConfig) -> str:
    """CLIPConfig -> the JSON the JAX package writes (same keys, same order)."""
    return json.dumps(
        {
            "vision": dataclasses.asdict(cfg.vision),
            "text": dataclasses.asdict(cfg.text),
            "embed_dim": cfg.embed_dim,
            "logit_scale_init": cfg.logit_scale_init,
            "logit_scale_max": cfg.logit_scale_max,
            "ln_eps": cfg.ln_eps,
        }
    )


def cfg_from_json(s: str) -> CLIPConfig:
    c = json.loads(s)
    return CLIPConfig(
        vision=VisionConfig(**c["vision"]),
        text=TextConfig(**c["text"]),
        embed_dim=c["embed_dim"],
        logit_scale_init=c["logit_scale_init"],
        logit_scale_max=c["logit_scale_max"],
        ln_eps=c["ln_eps"],
    )


def save_checkpoint(path: str, state: Union[StateDict, CLIP], cfg: CLIPConfig) -> None:
    """Write the native flat ``.npz`` (loads in either package)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = _flatten(to_jax_params(state, cfg))
    cfg_bytes = np.frombuffer(cfg_to_json(cfg).encode(), dtype=np.uint8)
    np.savez(path, __config__=cfg_bytes, **flat)


def load_checkpoint(path: str) -> Tuple[StateDict, CLIPConfig]:
    """Read a native ``.npz`` -> (``CLIP`` state_dict, config)."""
    with np.load(path, allow_pickle=False) as data:
        cfg = cfg_from_json(bytes(data["__config__"]).decode())
        flat = {k: data[k] for k in data.files if k != "__config__"}
    return _state_from_flat(flat, cfg), cfg
