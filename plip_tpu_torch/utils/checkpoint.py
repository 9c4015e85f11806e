"""Checkpoints: the JAX package's native format, its parameters, and torch
state_dicts in HF ``CLIPModel`` and OpenAI ``clip`` naming.

The native format (``plip_tpu.utils.checkpoint.save_checkpoint``) is one
flat ``.npz``: every fp32 leaf of the parameter tree under its ``/``-joined
path, the transformer blocks stacked on a leading layer axis
(``visual/blocks/attn/qkv/kernel`` is ``[layers, W, 3W]``), and the config as
JSON bytes under ``__config__``. A file saved by either package loads in the
other. A W8A8 model's quantized blocks (``ops.quant``) are written as the
JAX package writes them, int8 ``kernel_q`` and fp32 ``wscale`` in place of
``kernel``, and load back quantized.

The port's state is a ``CLIP`` state_dict: the same names with ``.`` for
``/`` and one entry per layer (``visual.blocks.3.attn.qkv.kernel``). The
layouts are kept as they are: ``[in, out]`` weight matrices, the
``[patch*patch*3, W]`` patch embed over row-major ``(ph, pw, C)`` patches,
qkv columns ``[q heads | k heads | v heads]``.

The published ``vinid/plip`` weights are a torch state_dict in one of two
namings: HF ``CLIPModel`` (``vision_model.*``, the hub's) and OpenAI ``clip``
(``visual.conv1.weight``, ``transformer.resblocks.*``, the reproducibility
harness's). ``from_hf_clip`` / ``from_openai_clip`` read either into a
``CLIP`` state_dict, ``to_openai_sd`` / ``to_hf_sd`` write one back, with the
geometry inferred as the JAX package infers it (heads = width // 64, image
size = grid x patch, layer counts from the keys). Every floating tensor is
taken to fp32 on the torch side first, so fp16 and bf16 files load too.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Callable, Dict, Mapping, Tuple, Union

import numpy as np
import torch

from ..models.clip import CLIP
from ..models.config import CLIPConfig, TextConfig, VisionConfig
from ..ops.quant import quantize_block_linears

StateDict = Dict[str, torch.Tensor]


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            v = np.asarray(v)
            out[f"{prefix}{k}"] = v if v.dtype == np.int8 else v.astype(np.float32)
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
        t = t.detach().cpu()
        arr = (t if t.dtype == torch.int8 else t.float()).numpy()  # W8A8's kernel_q
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


def load_any_checkpoint(path: str) -> Tuple[CLIP, CLIPConfig]:
    """A ``CLIP`` on the CPU from a native ``.npz`` or a torch state_dict file
    in either naming."""
    state, cfg = load_checkpoint(path) if path.endswith(".npz") else load_torch_checkpoint(path)
    model = CLIP(cfg)
    for name in state:  # a W8A8 .npz: quantize those blocks, then load their values
        if name.endswith(".kernel_q"):
            quantize_block_linears(model.get_submodule(name.rsplit(".", 1)[0]))
    model.load_state_dict(state)
    return model, cfg


# ---------------------------------------------------------------------------
# torch state_dicts: HF CLIPModel and OpenAI clip naming
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    """A tensor or array -> numpy on the host; floating values as fp32 (a
    bf16 tensor is cast by torch, since numpy has no bf16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.to("cpu", torch.float32) if x.is_floating_point() else x.cpu()).numpy()
    x = np.asarray(x)
    return x.astype(np.float32, copy=False) if np.issubdtype(x.dtype, np.floating) else x


def _num_layers(keys, pattern: str) -> int:
    rx = re.compile(pattern)
    idx = [int(m.group(1)) for k in keys for m in [rx.match(k)] if m]
    return max(idx) + 1 if idx else 0


def _config(v_width, v_layers, grid, patch, t_width, t_layers, vocab, ctx,
            embed_dim) -> CLIPConfig:
    return CLIPConfig(
        vision=VisionConfig(width=v_width, layers=v_layers, heads=max(1, v_width // 64),
                            image_size=grid * patch, patch_size=patch),
        text=TextConfig(width=t_width, layers=t_layers, heads=max(1, t_width // 64),
                        vocab_size=vocab, context_length=ctx),
        embed_dim=embed_dim,
    )


def _grid(n_pos: int) -> int:
    return int(round((n_pos - 1) ** 0.5))


def _tensor(v: np.ndarray) -> torch.Tensor:
    """A contiguous, writable CPU tensor of ``v`` (0-d stays 0-d)."""
    return torch.from_numpy(np.require(v, requirements=("C", "W")))


def _state(flat: Dict[str, np.ndarray], blocks: Callable[[str], Dict[str, np.ndarray]],
           layers: Dict[str, Tuple[str, int]]) -> StateDict:
    """A ``CLIP`` state_dict from the non-block leaves (``flat``, port names)
    and ``blocks(src_prefix)``, one layer's leaves under their names after
    ``{tower}.blocks.{i}.``; ``layers``: tower -> (source prefix of layer
    ``i`` with ``{i}``, layer count)."""
    sd = {k: _tensor(v) for k, v in flat.items()}
    for tower, (prefix, n) in layers.items():
        for i in range(n):
            for rest, v in blocks(prefix.format(i=i)).items():
                sd[f"{tower}.blocks.{i}.{rest}"] = _tensor(v)
    return sd


def from_hf_clip(sd: Mapping[str, Any]) -> Tuple[StateDict, CLIPConfig]:
    """An HF ``CLIPModel.state_dict()`` -> (``CLIP`` state_dict, config)."""
    sd = {k: _np(v) for k, v in sd.items()}
    v_width = sd["vision_model.embeddings.class_embedding"].shape[0]
    tok = sd["text_model.embeddings.token_embedding.weight"]
    v_layers = _num_layers(sd, r"vision_model\.encoder\.layers\.(\d+)\.")
    t_layers = _num_layers(sd, r"text_model\.encoder\.layers\.(\d+)\.")
    cfg = _config(
        v_width, v_layers,
        _grid(sd["vision_model.embeddings.position_embedding.weight"].shape[0]),
        sd["vision_model.embeddings.patch_embedding.weight"].shape[-1],
        tok.shape[1], t_layers, tok.shape[0],
        sd["text_model.embeddings.position_embedding.weight"].shape[0],
        sd["visual_projection.weight"].shape[0])

    def ln(dst, src):
        return {f"{dst}.scale": sd[f"{src}.weight"], f"{dst}.bias": sd[f"{src}.bias"]}

    def block(p):
        attn = f"{p}.self_attn"
        return {
            **ln("ln1", f"{p}.layer_norm1"),
            "attn.qkv.kernel": np.concatenate(
                [sd[f"{attn}.{n}_proj.weight"].T for n in "qkv"], axis=1),
            "attn.qkv.bias": np.concatenate([sd[f"{attn}.{n}_proj.bias"] for n in "qkv"]),
            "attn.out.kernel": sd[f"{attn}.out_proj.weight"].T,
            "attn.out.bias": sd[f"{attn}.out_proj.bias"],
            **ln("ln2", f"{p}.layer_norm2"),
            "mlp.fc1.kernel": sd[f"{p}.mlp.fc1.weight"].T,
            "mlp.fc1.bias": sd[f"{p}.mlp.fc1.bias"],
            "mlp.fc2.kernel": sd[f"{p}.mlp.fc2.weight"].T,
            "mlp.fc2.bias": sd[f"{p}.mlp.fc2.bias"],
        }

    conv = sd["vision_model.embeddings.patch_embedding.weight"]  # [W, 3, P, P]
    flat = {
        "visual.patch_embed.kernel": conv.transpose(2, 3, 1, 0).reshape(-1, v_width),
        "visual.class_embedding": sd["vision_model.embeddings.class_embedding"],
        "visual.pos_embed": sd["vision_model.embeddings.position_embedding.weight"],
        **ln("visual.ln_pre", "vision_model.pre_layrnorm"),  # sic: HF's own key name
        **ln("visual.ln_post", "vision_model.post_layernorm"),
        "visual.proj.kernel": sd["visual_projection.weight"].T,
        "text.token_embed": tok,
        "text.pos_embed": sd["text_model.embeddings.position_embedding.weight"],
        **ln("text.ln_final", "text_model.final_layer_norm"),
        "text.proj.kernel": sd["text_projection.weight"].T,
        "logit_scale": sd["logit_scale"].reshape(()),
    }
    return _state(flat, block, {"visual": ("vision_model.encoder.layers.{i}", v_layers),
                                "text": ("text_model.encoder.layers.{i}", t_layers)}), cfg


def from_openai_clip(sd: Mapping[str, Any]) -> Tuple[StateDict, CLIPConfig]:
    """An OpenAI ``clip`` state_dict (the ``vinid/plip`` torch.save format of
    the reproducibility harness) -> (``CLIP`` state_dict, config)."""
    sd = {k: _np(v) for k, v in sd.items()}
    v_width = sd["visual.class_embedding"].shape[0]
    tok = sd["token_embedding.weight"]
    v_layers = _num_layers(sd, r"visual\.transformer\.resblocks\.(\d+)\.")
    t_layers = _num_layers(sd, r"transformer\.resblocks\.(\d+)\.")
    cfg = _config(
        v_width, v_layers, _grid(sd["visual.positional_embedding"].shape[0]),
        sd["visual.conv1.weight"].shape[-1], tok.shape[1], t_layers, tok.shape[0],
        sd["positional_embedding"].shape[0], sd["text_projection"].shape[1])

    def ln(dst, src):
        return {f"{dst}.scale": sd[f"{src}.weight"], f"{dst}.bias": sd[f"{src}.bias"]}

    def block(p):
        return {
            **ln("ln1", f"{p}.ln_1"),
            "attn.qkv.kernel": sd[f"{p}.attn.in_proj_weight"].T,  # rows q, k, v
            "attn.qkv.bias": sd[f"{p}.attn.in_proj_bias"],
            "attn.out.kernel": sd[f"{p}.attn.out_proj.weight"].T,
            "attn.out.bias": sd[f"{p}.attn.out_proj.bias"],
            **ln("ln2", f"{p}.ln_2"),
            "mlp.fc1.kernel": sd[f"{p}.mlp.c_fc.weight"].T,
            "mlp.fc1.bias": sd[f"{p}.mlp.c_fc.bias"],
            "mlp.fc2.kernel": sd[f"{p}.mlp.c_proj.weight"].T,
            "mlp.fc2.bias": sd[f"{p}.mlp.c_proj.bias"],
        }

    conv = sd["visual.conv1.weight"]  # [W, 3, P, P], no bias
    flat = {
        "visual.patch_embed.kernel": conv.transpose(2, 3, 1, 0).reshape(-1, v_width),
        "visual.class_embedding": sd["visual.class_embedding"],
        "visual.pos_embed": sd["visual.positional_embedding"],
        **ln("visual.ln_pre", "visual.ln_pre"),
        **ln("visual.ln_post", "visual.ln_post"),
        "visual.proj.kernel": sd["visual.proj"],  # already [width, embed]
        "text.token_embed": tok,
        "text.pos_embed": sd["positional_embedding"],
        **ln("text.ln_final", "ln_final"),
        "text.proj.kernel": sd["text_projection"],  # already [width, embed]
        "logit_scale": sd["logit_scale"].reshape(()),
    }
    return _state(flat, block, {"visual": ("visual.transformer.resblocks.{i}", v_layers),
                                "text": ("transformer.resblocks.{i}", t_layers)}), cfg


# (OpenAI name, HF name) of a block's one-to-one leaves, after the layer prefix
_BLOCK_RENAMES = (
    ("attn.out_proj.weight", "self_attn.out_proj.weight"),
    ("attn.out_proj.bias", "self_attn.out_proj.bias"),
    ("ln_1.weight", "layer_norm1.weight"), ("ln_1.bias", "layer_norm1.bias"),
    ("ln_2.weight", "layer_norm2.weight"), ("ln_2.bias", "layer_norm2.bias"),
    ("mlp.c_fc.weight", "mlp.fc1.weight"), ("mlp.c_fc.bias", "mlp.fc1.bias"),
    ("mlp.c_proj.weight", "mlp.fc2.weight"), ("mlp.c_proj.bias", "mlp.fc2.bias"),
)
# the same of the non-block leaves (the projections transpose on top)
_RENAMES = (
    ("visual.class_embedding", "vision_model.embeddings.class_embedding"),
    ("visual.conv1.weight", "vision_model.embeddings.patch_embedding.weight"),
    ("visual.positional_embedding", "vision_model.embeddings.position_embedding.weight"),
    ("visual.ln_pre.weight", "vision_model.pre_layrnorm.weight"),
    ("visual.ln_pre.bias", "vision_model.pre_layrnorm.bias"),
    ("visual.ln_post.weight", "vision_model.post_layernorm.weight"),
    ("visual.ln_post.bias", "vision_model.post_layernorm.bias"),
    ("token_embedding.weight", "text_model.embeddings.token_embedding.weight"),
    ("positional_embedding", "text_model.embeddings.position_embedding.weight"),
    ("ln_final.weight", "text_model.final_layer_norm.weight"),
    ("ln_final.bias", "text_model.final_layer_norm.bias"),
)
_TOWERS = (("visual.transformer", "vision_model"), ("transformer", "text_model"))


def openai_sd_to_hf_sd(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Re-key an OpenAI ``clip`` state_dict into HF ``CLIPModel`` naming: the
    fused ``in_proj`` splits into q/k/v rows, the two projections transpose
    (``[W, E]`` -> ``[E, W]``)."""
    sd = {k: _np(v) for k, v in sd.items()}
    out: Dict[str, np.ndarray] = {"logit_scale": sd["logit_scale"]}
    for src_prefix, dst_prefix in _TOWERS:
        n = _num_layers(sd, re.escape(src_prefix) + r"\.resblocks\.(\d+)\.")
        for i in range(n):
            s, d = f"{src_prefix}.resblocks.{i}", f"{dst_prefix}.encoder.layers.{i}"
            w, b = sd[f"{s}.attn.in_proj_weight"], sd[f"{s}.attn.in_proj_bias"]
            width = w.shape[1]
            for j, name in enumerate("qkv"):
                out[f"{d}.self_attn.{name}_proj.weight"] = w[j * width:(j + 1) * width]
                out[f"{d}.self_attn.{name}_proj.bias"] = b[j * width:(j + 1) * width]
            for src, dst in _BLOCK_RENAMES:
                out[f"{d}.{dst}"] = sd[f"{s}.{src}"]
    for src, dst in _RENAMES:
        out[dst] = sd[src]
    out["visual_projection.weight"] = sd["visual.proj"].T
    out["text_projection.weight"] = sd["text_projection"].T
    return out


def hf_sd_to_openai_sd(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`openai_sd_to_hf_sd`."""
    sd = {k: _np(v) for k, v in sd.items()}
    out: Dict[str, np.ndarray] = {"logit_scale": sd["logit_scale"]}
    for dst_prefix, src_prefix in _TOWERS:
        n = _num_layers(sd, re.escape(src_prefix) + r"\.encoder\.layers\.(\d+)\.")
        for i in range(n):
            s, d = f"{src_prefix}.encoder.layers.{i}", f"{dst_prefix}.resblocks.{i}"
            for part in ("weight", "bias"):
                out[f"{d}.attn.in_proj_{part}"] = np.concatenate(
                    [sd[f"{s}.self_attn.{n_}_proj.{part}"] for n_ in "qkv"], 0)
            for dst, src in _BLOCK_RENAMES:
                out[f"{d}.{dst}"] = sd[f"{s}.{src}"]
    for dst, src in _RENAMES:
        out[dst] = sd[src]
    out["visual.proj"] = sd["visual_projection.weight"].T
    out["text_projection"] = sd["text_projection.weight"].T
    return out


def to_openai_sd(state: Union[StateDict, CLIP], cfg: CLIPConfig) -> Dict[str, np.ndarray]:
    """A ``CLIP`` (or its state_dict) -> an OpenAI ``clip`` state_dict of fp32
    numpy arrays, the exact inverse of :func:`from_openai_clip`."""
    if isinstance(state, CLIP):
        state = state.state_dict()
    p = {k: _np(v) for k, v in state.items()}
    W, P = cfg.vision.width, cfg.vision.patch_size
    out: Dict[str, np.ndarray] = {"logit_scale": p["logit_scale"].reshape(())}

    def put_ln(dst, src):
        out[f"{dst}.weight"], out[f"{dst}.bias"] = p[f"{src}.scale"], p[f"{src}.bias"]

    def put_blocks(dst_prefix, tower, n):
        for i in range(n):
            s, d = f"{tower}.blocks.{i}", f"{dst_prefix}.resblocks.{i}"
            out[f"{d}.attn.in_proj_weight"] = p[f"{s}.attn.qkv.kernel"].T
            out[f"{d}.attn.in_proj_bias"] = p[f"{s}.attn.qkv.bias"]
            out[f"{d}.attn.out_proj.weight"] = p[f"{s}.attn.out.kernel"].T
            out[f"{d}.attn.out_proj.bias"] = p[f"{s}.attn.out.bias"]
            put_ln(f"{d}.ln_1", f"{s}.ln1")
            put_ln(f"{d}.ln_2", f"{s}.ln2")
            out[f"{d}.mlp.c_fc.weight"] = p[f"{s}.mlp.fc1.kernel"].T
            out[f"{d}.mlp.c_fc.bias"] = p[f"{s}.mlp.fc1.bias"]
            out[f"{d}.mlp.c_proj.weight"] = p[f"{s}.mlp.fc2.kernel"].T
            out[f"{d}.mlp.c_proj.bias"] = p[f"{s}.mlp.fc2.bias"]

    # inverse of conv.transpose(2, 3, 1, 0).reshape(-1, W) at import
    out["visual.conv1.weight"] = (
        p["visual.patch_embed.kernel"].reshape(P, P, 3, W).transpose(3, 2, 0, 1))
    out["visual.class_embedding"] = p["visual.class_embedding"]
    out["visual.positional_embedding"] = p["visual.pos_embed"]
    put_ln("visual.ln_pre", "visual.ln_pre")
    put_blocks("visual.transformer", "visual", cfg.vision.layers)
    put_ln("visual.ln_post", "visual.ln_post")
    out["visual.proj"] = p["visual.proj.kernel"]  # [width, embed] both sides
    out["token_embedding.weight"] = p["text.token_embed"]
    out["positional_embedding"] = p["text.pos_embed"]
    put_blocks("transformer", "text", cfg.text.layers)
    put_ln("ln_final", "text.ln_final")
    out["text_projection"] = p["text.proj.kernel"]
    return out


def to_hf_sd(state: Union[StateDict, CLIP], cfg: CLIPConfig) -> Dict[str, np.ndarray]:
    """A ``CLIP`` (or its state_dict) -> an HF ``CLIPModel`` state_dict (fp32
    numpy), through the OpenAI export and the re-keyer."""
    return openai_sd_to_hf_sd(to_openai_sd(state, cfg))


def save_torch_checkpoint(path: str, state: Union[StateDict, CLIP], cfg: CLIPConfig,
                          naming: str = "openai") -> str:
    """``torch.save`` the exported state_dict (CPU tensors) to ``path``:
    ``naming="openai"`` (the reproducibility harness's per-epoch file) or
    ``"hf"`` (loads into ``transformers.CLIPModel``)."""
    if naming == "openai":
        sd = to_openai_sd(state, cfg)
    elif naming == "hf":
        sd = to_hf_sd(state, cfg)
    else:
        raise ValueError(f"naming must be 'openai' or 'hf', got {naming!r}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: _tensor(v) for k, v in sd.items()}, path)
    return path


def from_torch_state_dict(sd: Mapping[str, Any]) -> Tuple[StateDict, CLIPConfig]:
    """Either naming, told apart by a key only it has. The port's own ``CLIP``
    state_dict also starts with ``visual.`` but has neither key."""
    if "vision_model.embeddings.patch_embedding.weight" in sd:
        return from_hf_clip(sd)
    if "visual.conv1.weight" in sd:
        return from_openai_clip(sd)
    raise ValueError(
        "Unrecognized state_dict naming: expected HF CLIPModel ('vision_model.*') "
        "or OpenAI clip ('visual.*') keys (a state_dict of this package's CLIP is "
        "saved and loaded as a native .npz: utils.checkpoint.save_checkpoint)")


def load_torch_file(path: str) -> Mapping[str, Any]:
    """A torch state_dict file -> its mapping of CPU tensors, read with
    torch's safe ``weights_only=True`` loader, which refuses a file that
    pickles more than tensors (a whole module): unpickling would run its
    code (``scripts.import_checkpoint --allow-pickle`` is the explicit
    opt-in)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_torch_checkpoint(path: str) -> Tuple[StateDict, CLIPConfig]:
    """A CLIP state_dict file (either naming; ``load_torch_file``) ->
    (``CLIP`` state_dict, config)."""
    return from_torch_state_dict(load_torch_file(path))


# safetensors element types -> numpy (little-endian); BF16 is read as uint16
_SAFETENSORS_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2", "I64": "<i8", "I32": "<i4",
    "I16": "<i2", "I8": "i1", "U8": "u1", "U16": "<u2", "U32": "<u4", "U64": "<u8",
    "BOOL": "?",
}


def load_safetensors(path: str) -> StateDict:
    """A ``.safetensors`` file -> CPU tensors, read without the safetensors
    package: an 8-byte little-endian header length, a JSON header of
    ``{name: {dtype, shape, data_offsets}}``, then the raw little-endian
    buffers (offsets from the end of the header)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which is not read")
        begin, end = info["data_offsets"]
        dt = np.dtype(_SAFETENSORS_DTYPES[info["dtype"]])
        arr = np.frombuffer(data, dt, count=(end - begin) // dt.itemsize, offset=begin)
        t = torch.from_numpy(arr.reshape(info["shape"]).copy())
        out[name] = t.view(torch.bfloat16) if info["dtype"] == "BF16" else t
    return out
