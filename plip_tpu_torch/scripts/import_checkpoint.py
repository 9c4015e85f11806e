"""Import PyTorch CLIP weights as a native checkpoint plus golden embeddings:
the port of ``plip_tpu.scripts.import_checkpoint``.

Usage::

    python -m plip_tpu_torch.scripts.import_checkpoint <weights> [--vocab <path>]
        [--out DIR] [--threshold 0.999] [--probes 4] [--skip-verify] [--device cpu]
        [--allow-pickle]

Given an HF ``CLIPModel`` or OpenAI ``clip`` dump (a ``.bin``/``.pt``/``.pth``
torch file, a ``.safetensors`` file, an HF model directory, or a native
``.npz``) it:

0. loads a torch file with torch's safe ``weights_only=True`` loader, as
   ``PLIP(path)`` does; a file that pickles more than tensors (a whole
   module) is refused unless ``--allow-pickle`` is given, which runs the
   file's pickled code: only for a file you trust;

1. converts the weights (either naming, fp32/fp16/bf16) to the native flat
   ``.npz``;
2. runs the port's fp32 towers on deterministic probe inputs on ``--device``
   (default: the CUDA device);
3. verifies them against HF ``transformers.CLIPModel`` run as a black box on
   the CPU (an OpenAI-named dict is re-keyed first): every row's cosine must
   reach ``--threshold``. ``transformers`` is imported only here; without it
   the import stops and names ``--skip-verify``;
4. writes ``model.npz`` and ``model.golden.npz`` (probe inputs and the
   port's embeddings, the JAX importer's keys) into ``--out``: a fixture
   that either package's golden test replays (``PLIP_TPU_GOLDEN_DIR``);
5. with ``--vocab`` (OpenAI merges file or HF ``vocab.json``/``merges.txt``
   directory), checks it against the checkpoint (vocab size, EOT id), saves
   it in HF format beside the checkpoint and tokenizes the probe texts with
   it.

It prints one JSON summary, the JAX importer's.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pickle
import sys

import numpy as np
import torch

from ..models.clip import CLIP
from ..utils import resolve_device
from ..utils.checkpoint import (from_torch_state_dict, load_checkpoint, load_safetensors,
                                openai_sd_to_hf_sd, save_checkpoint)

PROBE_TEXTS = [
    "An H&E image patch of colorectal adenocarcinoma epithelium.",
    "a photo of benign tissue",
    "An H&E image of malignant breast tissue.",
    "normal colon mucosa",
]


def config(argv=None):
    parser = argparse.ArgumentParser(
        description="Import a PyTorch CLIP checkpoint (HF or OpenAI naming) "
        "into the native format, verify fidelity, and emit golden fixtures.")
    parser.add_argument("weights", type=str, help="torch file / safetensors / HF dir")
    parser.add_argument("--vocab", type=str, default=None,
                        help="OpenAI merges file or HF vocab dir")
    parser.add_argument("--out", type=str, default=None,
                        help="output dir (default: <weights dir>/plip_tpu_import)")
    parser.add_argument("--threshold", type=float, default=0.999)
    parser.add_argument("--probes", type=int, default=4)
    parser.add_argument("--skip-verify", action="store_true",
                        help="convert without the torch black-box check")
    parser.add_argument("--device", type=str, default=None,
                        help="where the probe forwards run (default: the CUDA device)")
    parser.add_argument("--allow-pickle", action="store_true",
                        help="load a torch file that pickles more than tensors (runs its "
                        "code: only for a trusted file)")
    return parser.parse_args(argv)


def _load_state_dict(path: str, allow_pickle: bool = False):
    """Resolve a weights path to a flat state_dict (HF or OpenAI naming)."""
    if os.path.isdir(path):
        for pattern in ("model.safetensors", "pytorch_model.bin", "*.safetensors",
                        "*.bin", "*.pt", "*.pth"):
            hits = sorted(glob.glob(os.path.join(path, pattern)))
            if hits:
                return _load_state_dict(hits[0], allow_pickle)
        raise FileNotFoundError(f"no weights file found under {path!r}")
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        if not allow_pickle:
            raise ValueError(
                f"{path!r} pickles more than tensors (a whole module?), which torch's "
                "safe loader refuses; pass --allow-pickle to load it with its code run, "
                "only if you trust the file") from e
        sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if isinstance(sd, dict) and "state_dict" in sd and not any(
            k.startswith(("visual.", "vision_model.")) for k in sd):
        sd = sd["state_dict"]
    return sd


def _probe_inputs(cfg, n: int, tokenizer=None):
    rng = np.random.default_rng(0)
    pixels = rng.standard_normal(
        (n, cfg.vision.image_size, cfg.vision.image_size, 3)).astype(np.float32)
    if tokenizer is not None:
        texts = (PROBE_TEXTS * ((n + len(PROBE_TEXTS) - 1) // len(PROBE_TEXTS)))[:n]
        ids = tokenizer.tokenize(texts, context_length=cfg.text.context_length)
    else:
        # synthetic but well-formed: SOT + random content ids + EOT + zero pad
        sot, eot = cfg.text.vocab_size - 2, cfg.text.vocab_size - 1
        ids = np.zeros((n, cfg.text.context_length), np.int32)
        ids[:, 0] = sot
        for row in range(n):
            k = int(rng.integers(3, min(20, cfg.text.context_length - 2)))
            ids[row, 1:1 + k] = rng.integers(1, sot - 1, size=k)
            ids[row, 1 + k] = eot
    return pixels, ids.astype(np.int32)


def _torch_reference_embeddings(sd, cfg, pixels, ids):
    """HF ``CLIPModel`` built from the config and loaded with the dict, run on
    the CPU as a black box."""
    try:
        import transformers
    except ImportError as e:
        raise RuntimeError(
            "the fidelity check runs transformers.CLIPModel, and transformers is not "
            "installed: install it, or pass --skip-verify to convert without the "
            "check") from e

    if "visual.conv1.weight" in sd:
        sd = openai_sd_to_hf_sd(sd)
    hf_cfg = transformers.CLIPConfig(
        text_config={
            "hidden_size": cfg.text.width,
            "num_hidden_layers": cfg.text.layers,
            "num_attention_heads": cfg.text.heads,
            "vocab_size": cfg.text.vocab_size,
            "max_position_embeddings": cfg.text.context_length,
            "intermediate_size": cfg.text.width * 4,
            "hidden_act": "quick_gelu",
        },
        vision_config={
            "hidden_size": cfg.vision.width,
            "num_hidden_layers": cfg.vision.layers,
            "num_attention_heads": cfg.vision.heads,
            "image_size": cfg.vision.image_size,
            "patch_size": cfg.vision.patch_size,
            "intermediate_size": cfg.vision.width * 4,
            "hidden_act": "quick_gelu",
        },
        projection_dim=cfg.embed_dim,
    )
    model = transformers.CLIPModel(hf_cfg).eval()
    # load_state_dict casts fp16/bf16 values into the fp32 parameters
    tensors = {k: torch.as_tensor(v) for k, v in sd.items()}
    missing, unexpected = model.load_state_dict(tensors, strict=False)
    real_missing = [k for k in missing if "position_ids" not in k]
    if real_missing or unexpected:
        raise ValueError(
            f"state_dict does not fit the detected geometry: "
            f"missing={real_missing[:5]} unexpected={list(unexpected)[:5]}")
    with torch.no_grad():
        ref_img = model.get_image_features(
            pixel_values=torch.from_numpy(pixels.transpose(0, 3, 1, 2))).numpy()
        ref_txt = model.get_text_features(
            input_ids=torch.from_numpy(ids.astype(np.int64))).numpy()
    return ref_img, ref_txt


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def main(argv=None) -> dict:
    args = config(argv)
    device = resolve_device(args.device, "import_checkpoint")
    out_dir = args.out or os.path.join(
        os.path.dirname(os.path.abspath(args.weights)), "plip_tpu_import")
    os.makedirs(out_dir, exist_ok=True)

    # --- convert -------------------------------------------------------------
    if args.weights.endswith(".npz"):
        state, cfg = load_checkpoint(args.weights)
        sd = None
    else:
        sd = _load_state_dict(args.weights, args.allow_pickle)
        state, cfg = from_torch_state_dict(sd)

    # --- tokenizer asset -----------------------------------------------------
    tokenizer = None
    vocab_files = None
    if args.vocab:
        from ..tokenizer import load_hf_vocab, load_openai_bpe, save_hf_format

        if os.path.isdir(args.vocab):
            tokenizer = load_hf_vocab(os.path.join(args.vocab, "vocab.json"),
                                      os.path.join(args.vocab, "merges.txt"))
        else:
            tokenizer = load_openai_bpe(args.vocab)
        if tokenizer.vocab_size != cfg.text.vocab_size:
            raise ValueError(f"vocab size {tokenizer.vocab_size} != checkpoint embedding "
                             f"rows {cfg.text.vocab_size}")
        if tokenizer.eot_token != cfg.text.eot:
            raise ValueError(f"tokenizer EOT id {tokenizer.eot_token} != model EOT pooling "
                             f"position {cfg.text.eot}")
        vocab_files = save_hf_format(tokenizer, out_dir)

    # --- probe forwards (the port's fp32 towers, on the device) -------------
    pixels, ids = _probe_inputs(cfg, args.probes, tokenizer)
    model = CLIP(cfg)
    model.load_state_dict(state)
    model = model.to(device).eval()
    with torch.no_grad():
        our_img = model.encode_image(torch.as_tensor(pixels, device=device)).cpu().numpy()
        our_txt = model.encode_text(
            torch.as_tensor(ids, dtype=torch.long, device=device)).cpu().numpy()

    # --- verify against the torch black box ----------------------------------
    min_cos_img = min_cos_txt = float("nan")
    if not args.skip_verify:
        if sd is None:
            raise ValueError("--skip-verify required when importing from .npz "
                             "(no torch state_dict to verify against)")
        ref_img, ref_txt = _torch_reference_embeddings(sd, cfg, pixels, ids)
        min_cos_img = float(_cos(our_img, ref_img).min())
        min_cos_txt = float(_cos(our_txt, ref_txt).min())
        if min_cos_img < args.threshold or min_cos_txt < args.threshold:
            raise AssertionError(
                f"fidelity check FAILED: min cosine image={min_cos_img:.6f} "
                f"text={min_cos_txt:.6f} < threshold {args.threshold}")

    # --- write outputs ---------------------------------------------------------
    ckpt_path = os.path.join(out_dir, "model.npz")
    save_checkpoint(ckpt_path, model, cfg)
    golden_path = os.path.join(out_dir, "model.golden.npz")
    np.savez(
        golden_path,
        checkpoint=np.asarray("model.npz"),
        pixels=pixels,
        input_ids=ids,
        image_embeddings=our_img.astype(np.float32),
        text_embeddings=our_txt.astype(np.float32),
        min_cosine_image=np.float64(min_cos_img),
        min_cosine_text=np.float64(min_cos_txt),
        threshold=np.float64(args.threshold),
    )

    summary = {
        "checkpoint": ckpt_path,
        "golden": golden_path,
        "vocab": list(vocab_files) if vocab_files else None,
        "min_cosine_image": min_cos_img,
        "min_cosine_text": min_cos_txt,
        "verified": not args.skip_verify,
        "geometry": {
            "vision": f"{cfg.vision.width}x{cfg.vision.layers}/p{cfg.vision.patch_size}",
            "text": f"{cfg.text.width}x{cfg.text.layers}",
            "embed_dim": cfg.embed_dim,
        },
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
