"""Public PLIP API on PyTorch: the port of ``plip_tpu.api.PLIP``.

Same surface: ``PLIP(model_name)``, ``encode_images``, ``encode_text``,
``zero_shot_classification``, ``build_image_index`` / ``set_image_index`` /
``image_vectors``, ``retrieval`` and ``save``. Embeddings are
**unnormalized**, as in the JAX package and the reference.

- Checkpoints: the native ``.npz`` (either package's), the
  ``PLIP_TPU_CHECKPOINT`` env var, or ``random:<arch>`` for weights drawn
  from a seeded ``torch.Generator``. An unknown name falls back to a random
  ViT-B/32 with a warning (there is no network to fetch weights from).
- Batches are not padded: PyTorch runs eagerly, so a short last batch costs
  no recompile, and every row's embedding is independent of its batch.
- Retrieval runs on the host (numpy argsort over the full score matrix, the
  reference's semantics).
"""

from __future__ import annotations

import concurrent.futures
import os
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import native
from .data.datasets import load_image_rgb
from .models.clip import CLIP
from .models.config import ARCHITECTURES, CLIPConfig
from .ops.preprocess import preprocess_batch, preprocess_images
from .tokenizer import default_tokenizer
from .utils import resolve_device
from .utils.checkpoint import load_checkpoint, save_checkpoint


def _pil_fixed(path: str, n_px: int) -> np.ndarray:
    """PIL decode for a slot the native fast lane failed or resampled:
    bicubic shortest-side resize to ``n_px`` + center crop (the reference's
    eval-transform geometry)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    scale = n_px / min(w, h)
    rw = max(n_px, round(w * scale))
    rh = max(n_px, round(h * scale))
    if (rw, rh) != (w, h):
        img = img.resize((rw, rh), Image.BICUBIC)
    left, top = (rw - n_px) // 2, (rh - n_px) // 2
    return np.asarray(img.crop((left, top, left + n_px, top + n_px)), np.uint8)


class PLIP:
    """Pathology Language-Image Pretraining model on PyTorch.

    Parameters
    ----------
    model_name: ``.npz`` checkpoint path, ``"random:ViT-B/32"`` style spec,
        or any string with ``PLIP_TPU_CHECKPOINT`` pointing at a checkpoint.
    auth_token: accepted for signature parity with the reference; unused.
    dtype: compute dtype of the towers (``torch.bfloat16`` or
        ``torch.float32``); parameters stay fp32.
    device: where the model runs; default ``"cuda"``. Without a CUDA device
        it raises unless the caller asks for ``device="cpu"``.
    """

    def __init__(
        self,
        model_name: str = "vinid/plip",
        auth_token: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        tokenizer=None,
        device=None,
    ):
        del auth_token  # parity-only
        self.device = resolve_device(device, "PLIP")
        self.model_name = model_name
        self.dtype = dtype
        model, self.cfg = self._load_model(model_name)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.tokenizer = tokenizer if tokenizer is not None else default_tokenizer()
        self.image_vectors = None

    @staticmethod
    def _load_model(model_name: str):
        if model_name.startswith("random:"):
            arch = model_name.split(":", 1)[1] or "ViT-B/32"
            cfg = ARCHITECTURES[arch]()
            return CLIP(cfg).init_params(torch.Generator().manual_seed(0)), cfg
        for cand in (model_name, os.environ.get("PLIP_TPU_CHECKPOINT")):
            if cand and os.path.exists(cand):
                if not cand.endswith(".npz"):
                    raise NotImplementedError(
                        f"{cand!r}: only native .npz checkpoints load so far "
                        "(torch state_dict import is a ROADMAP.md Queue 1 item); "
                        "convert it with plip_tpu's import_checkpoint script")
                state, cfg = load_checkpoint(cand)
                model = CLIP(cfg)
                model.load_state_dict(state)
                return model, cfg
        warnings.warn(
            f"Checkpoint {model_name!r} not found locally and this environment "
            "has no network access; falling back to a deterministic random "
            "ViT-B/32. Set PLIP_TPU_CHECKPOINT or pass a local path for real "
            "weights."
        )
        cfg = CLIPConfig.vit_b32()
        return CLIP(cfg).init_params(torch.Generator().manual_seed(0)), cfg

    def save(self, path: str, format: str = "npz") -> str:
        """Write the native flat ``.npz`` checkpoint (loads in plip_tpu too)."""
        if format != "npz":
            raise NotImplementedError(
                f"format={format!r}: only 'npz' is written so far (torch "
                "state_dict export is a ROADMAP.md Queue 1 item)")
        save_checkpoint(path, self.model, self.cfg)
        return path

    # ------------------------------------------------------------------
    # Encoding
    # ------------------------------------------------------------------

    def encode_images(self, images: Sequence, batch_size: int = 32,
                      num_workers: int = 8) -> np.ndarray:
        """Images (paths / PIL / HWC uint8 arrays) -> unnormalized
        ``[N, embed_dim]``.

        When every input is a JPEG path and the native decode pool
        (``plip_tpu_torch.native``) is built, batches decode through its
        ``decode_batch_fixed`` fast lane; a slot it failed or had to resample
        is decoded again with PIL's bicubic. Other paths are opened with PIL
        on ``num_workers`` threads. Preprocessing runs on the device."""
        images = list(images)
        if not images:
            return np.zeros((0, self.cfg.embed_dim), np.float32)
        n_px = self.cfg.vision.image_size
        fast = all(isinstance(im, str) and im.lower().endswith((".jpg", ".jpeg"))
                   for im in images) and native.available()
        outs = []
        with concurrent.futures.ThreadPoolExecutor(num_workers) as pool:
            for i in range(0, len(images), batch_size):
                chunk = images[i:i + batch_size]
                if fast:
                    batch, status = native.decode_batch_fixed(
                        chunk, shorter=n_px, crop=n_px, threads=num_workers)
                    for j, rc in enumerate(status):
                        if rc != 0:
                            batch[j] = _pil_fixed(chunk[j], n_px)
                    pixels = preprocess_batch(batch, n_px, device=self.device)
                else:
                    arrays = list(pool.map(load_image_rgb, chunk))
                    pixels = preprocess_images(arrays, n_px, device=self.device)
                with torch.inference_mode():
                    outs.append(self.model.encode_image(pixels, self.dtype))
        return torch.cat(outs).cpu().numpy()

    def encode_text(self, text: List[str], batch_size: int = 32) -> np.ndarray:
        """Texts -> unnormalized ``[N, embed_dim]``."""
        if len(text) == 0:
            return np.zeros((0, self.cfg.embed_dim), np.float32)
        ids = self.tokenizer.tokenize(list(text), self.cfg.text.context_length)
        ids = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        with torch.inference_mode():
            outs = [self.model.encode_text(ids[i:i + batch_size], self.dtype)
                    for i in range(0, len(text), batch_size)]
        return torch.cat(outs).cpu().numpy()

    # ------------------------------------------------------------------
    # Similarity / retrieval (numpy host math, the reference's semantics)
    # ------------------------------------------------------------------

    @staticmethod
    def _cosine_similarity(key_vectors: np.ndarray, space_vectors: np.ndarray,
                           normalize: bool = True) -> np.ndarray:
        if normalize:
            key_vectors = key_vectors / np.linalg.norm(
                key_vectors, ord=2, axis=-1, keepdims=True)
        return np.matmul(key_vectors, space_vectors.T)

    def _nearest_neighbours(self, k: int, key_vectors, space_vectors,
                            normalize: bool = True) -> np.ndarray:
        cosine_sim = self._cosine_similarity(
            np.asarray(key_vectors), np.asarray(space_vectors), normalize=normalize)
        return cosine_sim.argsort()[:, -k:][:, ::-1]

    def zero_shot_classification(self, images: Sequence, text_labels: List[str],
                                 batch_size: int = 8) -> List[str]:
        """Zero-shot classification; argmax over label-text similarity."""
        text_vectors = self.encode_text(text_labels, batch_size=batch_size)
        image_vectors = self.encode_images(images, batch_size=batch_size)
        preds = np.argmax(self._cosine_similarity(image_vectors, text_vectors), axis=-1)
        return [text_labels[idx] for idx in preds]

    def build_image_index(self, images: Sequence, batch_size: int = 32) -> np.ndarray:
        """Encode and store the retrieval corpus."""
        return self.set_image_index(self.encode_images(images, batch_size=batch_size))

    def set_image_index(self, vectors) -> np.ndarray:
        """Install precomputed embeddings as the retrieval corpus (the same as
        assigning ``image_vectors``)."""
        self.image_vectors = vectors
        return self.image_vectors

    def retrieval(self, queries: List[str], top_k: int = 10,
                  backend: str = "auto") -> np.ndarray:
        """Text -> image retrieval over the index: ``[Q, top_k]`` indices.

        backend: "host" (numpy argsort over the full ``[Q, N]`` scores);
        "auto" picks host; "device" is not ported yet."""
        if self.image_vectors is None:
            raise RuntimeError(
                "No image index: call build_image_index(images) (or assign "
                "`image_vectors`) before retrieval().")
        if backend not in ("auto", "host", "device"):
            raise ValueError(f"unknown retrieval backend {backend!r} "
                             "(expected 'auto', 'host', or 'device')")
        if backend == "device":
            raise NotImplementedError(
                "backend='device': the streaming device top-k is not ported yet "
                "(ROADMAP.md Queue 1: device retrieval); use 'host'")
        text_vectors = self.encode_text(queries, batch_size=8)
        return self._nearest_neighbours(
            k=top_k, key_vectors=text_vectors, space_vectors=self.image_vectors)
