"""The contrastive tuner: the port of ``plip_tpu.train.clip_tuner`` for one
process on one device.

``CLIPTuner(args, logging, model_type, lr, weight_decay, warmup).tuner(
train_df, val_df, save_dir, batch_size, epochs, evaluation_steps,
num_workers)`` trains with the InfoNCE step of ``train.contrastive``, the
host crop of ``data.transform.TrainTransform`` and the device augmentation
of ``ops.augment``; it validates every ``evaluation_steps`` steps and after
each epoch, writes ``epoch_{e}{suffix}`` checkpoints as the native ``.npz``
(loadable by either package), and returns the suffix. ``train_df`` /
``val_df`` are anything with ``"image"`` and ``"caption"`` columns (a pandas
DataFrame, or a dict of lists; images are paths, PIL images or uint8
arrays). The module helpers ``image_embedder``, ``text_embedder`` and
``zero_shot_classification`` take a ``PLIP``, as the JAX package's do.

Not ported here: the mesh and the multi-process branches, and orbax
full-state checkpoints (ROADMAP.md).
"""

from __future__ import annotations

import logging as _logging
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from ..data.datasets import ImageCaptionDataset
from ..data.loader import PrefetchLoader
from ..data.transform import TrainTransform
from ..models.clip import CLIP
from ..models.config import ARCHITECTURES
from ..ops.augment import AugmentConfig, augment_batch
from ..ops.preprocess import preprocess_images
from ..tokenizer import default_tokenizer
from ..utils import resolve_device
from ..utils.checkpoint import load_any_checkpoint, save_checkpoint
from .contrastive import (clip_loss, init_train_state, load_train_state, make_optimizer,
                          make_train_step, save_train_state)


def _next_divisor(batch_size: int, current: int) -> Optional[int]:
    """Smallest accumulation count > ``current`` that divides the batch, or
    None when there is none."""
    for k in range(current + 1, batch_size + 1):
        if batch_size % k == 0:
            return k
    return None


class CLIPTuner:
    """``dtype``: compute dtype of the towers (parameters and optimizer state
    stay fp32). ``device``: where the model trains, default ``"cuda"``;
    without a CUDA device it raises unless the caller asks for
    ``device="cpu"``. ``px_size``: the training crop; 336 for
    ViT-L/14@336px, as in the JAX tuner. ``remat``: ``"auto"`` (``"mlp"`` at batch >= 64, else
    ``False``), or a policy of ``models.layers`` (``False``, ``True``, ``"mlp"``,
    ``"mlp_h1"``, ``"block"``). ``accum_steps``: an int,
    or ``"auto"``: the first step runs unaccumulated and, if it runs out of
    device memory (``torch.cuda.OutOfMemoryError``), is retried from the
    initial weights with the smallest accumulation that fits (the update is
    the same)."""

    def __init__(self, args=None, logging=None, model_type: str = "ViT-B/32",
                 lr: float = 5e-5, weight_decay: float = 0.2, warmup: int = 50,
                 px_size: int = 224, backbone: Optional[str] = None,
                 dtype: torch.dtype = torch.float32, device=None, seed: int = 0,
                 aug_cfg: Optional[AugmentConfig] = None, remat="auto", accum_steps=1):
        self.logging = logging or _logging
        self.warmup = warmup
        self.hyper_params = {"lr": lr, "weight_decay": weight_decay}
        self.dtype = dtype
        self.device = resolve_device(device, "CLIPTuner")
        self.seed = seed
        self.remat = remat
        self.accum_steps = accum_steps

        if backbone:  # a native .npz, or a torch state_dict in either naming
            model, self.cfg = load_any_checkpoint(backbone)
        else:
            self.cfg = ARCHITECTURES[model_type]()
            model = CLIP(self.cfg).init_params(torch.Generator().manual_seed(seed))
        self.model = model.to(self.device)

        first_resize = getattr(args, "first_resize", 512) if args else 512
        n_px = getattr(args, "pxsize", px_size) if args else px_size
        self.train_preprocess = TrainTransform(first_resize=first_resize, n_px=n_px)
        self.aug_cfg = aug_cfg if aug_cfg is not None else AugmentConfig(out_size=n_px)
        self.tokenizer = default_tokenizer()

    def _tokenize(self, captions) -> torch.Tensor:
        ids = self.tokenizer.tokenize(list(captions), self.cfg.text.context_length)
        return torch.as_tensor(ids, dtype=torch.long, device=self.device)

    @torch.no_grad()
    def valid_evaluation(self, validation_loader) -> float:
        """Sum of the per-batch mean InfoNCE losses."""
        total = 0.0
        for (images, captions), n in validation_loader:
            pixels = preprocess_images(list(images[:n]), self.cfg.vision.image_size,
                                       device=self.device)
            ids = self._tokenize(captions[:n])
            loss, _ = clip_loss(self.model, pixels, ids, self.dtype)
            total += float(loss)
        return total

    def tuner(self, train_dataframe, validation_dataframe, save_directory: str = ".",
              batch_size: int = 4, epochs: int = 5, evaluation_steps: int = 500,
              num_workers: int = 4, start_time: Optional[str] = None,
              resume_from: Optional[str] = None, save_full_state: bool = False) -> str:
        """Train loop. ``resume_from``: a checkpoint written with
        ``save_full_state=True`` by either package (params, optimizer state
        and step). Returns the suffix of the epoch checkpoints."""
        start_time = start_time or str(datetime.now())
        cfg = self.cfg
        train_ds = ImageCaptionDataset(train_dataframe, self.train_preprocess)
        valid_ds = ImageCaptionDataset(validation_dataframe)  # eval preprocess on device

        num_batches_per_epoch = -(-len(train_ds) // batch_size)
        opt = make_optimizer(base_lr=self.hyper_params["lr"], warmup=self.warmup,
                             total_steps=num_batches_per_epoch * epochs,
                             weight_decay=self.hyper_params["weight_decay"])
        auto_accum = self.accum_steps == "auto"
        accum = 1 if auto_accum else int(self.accum_steps)
        # "auto" may have to run the first step again from the start
        host_copy = ({k: v.detach().cpu().clone() for k, v in self.model.state_dict().items()}
                     if auto_accum and not resume_from else None)

        def fresh_state():
            if resume_from:
                state, _ = load_train_state(resume_from, opt, self.device)
                self.model = state.model
                return state
            if host_copy is not None:
                self.model.load_state_dict(host_copy)
            return init_train_state(self.model, opt)

        self.state = fresh_state()
        remat = ("mlp" if batch_size >= 64 else False) if self.remat == "auto" else self.remat

        def build_step(k):
            return make_train_step(cfg, opt, dtype=self.dtype, remat=remat, accum_steps=k)

        step_fn = build_step(accum)
        gen = torch.Generator().manual_seed(self.seed)  # augmentation draws

        def valid_loader():
            return PrefetchLoader(valid_ds, batch_size, num_workers=num_workers)

        for epoch in range(epochs):
            self.train_preprocess.epoch = epoch  # fresh deterministic crops
            train_loader = PrefetchLoader(train_ds, batch_size, num_workers=num_workers,
                                          device=self.device)
            train_loss_this_epoch = 0.0
            for i, ((images, captions), n) in enumerate(train_loader):
                if n < batch_size:
                    continue  # InfoNCE over arange labels needs full batches
                step = num_batches_per_epoch * epoch + i
                pixels = augment_batch(gen, images, self.aug_cfg)
                ids = self._tokenize(captions)
                if auto_accum and epoch == 0 and i == 0:
                    # the first step decides: every later step has its shapes
                    while True:
                        try:
                            self.state, metrics = step_fn(self.state, pixels, ids)
                            float(metrics["loss"])  # the step has run
                            break
                        except torch.cuda.OutOfMemoryError:
                            nxt = _next_divisor(batch_size, accum)
                            if nxt is None:
                                raise
                            self.logging.warning(
                                "train step OOM at accum_steps=%d; retrying with "
                                "gradient-exact accumulation accum_steps=%d (identical "
                                "update, 1/k activation memory)", accum, nxt)
                            accum = nxt
                            step_fn = build_step(accum)
                            if self.device.type == "cuda":
                                torch.cuda.empty_cache()
                            self.state = fresh_state()
                    host_copy = None  # settled
                else:
                    self.state, metrics = step_fn(self.state, pixels, ids)
                loss = float(metrics["loss"])
                train_loss_this_epoch += loss
                self.logging.info(
                    f"[Train - this batch] epoch: {epoch}, batch: {i}, loss: {loss:.4f}")
                if evaluation_steps and step % evaluation_steps == 0:
                    vloss = self.valid_evaluation(valid_loader())
                    self.logging.info(f"[Validation - this batch] epoch: {epoch}, "
                                      f"batch: {i}, total loss: {vloss}")

            self.logging.info(
                f"[Train - final] epoch: {epoch}, total loss: {train_loss_this_epoch}")
            vloss = self.valid_evaluation(valid_loader())
            self.logging.info(f"[Validation - final] epoch: {epoch}, total loss: {vloss}")
            ckpt_path = f"{save_directory}/epoch_{epoch}_{start_time}_model.npz"
            if save_full_state:
                save_train_state(ckpt_path, self.state, cfg)
            else:
                save_checkpoint(ckpt_path, self.model, cfg)
        return f"_{start_time}_model.npz"


# ---------------------------------------------------------------------------
# Module helpers (the reference's training_model/clip.py, the JAX package's
# plip_tpu.train.clip_tuner helpers)
# ---------------------------------------------------------------------------


def image_embedder(model, list_of_images, num_workers: int = 4, batch_size: int = 32):
    """model: a ``plip_tpu_torch.api.PLIP``. L2-normalized image embeddings."""
    emb = model.encode_images(list(list_of_images), batch_size=batch_size)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


def text_embedder(model, list_of_labels, num_workers: int = 1, batch_size: int = 32):
    """L2-normalized text embeddings."""
    emb = model.encode_text(list(list_of_labels), batch_size=batch_size)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


def zero_shot_classification(model, images, labels, num_workers: int = 1, batch_size: int = 32):
    """The label of each image: the argmax of its normalized embedding's dot
    with the labels' normalized text embeddings."""
    image_embeddings = image_embedder(model, images, num_workers, batch_size)
    text_embeddings = text_embedder(model, labels, num_workers, batch_size)
    score = image_embeddings.dot(text_embeddings.T)
    return [labels[np.argmax(i)] for i in score]
