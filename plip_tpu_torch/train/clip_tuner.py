"""The contrastive tuner: the port of ``plip_tpu.train.clip_tuner``.

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

Parallelism (``mesh=``, a ``dp x tp`` mesh, one process a device,
``parallel``): the model is placed on the mesh (``parallel.mesh.
shard_params``); every process reads the whole dataframe, takes its dp
rows of each global batch and augments them with a generator of its own
(the seed offset by the dp rank, so the ranks of a tp group draw alike);
the train step is the global-batch step of ``train.contrastive``; rank 0
alone logs and writes the ``.npz`` checkpoints, of the tree gathered over
tp. ``save_full_state="orbax"`` (the JAX value, kept so its scripts run)
writes the sharded ``torch.distributed.checkpoint`` directory, which
``resume_from`` reads under the same mesh. Two
faults of the JAX tuner are repaired here: validation splits each batch,
the remainder too, by the per-process shard and pads and masks it, so every
process computes the one-process scalar; and a process whose first step
fails with another error than an OOM tells its peers (``agree_max_int``)
before it raises, so none of them waits for it.
"""

from __future__ import annotations

import logging as _logging
import os
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from ..data.datasets import ImageCaptionDataset
from ..data.loader import PrefetchLoader
from ..data.transform import TrainTransform
from ..models.clip import CLIP, l2_normalize
from ..models.config import ARCHITECTURES
from ..ops.augment import AugmentConfig, augment_batch
from ..ops.preprocess import preprocess_images
from ..parallel import distributed
from ..parallel.mesh import (check_mesh, gather_params, gather_rows, local_rows,
                             shard_batch, shard_params)
from ..tokenizer import default_tokenizer
from ..utils import resolve_device
from ..utils.checkpoint import load_any_checkpoint, save_checkpoint
from .contrastive import (clip_loss, embedding_loss, init_train_state, load_train_state,
                          load_train_state_sharded, make_optimizer, make_train_step,
                          save_train_state, save_train_state_sharded)

_FAIL = 1 << 30  # agree_max_int's proposal: no accumulation left, or another error


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
    the same); under a mesh every process takes the largest factor any of
    them needs. ``mesh``: a ``parallel.mesh.Mesh`` (dp x tp; tp must divide
    both towers' heads); the weights are sharded over tp and become the
    first rank's of each group."""

    def __init__(self, args=None, logging=None, model_type: str = "ViT-B/32",
                 lr: float = 5e-5, weight_decay: float = 0.2, warmup: int = 50,
                 px_size: int = 224, backbone: Optional[str] = None,
                 dtype: torch.dtype = torch.float32, device=None, seed: int = 0,
                 aug_cfg: Optional[AugmentConfig] = None, remat="auto", accum_steps=1,
                 mesh=None):
        check_mesh(mesh, "CLIPTuner")
        self.mesh = mesh
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
        self.model = shard_params(model.to(self.device), mesh)

        first_resize = getattr(args, "first_resize", 512) if args else 512
        n_px = getattr(args, "pxsize", px_size) if args else px_size
        self.train_preprocess = TrainTransform(first_resize=first_resize, n_px=n_px)
        self.aug_cfg = aug_cfg if aug_cfg is not None else AugmentConfig(out_size=n_px)
        self.tokenizer = default_tokenizer()

    def _tokenize(self, captions) -> torch.Tensor:
        ids = self.tokenizer.tokenize(list(captions), self.cfg.text.context_length)
        return torch.as_tensor(ids, dtype=torch.long, device=self.device)

    def _info(self, msg: str) -> None:
        if distributed.rank() == 0:
            self.logging.info(msg)

    @torch.no_grad()
    def valid_evaluation(self, validation_loader) -> float:
        """Sum of the per-batch mean InfoNCE losses. Under a mesh every
        process embeds its ``local_rows`` of each batch (a remainder too; a
        process may hold none), the rows are gathered with the pad dropped,
        and each process gets the one-process scalar."""
        total = 0.0
        for (images, captions), n in validation_loader:
            if self.mesh is None:
                pixels = preprocess_images(list(images[:n]), self.cfg.vision.image_size,
                                           device=self.device)
                loss, _ = clip_loss(self.model, pixels, self._tokenize(captions[:n]),
                                    self.dtype)
            else:
                lo, hi, _ = local_rows(n, self.mesh)
                zi = zt = torch.zeros((0, self.cfg.embed_dim), device=self.device)
                if hi > lo:
                    pixels = preprocess_images(list(images[lo:hi]),
                                               self.cfg.vision.image_size, device=self.device)
                    zi = l2_normalize(self.model.encode_image(pixels, self.dtype))
                    zt = l2_normalize(self.model.encode_text(
                        self._tokenize(list(captions)[lo:hi]), self.dtype))
                loss, _ = embedding_loss(self.model, gather_rows(zi, n, self.mesh),
                                         gather_rows(zt, n, self.mesh))
            total += float(loss)
        return total

    def tuner(self, train_dataframe, validation_dataframe, save_directory: str = ".",
              batch_size: int = 4, epochs: int = 5, evaluation_steps: int = 500,
              num_workers: int = 4, start_time: Optional[str] = None,
              resume_from: Optional[str] = None, save_full_state=False) -> str:
        """Train loop. ``resume_from``: a checkpoint written with
        ``save_full_state=True`` by either package (params, optimizer state
        and step), or the directory ``save_full_state="orbax"`` writes.
        Returns the suffix of the epoch checkpoints. Under a mesh
        ``batch_size`` is the global batch and must divide over dp."""
        start_time = start_time or str(datetime.now())
        cfg = self.cfg
        train_ds = ImageCaptionDataset(train_dataframe, self.train_preprocess)
        valid_ds = ImageCaptionDataset(validation_dataframe)  # eval preprocess on device

        num_batches_per_epoch = -(-len(train_ds) // batch_size)
        opt = make_optimizer(base_lr=self.hyper_params["lr"], warmup=self.warmup,
                             total_steps=num_batches_per_epoch * epochs,
                             weight_decay=self.hyper_params["weight_decay"])
        dp = 1 if self.mesh is None else self.mesh.dp
        if batch_size % dp:
            raise ValueError(f"batch_size {batch_size} does not divide over dp={dp}")
        auto_accum = self.accum_steps == "auto"
        accum = 1 if auto_accum else int(self.accum_steps)
        # "auto" may have to run the first step again from the start
        host_copy = ({k: v.detach().cpu().clone() for k, v in self.model.state_dict().items()}
                     if auto_accum and not resume_from else None)

        def fresh_state():
            if resume_from:
                load = (load_train_state_sharded if os.path.isdir(resume_from)
                        else load_train_state)
                state, _ = load(resume_from, opt, self.device, mesh=self.mesh)
                self.model = state.model
                return state
            if host_copy is not None:
                self.model.load_state_dict(host_copy)
            return init_train_state(self.model, opt)

        self.state = fresh_state()
        remat = ("mlp" if batch_size >= 64 else False) if self.remat == "auto" else self.remat

        def build_step(k):
            return make_train_step(cfg, opt, dtype=self.dtype, remat=remat, accum_steps=k,
                                   mesh=self.mesh)

        step_fn = build_step(accum)
        # augmentation draws, decorrelated by dp rank (dp rank 0 draws as one
        # process; the ranks of a tp group hold the same rows and draw alike)
        dp_rank = 0 if self.mesh is None else self.mesh.dp_rank
        gen = torch.Generator().manual_seed(self.seed + (dp_rank << 32))

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
                if self.mesh is not None:  # this process's rows of the global batch
                    images, captions = shard_batch((images, list(captions)), self.mesh)
                pixels = augment_batch(gen, images, self.aug_cfg)
                ids = self._tokenize(captions)
                if auto_accum and epoch == 0 and i == 0:
                    # the first step decides: every later step has its shapes
                    while True:
                        err, proposal = None, accum
                        try:
                            self.state, metrics = step_fn(self.state, pixels, ids)
                            float(metrics["loss"])  # the step has run
                        except torch.cuda.OutOfMemoryError as e:
                            err = e
                            nxt = _next_divisor(batch_size // dp, accum)
                            proposal = _FAIL if nxt is None else nxt
                        except Exception:
                            distributed.agree_max_int(_FAIL)  # no peer waits for us
                            raise
                        # every process takes the largest factor any needs
                        agreed = distributed.agree_max_int(proposal)
                        if agreed >= _FAIL:
                            if err is not None:
                                raise err
                            raise RuntimeError(
                                "auto accum_steps: a peer process failed its first step "
                                "(an OOM with no batch divisor left, or another error)")
                        if agreed == accum and err is None:
                            break
                        self.logging.warning(
                            "train step OOM at accum_steps=%d (%s); retrying with "
                            "gradient-exact accumulation accum_steps=%d (identical "
                            "update, 1/k activation memory)", accum,
                            "locally" if err is not None else "on a peer", agreed)
                        accum = agreed
                        step_fn = build_step(accum)
                        if self.device.type == "cuda":
                            torch.cuda.empty_cache()
                        self.state = fresh_state()
                    host_copy = None  # settled
                else:
                    self.state, metrics = step_fn(self.state, pixels, ids)
                loss = float(metrics["loss"])
                train_loss_this_epoch += loss
                self._info(f"[Train - this batch] epoch: {epoch}, batch: {i}, "
                           f"loss: {loss:.4f}")
                if evaluation_steps and step % evaluation_steps == 0:
                    vloss = self.valid_evaluation(valid_loader())
                    self._info(f"[Validation - this batch] epoch: {epoch}, "
                               f"batch: {i}, total loss: {vloss}")

            self._info(f"[Train - final] epoch: {epoch}, total loss: {train_loss_this_epoch}")
            vloss = self.valid_evaluation(valid_loader())
            self._info(f"[Validation - final] epoch: {epoch}, total loss: {vloss}")
            ckpt_path = f"{save_directory}/epoch_{epoch}_{start_time}_model.npz"
            if save_full_state == "orbax":
                save_train_state_sharded(ckpt_path.replace(".npz", ".orbax"), self.state,
                                         cfg, self.mesh)
            elif save_full_state:
                save_train_state(ckpt_path, self.state, cfg, self.mesh)
            else:
                full = gather_params(self.model, self.mesh)
                if distributed.rank() == 0:
                    save_checkpoint(ckpt_path, full, cfg)
                distributed.barrier()
        ext = "orbax" if save_full_state == "orbax" else "npz"
        return f"_{start_time}_model.{ext}"


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
