"""Supervised fine-tuning: the port of ``plip_tpu.train.finetune`` (the
reference harness's ``fine_tuning/finetune.py``).

- Backbones (finetune.py:62-114): ``plip``/``clip``, a CLIP image tower and
  a linear head (``LinearClassifier``, embed_dim -> classes; the whole
  network trains); ``resnet18/34/50/101`` (``models.resnet``, a replaced
  ``fc``); ``vit_b_16``/``vit_b_32`` (``models.vit``, exact GELU at LN eps
  1e-6: K1's sublayer forward and K2's backward on the card). A ``clip``
  backbone with weights raises "This is wrong.", as the reference does.
- Optimizers (``_make_optimizer``), each stepping as optax does, with the
  cosine-warmup schedule read at the pre-increment step count: AdamW
  (``train.contrastive.FusedAdamW``; the decay on every parameter); Adagrad
  as ``optax.adagrad`` (accumulator 0.1, ``g * rsqrt(sum + 1e-7)`` where the
  sum is > 0), not ``torch.optim.Adagrad``'s defaults; Adam (the reference's
  copy-paste bug, 'Adam' building Adagrad, is not copied); SGD.
- BatchNorm running statistics are buffers: the forward in train mode moves
  them, the optimizer never steps them (``models.resnet``; their running
  variance is torch's unbiased one).
- ``accum_steps``: the summed per-sample cross-entropy of each micro-batch
  and its grads, divided once by the batch's count; refused for BatchNorm
  backbones (batch-coupled statistics) and for a batch it does not divide.
- Every backbone takes the CLIP mean and std, as the reference (and the JAX
  package, ``finetune.py:151-155``) preprocesses every backbone; the images
  are preprocessed on the device at the backbone's input size (the CLIP
  tower's ``image_size``: the JAX package preprocesses at 224 always).
- A batch runs on its real rows only: the loader's zero padding of the last
  batch (the JAX package's static shapes) never reaches the model, so a
  BatchNorm backbone's batch statistics are those of the real images.
- Weights: a CLIP ``.npz`` or torch state_dict (``utils.checkpoint.
  load_any_checkpoint``), a torchvision ResNet state_dict
  (``load_torch_file``: torch's ``weights_only=True`` loader).
- ``valid_evaluation`` scores F1 with the port's numpy ``eval.metrics``;
  ``tuner()`` imports pandas inside and returns the reference's
  ``performance_df`` (epoch, loss, f1_weighted, f1_macro [, f1_test_*]).

Entry points run on the card unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import dataclasses
import logging as _logging
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.datasets import ImageLabelDataset
from ..data.loader import PrefetchLoader
from ..eval.metrics import eval_metrics
from ..models.clip import CLIP
from ..models.config import ARCHITECTURES, CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
from ..models.layers import _normal_
from ..models.resnet import ResNet
from ..models.resnet import from_torch_state_dict as resnet_from_torch_state_dict
from ..models.vit import ARCHS as VIT_ARCHS
from ..models.vit import ViTClassifier
from ..ops.preprocess import preprocess_batch
from ..utils import resolve_device
from ..utils.checkpoint import load_any_checkpoint, load_torch_file
from .contrastive import FusedAdamW
from .scheduler import cosine_lr


class LinearClassifier(nn.Module):
    """The input_size -> num_classes linear head (finetune.py:17-26), the JAX
    package's ``{kernel [in, out], bias}``; fp32 logits."""

    def __init__(self, input_size: int, num_classes: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(input_size, num_classes))
        self.bias = nn.Parameter(torch.zeros(num_classes))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "LinearClassifier":
        _normal_(self.kernel, self.kernel.shape[0] ** -0.5, generator)
        self.bias.zero_()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.float() @ self.kernel + self.bias


class CLIPClassifier(nn.Module):
    """A CLIP image tower (``models.clip.VisionTower``) and a linear head."""

    def __init__(self, visual: nn.Module, head: LinearClassifier):
        super().__init__()
        self.visual, self.head = visual, head

    def forward(self, pixels: torch.Tensor, dtype: torch.dtype = torch.float32):
        return self.head(self.visual(pixels, dtype))


# ---------------------------------------------------------------------------
# Optimizers: optax's stepping
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OptState:
    """A step count and per-parameter accumulators, by parameter name."""

    count: int
    acc: Dict[str, torch.Tensor]


def _lr(schedule, count: int) -> float:
    return float(np.float32(schedule(count)))


class Adagrad:
    """``optax.adagrad``: the sum of squared grads starts at
    ``initial_accumulator_value``; the update is ``-lr * g * rsqrt(sum + eps)``
    where the sum is > 0, else 0."""

    def __init__(self, learning_rate, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7):
        self.schedule = learning_rate if callable(learning_rate) else (
            lambda _: learning_rate)
        self.initial, self.eps = initial_accumulator_value, eps

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        return OptState(0, {k: torch.full_like(p, self.initial,
                                                memory_format=torch.contiguous_format)
                            for k, p in params.items()})

    @torch.no_grad()
    def update_(self, params, grads, state: OptState) -> None:
        lr = _lr(self.schedule, state.count)
        state.count += 1
        for k, p in params.items():
            g, s = grads[k], state.acc[k]
            s.addcmul_(g, g)
            inv = torch.where(s > 0, torch.rsqrt(s + self.eps), torch.zeros_like(s))
            p.sub_(lr * (g * inv))


class SGD:
    """``optax.sgd`` without momentum: ``p - lr * g``."""

    def __init__(self, learning_rate):
        self.schedule = learning_rate if callable(learning_rate) else (
            lambda _: learning_rate)

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        return OptState(0, {})

    @torch.no_grad()
    def update_(self, params, grads, state: OptState) -> None:
        lr = _lr(self.schedule, state.count)
        state.count += 1
        for k, p in params.items():
            p.sub_(lr * grads[k])


def _make_optimizer(name: str, lr_schedule, weight_decay: float):
    """``init(params)`` and ``update_(params, grads, state)`` as optax's
    ``adamw`` / ``adagrad`` / ``adam`` / ``sgd``."""
    if name == "AdamW":
        return FusedAdamW(lr_schedule, weight_decay=weight_decay)
    if name == "Adagrad":
        return Adagrad(lr_schedule)
    if name == "Adam":
        return FusedAdamW(lr_schedule, weight_decay=0.0)  # reference bug (Adam→Adagrad) fixed
    if name == "SGD":
        return SGD(lr_schedule)
    raise ValueError(f"unknown optimizer {name!r}")


# ---------------------------------------------------------------------------
# The tuner
# ---------------------------------------------------------------------------


class FineTuner:
    """``args`` needs ``model_name`` and ``optimizer``, and ``PC_CLIP_ARCH``
    for a ``plip``/``clip`` backbone without weights. ``dtype``: the compute
    dtype of the transformer backbones (parameters stay fp32; the CNNs run
    fp32). ``device``: default ``"cuda"``; without a CUDA device it raises
    unless the caller asks for ``device="cpu"``."""

    def __init__(
        self,
        args=None,
        logging=None,
        backbone: Optional[str] = None,
        num_classes: Optional[int] = None,
        lr: float = 5e-5,
        weight_decay: float = 0.2,
        warmup: int = 0,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
        device=None,
    ):
        self.args = args
        self.logging = logging or _logging
        self.warmup = warmup
        self.hyper_params = {"lr": lr, "weight_decay": weight_decay}
        self.num_classes = num_classes
        self.dtype = dtype
        self.model_name = args.model_name
        self.device = resolve_device(device, "FineTuner")
        gen = torch.Generator().manual_seed(seed)
        self.image_size = 224

        if self.model_name in ("plip", "clip"):
            if backbone is not None:
                if self.model_name == "clip":
                    raise Exception("This is wrong.")  # finetune.py:76-78
                clip, self.clip_cfg = load_any_checkpoint(backbone)
            else:
                self.clip_cfg = ARCHITECTURES[getattr(args, "PC_CLIP_ARCH", "ViT-B/32")]()
                clip = CLIP(self.clip_cfg).init_params(gen)
            head = LinearClassifier(self.clip_cfg.embed_dim, num_classes).init_params(gen)
            model = CLIPClassifier(clip.visual, head)
            self.image_size = self.clip_cfg.vision.image_size
        elif self.model_name.startswith("resnet"):
            self.arch = self.model_name
            model = ResNet(self.arch, num_classes).init_params(gen)
            if backbone is not None:
                loaded = resnet_from_torch_state_dict(load_torch_file(backbone), self.arch)
                model.load_state_dict({**loaded.state_dict(), "fc.weight": model.fc.weight,
                                       "fc.bias": model.fc.bias})
        elif self.model_name.startswith("vit"):
            model = ViTClassifier(self.model_name, num_classes).init_params(gen)
            self.image_size = VIT_ARCHS[self.model_name].image_size
        else:
            raise Exception("No such model.")  # finetune.py:113-114
        self.model = model.to(self.device)

        # the reference applies the CLIP preprocess (CLIP mean/std) to every
        # backbone, resnets and vits included (finetune.py:232-236)
        self.image_mean, self.image_std = CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
        self.optimizer_name = getattr(args, "optimizer", "AdamW")

    # ------------------------------------------------------------------

    def _forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """fp32 logits of a preprocessed NHWC batch (finetune.py:165-172); a
        BatchNorm backbone normalizes as the model's mode says."""
        if self.model_name.startswith("resnet"):
            return self.model(pixels)
        return self.model(pixels, self.dtype)

    def _preprocess(self, images_u8) -> torch.Tensor:
        return preprocess_batch(images_u8, self.image_size, self.image_mean, self.image_std,
                                device=self.device)

    @torch.no_grad()
    def logits(self, images_u8) -> torch.Tensor:
        """Eval-mode fp32 logits of a uint8 NHWC batch (host or device)."""
        self.model.eval()
        return self._forward(self._preprocess(images_u8))

    def calculate_f1_score(self, outputs, labels, average="weighted"):
        predicted = np.argmax(np.asarray(outputs), axis=1)
        return eval_metrics(np.asarray(labels), predicted, average_method=average)["WF1"]

    def valid_evaluation(self, loader, batch_size):
        """(the sum of the per-batch mean cross-entropies (finetune.py:200),
        weighted F1, macro F1) over ``loader``'s ``((images, labels), n)``."""
        total_loss = 0.0
        outs, labs = [], []
        for (images, labels), n in loader:
            logits = self.logits(images[:n]).cpu().numpy()
            labels = np.asarray(labels[:n].cpu() if torch.is_tensor(labels) else labels[:n])
            logp = logits - logits.max(-1, keepdims=True)
            logp = logp - np.log(np.exp(logp).sum(-1, keepdims=True))
            total_loss += float(-logp[np.arange(len(labels)), labels].mean())
            outs.append(logits)
            labs.append(labels)
        outs = np.concatenate(outs)
        labs = np.concatenate(labs)
        return (
            total_loss,
            self.calculate_f1_score(outs, labs, "weighted"),
            self.calculate_f1_score(outs, labs, "macro"),
        )

    def train_step(self, opt, opt_state, images_u8, labels, accum_steps: int = 1,
                   micro_batch: Optional[int] = None) -> torch.Tensor:
        """One optimizer step on the batch's rows (uint8 NHWC images and int
        labels, host or device): the mean cross-entropy, over ``accum_steps``
        micro-batches of ``micro_batch`` rows summed and divided once.
        Returns the loss (a device scalar)."""
        self.model.train()
        params = dict(self.model.named_parameters())
        pixels = self._preprocess(images_u8)
        labels = torch.as_tensor(labels, device=self.device).long()
        n = pixels.shape[0]
        step = n if accum_steps == 1 else micro_batch
        loss = torch.zeros((), device=self.device)
        for off in range(0, n, step):
            part = F.cross_entropy(self._forward(pixels[off:off + step]),
                                   labels[off:off + step], reduction="sum")
            part.backward()
            loss += part.detach()
        cnt = max(n, 1)
        grads = {}
        for k, p in params.items():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            grads[k] = g.div_(cnt)
        opt.update_(params, grads, opt_state)
        self.model.zero_grad(set_to_none=True)
        return loss / cnt

    # ------------------------------------------------------------------

    def tuner(
        self,
        train_dataframe,
        validation_dataframe,
        test_dataframe=None,
        save_directory: str = "",
        batch_size: int = 4,
        epochs: int = 5,
        evaluation_steps: int = 500,
        num_workers: int = 4,
        accum_steps: int = 1,
    ):
        import pandas as pd

        train_ds = ImageLabelDataset(train_dataframe)
        valid_ds = ImageLabelDataset(validation_dataframe)
        num_batches_per_epoch = -(-len(train_ds) // batch_size)
        total_steps = num_batches_per_epoch * epochs
        schedule = cosine_lr(self.hyper_params["lr"], self.warmup, total_steps)
        opt = _make_optimizer(self.optimizer_name, schedule,
                              self.hyper_params["weight_decay"])
        if accum_steps > 1:
            if self.model_name.startswith("resnet"):
                raise ValueError(
                    "accum_steps > 1 is unsupported for BatchNorm backbones "
                    "(running stats are batch-coupled); use a ViT/CLIP "
                    "backbone or accum_steps=1"
                )
            if batch_size % accum_steps:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by accum_steps "
                    f"{accum_steps}"
                )
        self.opt_state = opt.init(dict(self.model.named_parameters()))

        def loader(ds):
            return PrefetchLoader(ds, batch_size, num_workers=num_workers, device=self.device)

        performance_df = pd.DataFrame(
            index=np.arange(epochs), columns=["epoch", "loss", "f1_weighted", "f1_macro"]
        )
        for epoch in range(epochs):
            for i, ((images, labels), n) in enumerate(loader(train_ds)):
                step = num_batches_per_epoch * epoch + i
                loss = self.train_step(opt, self.opt_state, images[:n], labels[:n],
                                       accum_steps, batch_size // accum_steps)
                self.logging.info(
                    f"[Train - this batch] epoch: {epoch}, batch: {i}, "
                    f"new learning rate: {schedule(step):.3e}, loss: {float(loss):.6f}"
                )
                if evaluation_steps and step % evaluation_steps == 0:
                    vl, f1w, f1m = self.valid_evaluation(loader(valid_ds), batch_size)
                    self.logging.info(
                        f"[Validation - this batch] epoch: {epoch}, batch: {i}, "
                        f"total loss: {vl}, f1_weighted: {f1w}, f1_macro: {f1m}"
                    )

            vl, f1w, f1m = self.valid_evaluation(loader(valid_ds), batch_size)
            performance_df.loc[epoch, "epoch"] = epoch
            performance_df.loc[epoch, "loss"] = vl
            performance_df.loc[epoch, "f1_weighted"] = f1w
            performance_df.loc[epoch, "f1_macro"] = f1m
            if test_dataframe is not None:
                _, f1tw, f1tm = self.valid_evaluation(
                    loader(ImageLabelDataset(test_dataframe)), batch_size)
                performance_df.loc[epoch, "f1_test_weighted"] = f1tw
                performance_df.loc[epoch, "f1_test_macro"] = f1tm

        performance_df["f1_weighted"] = performance_df["f1_weighted"].astype(float)
        performance_df["f1_macro"] = performance_df["f1_macro"].astype(float)
        return performance_df
