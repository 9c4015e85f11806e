"""Contrastive (InfoNCE) CLIP training: the port of
``plip_tpu.train.contrastive``.

- ``clip_loss``: symmetric cross-entropy with ``arange(batch)`` labels.
- ``FusedAdamW`` / ``make_optimizer``: AdamW with the JAX package's
  stepping (the learning rate at the pre-increment count, bias correction at
  count + 1, decay ``lr * wd * p``), as a few multi-tensor ops over all
  parameters, updated in place.
- ``clamp_logit_scale_``: ``logit_scale`` clamped to [0, ln 100] after each
  update.
- ``make_train_step``: one plain Python step (no ``torch.compile``); with
  ``accum_steps > 1`` the gradient-exact two-pass InfoNCE accumulation
  (``_accum_infonce_grads``).
- ``save_train_state`` / ``load_train_state``: the JAX package's ``.npz``
  plus ``.opt.npz`` layout and leaf order, so a state written by either
  package resumes in the other; written by rank 0 alone.
- ``save_train_state_sharded`` / ``load_train_state_sharded``: the full
  state as a ``torch.distributed.checkpoint`` directory (each rank writes its
  share, with the metadata and a ``clip_config.json``), the counterpart of
  the JAX package's orbax directory, which imports JAX and which the port
  therefore refuses.
- Parallelism (``mesh=``, a ``dp x tp`` ``parallel.mesh.Mesh``; the
  model placed by ``parallel.mesh.shard_params``): every dp rank embeds its
  rows (the ranks of a tp group the same rows, each through its shares of
  the towers), the embeddings are gathered over the dp group with a
  gradient (``gather_with_grad``: an all-gather forward, this rank's slice
  of the gradient backward), every rank computes the same global InfoNCE
  loss, and the parameter gradients are summed over the dp group in one
  flat all-reduce. A tp-sharded leaf keeps its own shard's gradient and
  AdamW moments; a replicated one comes out whole and equal on every tp
  rank. ``logit_scale``'s gradient comes whole from the loss on every rank
  and is not summed. The ``.npz`` state is written from the gathered tree;
  the sharded directory keeps each tp rank's shares with the split
  recorded.

Parameters, their grads and the optimizer moments stay fp32 whatever the
compute dtype.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.clip import CLIP, l2_normalize
from ..models.config import CLIPConfig
from ..parallel import distributed
from ..parallel.mesh import (Mesh, check_mesh, gather_tree, param_spec, shard_params,
                             shard_tensor, shard_tree)
from ..utils.checkpoint import (_flatten, _unflatten, from_jax_params, load_checkpoint,
                                save_checkpoint, to_jax_params)
from ..utils.profiling import span
from .scheduler import cosine_lr


@dataclasses.dataclass
class AdamState:
    """AdamW state: the step count and the two moments, by parameter name."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    model: CLIP
    opt_state: AdamState
    step: int


class FusedAdamW:
    """AdamW, trajectory-identical to the JAX package's ``fused_adamw``
    (optax.adamw's stepping). ``learning_rate`` is a float or a schedule of
    the step count."""

    def __init__(self, learning_rate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.2):
        self.schedule = learning_rate if callable(learning_rate) else (
            lambda _: learning_rate)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamState:
        return AdamState(
            count=0,
            mu={k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                for k, p in params.items()},
            nu={k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                for k, p in params.items()})

    @torch.no_grad()
    def update_(self, params: Mapping[str, torch.Tensor],
                grads: Mapping[str, torch.Tensor], state: AdamState) -> None:
        """One step, in place on ``params`` and ``state``."""
        f32 = np.float32
        lr = float(f32(self.schedule(state.count)))
        state.count += 1
        c = f32(state.count)
        bc1 = float(f32(1) - f32(self.b1) ** c)
        bc2 = float(f32(1) - f32(self.b2) ** c)
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        m = [state.mu[k] for k in names]
        v = [state.nu[k] for k in names]
        torch._foreach_mul_(m, self.b1)
        torch._foreach_add_(m, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(v, self.b2)
        torch._foreach_addcmul_(v, g, g, value=1.0 - self.b2)
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(m, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, p, alpha=self.weight_decay)
        torch._foreach_add_(p, upd, alpha=-lr)


def make_optimizer(base_lr: float = 5e-6, warmup: int = 50, total_steps: int = 1000,
                   weight_decay: float = 0.2, betas: Tuple[float, float] = (0.9, 0.999),
                   eps: float = 1e-8) -> FusedAdamW:
    """AdamW with the reference's defaults and the cosine-warmup schedule."""
    return FusedAdamW(cosine_lr(base_lr, warmup, total_steps), betas[0], betas[1], eps,
                      weight_decay)


def init_train_state(model: CLIP, optimizer: FusedAdamW) -> TrainState:
    return TrainState(model, optimizer.init(dict(model.named_parameters())), 0)


@torch.no_grad()
def clamp_logit_scale_(model: CLIP, cfg: CLIPConfig) -> None:
    """``logit_scale.clamp_(0, ln 100)``."""
    model.logit_scale.clamp_(0.0, cfg.logit_scale_max)


def _infonce(logits_per_image: torch.Tensor):
    n = logits_per_image.shape[0]
    labels = torch.arange(n, device=logits_per_image.device)
    loss = (F.cross_entropy(logits_per_image, labels)
            + F.cross_entropy(logits_per_image.t(), labels)) / 2.0
    acc = (logits_per_image.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "acc_i2t": acc}


def _scale(model: CLIP) -> torch.Tensor:
    return model.logit_scale.clamp(max=model.cfg.logit_scale_max).exp().float()


class _GatherWithGrad(torch.autograd.Function):
    """All-gather over the dp group forward; this rank's rows of the gradient
    backward. Every rank computes the same loss from the gathered rows, so
    the slice is this rank's whole gradient (no sum over ranks: that is done
    once, on the parameter gradients)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rows, ctx.rank = x.shape[0], mesh.dp_rank
        return distributed.all_gather_rows(x, mesh.dp_group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def gather_with_grad(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The dp ranks' ``x`` (equal shapes) concatenated in dp order, with the
    gradient of this rank's rows flowing back to ``x`` (``x`` itself at
    dp 1)."""
    return x if mesh.dp == 1 else _GatherWithGrad.apply(x, mesh)


def clip_loss(model: CLIP, pixels: torch.Tensor, ids: torch.Tensor,
              dtype: torch.dtype = torch.float32, remat=False, mesh: Mesh = None):
    """Symmetric InfoNCE: mean of the image->text and text->image
    cross-entropies. Returns ``(loss, {"loss", "acc_i2t"})``. With ``mesh``,
    ``pixels``/``ids`` are this rank's rows of the global batch and the
    loss is the global batch's (``gather_with_grad``)."""
    if mesh is None:
        logits_per_image, _ = model(pixels, ids, dtype, remat)
        return _infonce(logits_per_image)
    r_img, r_txt = remat if isinstance(remat, tuple) else (remat, remat)
    img = gather_with_grad(l2_normalize(model.encode_image(pixels, dtype, r_img)), mesh)
    txt = gather_with_grad(l2_normalize(model.encode_text(ids, dtype, r_txt)), mesh)
    return embedding_loss(model, img, txt)


def embedding_loss(model: CLIP, img: torch.Tensor, txt: torch.Tensor):
    """``clip_loss`` from the L2-normalized image and text embeddings of the
    whole batch: ``(loss, {"loss", "acc_i2t"})``."""
    return _infonce(_scale(model) * img @ txt.T)


def _accum_infonce_grads(model: CLIP, pixels: torch.Tensor, ids: torch.Tensor,
                         dtype: torch.dtype, remat, accum_steps: int, mesh: Mesh = None):
    """Gradient-exact InfoNCE over ``accum_steps`` microbatches, into each
    parameter's ``.grad`` (fp32).

    1. Embed the full batch microbatch by microbatch, without autograd.
    2. The loss on the embeddings, differentiated once: dL/dZ and the whole
       logit-scale grad.
    3. Embed each microbatch again with autograd and pull its dZ slice back
       to the parameters, the grads summing in fp32.

    Up to rounding this is the single-pass gradient, at one more forward
    and 1/k of its activation memory. With ``mesh`` the microbatches are
    this rank's rows: the embeddings of pass 1 are gathered for the global
    loss, and pass 2 pulls back this rank's rows of dL/dZ. Returns
    ``(loss, metrics)``."""
    B = pixels.shape[0]
    k = int(accum_steps)
    if B % k:
        raise ValueError(f"batch {B} not divisible by accum_steps {k}")
    mb = B // k
    r_img, r_txt = remat if isinstance(remat, tuple) else (remat, remat)
    cfg = model.cfg

    def embed(i):
        sl = slice(i * mb, (i + 1) * mb)
        return (l2_normalize(model.encode_image(pixels[sl], dtype, r_img)),
                l2_normalize(model.encode_text(ids[sl], dtype, r_txt)))

    with torch.no_grad():
        zs = [embed(i) for i in range(k)]
        zi, zt = torch.cat([z[0] for z in zs]), torch.cat([z[1] for z in zs])
        if mesh is not None and mesh.dp > 1:
            zi = distributed.all_gather_rows(zi, mesh.dp_group)
            zt = distributed.all_gather_rows(zt, mesh.dp_group)
    zi, zt = zi.requires_grad_(), zt.requires_grad_()
    ls = model.logit_scale.detach().clone().requires_grad_()
    scale = ls.clamp(max=cfg.logit_scale_max).exp().float()
    loss, metrics = _infonce(scale * zi @ zt.t())
    dzi, dzt, d_ls = torch.autograd.grad(loss, (zi, zt, ls))
    if mesh is not None:  # this rank's rows of dL/dZ
        dzi, dzt = (d[mesh.dp_rank * B:(mesh.dp_rank + 1) * B] for d in (dzi, dzt))

    for i in range(k):
        sl = slice(i * mb, (i + 1) * mb)
        torch.autograd.backward(embed(i), (dzi[sl], dzt[sl]))
    # the towers never touch logit_scale: its whole grad is the loss pass's
    if model.logit_scale.grad is None:
        model.logit_scale.grad = d_ls
    else:
        model.logit_scale.grad += d_ls
    return loss.detach(), {k_: v.detach() for k_, v in metrics.items()}


def _all_reduce_grads_(grads: Dict[str, torch.Tensor], mesh: Mesh) -> None:
    """Sum the parameter gradients over the dp group in one flat all-reduce
    (in place), ``logit_scale``'s excepted: every rank already holds its
    whole gradient. A tp-sharded leaf's gradient is its shard's, summed with
    the same shard's on the other dp ranks."""
    if mesh.dp == 1:
        return
    names = [k for k in grads if k != "logit_scale"]
    flat = torch.cat([grads[k].reshape(-1) for k in names])
    distributed.all_reduce_sum_(flat, mesh.dp_group)
    for k, part in zip(names, flat.split([grads[k].numel() for k in names])):
        grads[k].copy_(part.view_as(grads[k]))


def make_train_step(cfg: CLIPConfig, optimizer: FusedAdamW,
                    dtype: torch.dtype = torch.float32, remat=False,
                    accum_steps: int = 1, mesh: Mesh = None) -> Callable:
    """``step(state, pixels, ids) -> (state, metrics)``: grads of the InfoNCE
    loss (single pass, or the two-pass accumulation when ``accum_steps >
    1``), one AdamW update and the logit-scale clamp, all in place on
    ``state``. ``remat``: a policy of ``models.layers`` (``False``, ``True``,
    ``"mlp"``, ``"mlp_h1"``, ``"block"``) or an ``(image, text)`` pair.
    ``mesh``: a ``dp x tp`` mesh, the model placed on it by
    ``parallel.mesh.shard_params``; ``pixels``/``ids`` are then this rank's
    rows of the global batch (``parallel.mesh.shard_batch``, by dp rank),
    the loss is the global batch's and every rank takes the same update of
    its leaves."""
    check_mesh(mesh, "make_train_step")

    def step(state: TrainState, pixels: torch.Tensor, ids: torch.Tensor):
        model = state.model
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        if accum_steps > 1:
            _, metrics = _accum_infonce_grads(model, pixels, ids, dtype, remat,
                                              accum_steps, mesh)
        else:
            with span("train.forward"):
                loss, metrics = clip_loss(model, pixels, ids, dtype, remat, mesh)
            with span("train.backward"):
                loss.backward()
            metrics = {k: v.detach() for k, v in metrics.items()}
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                 for k, p in params.items()}
        if mesh is not None:
            _all_reduce_grads_(grads, mesh)
        with span("train.optimizer"):
            optimizer.update_(params, grads, state.opt_state)
            clamp_logit_scale_(model, cfg)
        for p in params.values():
            p.grad = None
        state.step += 1
        return state, metrics

    return step


def _jax_order(cfg: CLIPConfig, model):
    """Parameter paths of the JAX package's tree in its flatten order
    (dict keys sorted at every level); ``model`` a ``CLIP`` or its
    parameters."""
    return sorted(_flatten(to_jax_params(model, cfg)), key=lambda p: p.split("/"))


def gather_to_host(tree):
    """A tensor, or a dict of them, as host numpy arrays. Under dp every
    rank holds the whole (replicated) value, so no collective is needed;
    the function keeps the JAX package's name and contract (every rank may
    call it, each gets the global value)."""
    if isinstance(tree, dict):
        return {k: gather_to_host(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def save_train_state(path: str, state: TrainState, cfg: CLIPConfig,
                     mesh: Mesh = None) -> None:
    """Params as the native ``.npz`` (``path``) and the optimizer state in
    ``path + ".opt.npz"``: ``__step__`` and ``leaf_i``, the leaves of optax's
    ``ScaleByAdamState`` (count, then mu and nu in the JAX tree's order).
    Every rank calls it; under a tp ``mesh`` the full tree is gathered
    first; rank 0 alone writes, and the others wait for it behind a
    barrier."""
    trees = (dict(state.model.named_parameters()), state.opt_state.mu, state.opt_state.nu)
    params, mu, nu = (gather_tree(t, mesh) for t in trees)
    if distributed.rank() == 0:
        _write_train_state(path, params, mu, nu, state.opt_state.count, state.step, cfg)
    distributed.barrier()


def _write_train_state(path: str, params, mu, nu, count: int, step: int,
                       cfg: CLIPConfig) -> None:
    save_checkpoint(path, params, cfg)
    order = _jax_order(cfg, params)
    leaves = [np.asarray(count, np.int32)]
    for moments in (mu, nu):
        flat = _flatten(to_jax_params(moments, cfg))
        leaves += [flat[p] for p in order]
    np.savez(path + ".opt", __step__=np.asarray(step, np.int32),
             **{f"leaf_{i}": x for i, x in enumerate(leaves)})


def load_train_state(path: str, optimizer: FusedAdamW, device=None, mesh: Mesh = None
                     ) -> Tuple[TrainState, CLIPConfig]:
    """Resume from ``save_train_state`` output of either package. The
    optimizer must be built as it was (same schedule and hyperparameters).
    ``mesh``: the model is placed on it (``shard_params``) and the moments
    sharded alike."""
    sd, cfg = load_checkpoint(path)
    model = CLIP(cfg)
    model.load_state_dict(sd)
    model.to(device)
    order = _jax_order(cfg, model)
    with np.load(path + ".opt.npz", allow_pickle=False) as data:
        n = len(order)
        if len(data.files) != 2 * n + 2:
            raise ValueError(f"{path}.opt.npz holds {len(data.files) - 1} optimizer "
                             f"leaves, expected {2 * n + 1}")
        count = int(data["leaf_0"])
        moments = []
        for first in (1, 1 + n):
            tree = _unflatten({p: data[f"leaf_{first + i}"] for i, p in enumerate(order)})
            moments.append({k: t.to(device) for k, t in from_jax_params(tree, cfg).items()})
        step = int(data["__step__"])
    names = [k for k, _ in model.named_parameters()]
    if mesh is not None:
        shard_params(model, mesh)
        moments = [shard_tree(m, mesh) for m in moments]
    opt_state = AdamState(count, {k: moments[0][k] for k in names},
                          {k: moments[1][k] for k in names})
    return TrainState(model, opt_state, step), cfg


SHARDED_CONFIG = "clip_config.json"
# the tp split of a sharded directory: {"tp": ranks}; absent: 1
SHARDED_SPLIT = "tp_split.json"


def _sharded_key(name: str, tp_rank) -> str:
    """A leaf's key in the sharded directory: a tp-split leaf's carries the
    rank of its share (``name@tp{t}``), so the shares are distinct entries;
    a replicated leaf has one entry, written once."""
    return name if tp_rank is None or param_spec(name) is None else f"{name}@tp{tp_rank}"


def _sharded_dict(state: TrainState, tp_rank=None) -> dict:
    """The state as one dict of tensors (``torch.distributed.checkpoint``
    flattens the nesting; the ints travel as int64 tensors); ``tp_rank``:
    the split leaves are this tp rank's shares."""
    def keyed(tree):
        return {_sharded_key(k, tp_rank): v for k, v in tree.items()}

    return {"params": keyed(dict(state.model.named_parameters())),
            "mu": keyed(state.opt_state.mu), "nu": keyed(state.opt_state.nu),
            "count": torch.tensor(state.opt_state.count, dtype=torch.int64),
            "step": torch.tensor(state.step, dtype=torch.int64)}


def save_train_state_sharded(path: str, state: TrainState, cfg: CLIPConfig,
                             mesh: Mesh = None) -> None:
    """The full state (params, AdamW moments and count, step) as a
    ``torch.distributed.checkpoint`` directory: every rank calls it and
    writes its share of the tensors next to the metadata (under a tp
    ``mesh`` each rank's split leaves under keys of their own); rank 0 adds
    the config as ``clip_config.json`` and the split as ``tp_split.json``.
    The counterpart of the JAX package's ``save_train_state_orbax``."""
    import json

    import torch.distributed.checkpoint as dcp

    from ..utils.checkpoint import cfg_to_json

    path = os.path.abspath(path)
    tp = 1 if mesh is None else mesh.tp
    with torch.no_grad():
        dcp.save(_sharded_dict(state, mesh.tp_rank if tp > 1 else None), checkpoint_id=path,
                 no_dist=not torch.distributed.is_initialized())
    if distributed.rank() == 0:
        with open(os.path.join(path, SHARDED_CONFIG), "w") as f:
            f.write(cfg_to_json(cfg))
        with open(os.path.join(path, SHARDED_SPLIT), "w") as f:
            json.dump({"tp": tp}, f)
    distributed.barrier()


def _load_whole(path: str, state: TrainState, tp: int) -> None:
    """Fill a full-size ``state`` from a directory saved under ``tp`` ranks:
    every rank's shares read as entries of one dict, then joined
    (``parallel.mesh.gather_tensor``)."""
    import torch.distributed.checkpoint as dcp

    from ..parallel.mesh import gather_tensor

    trees = {"params": dict(state.model.named_parameters()), "mu": state.opt_state.mu,
             "nu": state.opt_state.nu}
    sd = {"count": torch.tensor(0, dtype=torch.int64), "step": torch.tensor(0, dtype=torch.int64)}
    for group, tree in trees.items():
        sd[group] = {}
        for k, v in tree.items():
            spec = param_spec(k)
            if spec is None:
                sd[group][k] = v
            else:
                for t in range(tp):
                    sd[group][_sharded_key(k, t)] = shard_tensor(v.detach(), spec, t, tp).clone()
    with torch.no_grad():
        dcp.load(sd, checkpoint_id=path, no_dist=not torch.distributed.is_initialized())
        for group, tree in trees.items():
            for k, v in tree.items():
                spec = param_spec(k)
                if spec is not None:
                    v.copy_(gather_tensor([sd[group][_sharded_key(k, t)] for t in range(tp)],
                                          spec))
    state.opt_state.count, state.step = int(sd["count"]), int(sd["step"])


def load_train_state_sharded(path: str, optimizer: FusedAdamW, device=None, mesh: Mesh = None
                             ) -> Tuple[TrainState, CLIPConfig]:
    """Resume from ``save_train_state_sharded`` (in any number of processes;
    without a group, in this one). The optimizer must be built as it was.
    A directory written under tp ranks resumes under a mesh of the same tp
    (each rank reads its shares), or is read whole without one (the full
    model, as ``scripts.export_checkpoint`` reads it); another tp raises.
    A directory of another format (the JAX package's orbax state) raises
    ``ValueError``."""
    import json

    import torch.distributed.checkpoint as dcp

    from ..utils.checkpoint import cfg_from_json

    path = os.path.abspath(path)
    if not os.path.exists(os.path.join(path, ".metadata")):
        raise ValueError(
            f"{path!r} is not a torch.distributed.checkpoint train state (a JAX orbax "
            "directory?): orbax imports JAX, which this package does not. Save the full "
            "state as .npz (save_full_state=True, save_train_state), which both packages "
            "read.")
    with open(os.path.join(path, SHARDED_CONFIG)) as f:
        cfg = cfg_from_json(f.read())
    split = os.path.join(path, SHARDED_SPLIT)
    saved_tp = 1
    if os.path.exists(split):
        with open(split) as f:
            saved_tp = json.load(f)["tp"]
    tp = 1 if mesh is None else mesh.tp
    model = CLIP(cfg).to(device)
    if saved_tp > 1 and tp == 1:
        state = init_train_state(model, optimizer)
        _load_whole(path, state, saved_tp)
        if mesh is not None:
            shard_params(model, mesh)
        return state, cfg
    if tp != saved_tp:
        raise ValueError(f"{path!r} was saved under tp={saved_tp}: resume it under a mesh "
                         f"of the same tp, or read it whole without one (got tp={tp})")
    if tp > 1:
        shard_params(model, mesh)
    state = init_train_state(model, optimizer)
    sd = _sharded_dict(state, mesh.tp_rank if tp > 1 else None)
    with torch.no_grad():
        dcp.load(sd, checkpoint_id=path, no_dist=not torch.distributed.is_initialized())
    state.opt_state.count, state.step = int(sd["count"]), int(sd["step"])
    return state, cfg
