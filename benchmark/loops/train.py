"""The loop of the ``train`` mixes: ``CLIPTuner``'s inner loop, step by
step as ``CLIPTuner.tuner`` runs it.

``PrefetchLoader`` (threads, pinned copies to the card) over an in-memory
dataset of ``epoch_pairs`` tiles and captions drawn from the seed, a new
loader each epoch and only full batches, as the tuner does; ``augment_batch``
on the card with a host generator seeded from the run's seed; the tokenizer;
``make_train_step`` with ``make_optimizer``'s AdamW; ``float(loss)`` after
every step. The host's JPEG decoding and ``TrainTransform`` are left out.

Set-up builds the one training state and drives it through its first
``check_steps`` steps, on rows that all differ, through the same loader and
calls as the window. It keeps what the comparison needs: each step's loss,
each leaf's norm of the first gradient as AdamW got it (its first moment
after one step over 1 - b1) and of the change after the checked steps. The
window then goes on from that state. Once it has closed and the program is
freed, the reference follows the checked steps from the seed's weights.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import card, counts, traffic
from ..program import build_model
from ..reference import clip as ref
from ..reference import lowp
from ..reference.preprocess import sample_warp, warp_normalize
from ..result import Result
from ..trace import Recorder, Window, settle_host
from ..weights import make_weights

# a leaf whose reference gradient is under this share of the median leaf's
# is nought to rounding (a key's bias under softmax): Adam moves it by
# round-off alone, so its gradient and change are not compared
NOUGHT = 1e-3


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    vals = torch.stack(torch._foreach_norm([tensors[k].detach().float() for k in names]))
    return dict(zip(names, vals.double().cpu().tolist()))


def run(cfg: Mapping, mix: Mapping, seed: int, seconds: float, traced: bool, device,
        t0: float, controls: Sequence[str] = ()) -> Result:
    from plip_tpu_torch.data.datasets import ImageCaptionDataset
    from plip_tpu_torch.data.loader import PrefetchLoader
    from plip_tpu_torch.ops.augment import AugmentConfig, augment_batch
    from plip_tpu_torch.tokenizer import default_tokenizer
    from plip_tpu_torch.train.contrastive import (init_train_state, make_optimizer,
                                                  make_train_step)

    dtype = getattr(torch, mix["dtype"])
    B, checks = mix["batch_size"], mix["check_steps"]
    ctx_len = cfg["text"]["context_length"]
    pool = traffic.tile_pool(mix["pool_tiles"], mix["tile_px"], seed, device)
    rows = traffic.train_rows(mix["epoch_pairs"], len(pool), seed)
    data = ImageCaptionDataset({"image": [pool[i] for i in rows],
                                "caption": traffic.captions(mix, len(rows), seed)})
    batches = epochs(lambda: PrefetchLoader(data, B, num_workers=mix["loader_workers"],
                                            device=device), B)

    weights = make_weights(cfg, seed, device)
    model = build_model(cfg, weights, device)
    opt = make_optimizer(base_lr=mix["lr"], warmup=mix["warmup"],
                         total_steps=mix["total_steps"], weight_decay=mix["weight_decay"])
    state = [init_train_state(model, opt)]
    step_fn = make_train_step(model.cfg, opt, dtype=dtype, remat=mix["remat"])
    gen = torch.Generator().manual_seed(seed % (1 << 63))
    aug = AugmentConfig(out_size=cfg["vision"]["image_size"],
                        **{k: tuple(v) if isinstance(v, list) else v
                           for k, v in mix["augment"].items()})
    tokenizer = default_tokenizer()

    def step(rec: Recorder):
        with rec.span("loader.next"):
            images, captions = next(batches)
        with rec.span("augment"):
            pixels = augment_batch(gen, images, aug)
        with rec.span("tokenize"):
            ids = torch.as_tensor(tokenizer.tokenize(list(captions), ctx_len),
                                  dtype=torch.long, device=device)
        with rec.span("step"):
            state[0], metrics = step_fn(state[0], pixels, ids)
        with rec.span("loss.item"):
            loss = float(metrics["loss"])
        return loss, ids, captions

    names = [k for k, _ in model.named_parameters()]
    prog = {"losses": [], "ids": [], "captions": []}
    for s in range(checks):
        loss, ids, captions = step(Recorder(False))
        prog["losses"].append(loss)
        prog["ids"].append(ids.cpu())
        prog["captions"].append(list(captions))
        if s == 0:
            mu = state[0].opt_state.mu
            prog["g1"] = {k: v / (1 - opt.b1)
                          for k, v in _norms({k: mu[k] for k in names}).items()}
    params = dict(model.named_parameters())
    # the change, kept on the host until the reference says which elements count
    change = {k: (params[k].detach() - weights[k]).cpu() for k in names}
    del weights, params, mu
    card.sync(device)
    settle_host()
    setup_s = time.perf_counter() - t0

    card.reset_peak(device)
    rec, win = Recorder(traced), Window(traced, device)
    steps = bad = 0
    win.start()
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        loss, _, _ = step(rec)
        steps += 1
        bad += not math.isfinite(loss)
    win.stop()
    memory_peak = card.peak_bytes(device)
    batches.close()
    del state, model, step_fn, batches, data
    card.free(device)

    res = Result(setup_s=setup_s, trace=win.summary,
                 works=counts.train_step(cfg, B, counts.WIDTH[mix["dtype"]]) * steps,
                 items=B * steps, steps=steps, attempted=steps, failed=bad,
                 memory_peak_bytes=memory_peak, span_seconds=dict(rec.seconds))
    res.metrics = {"pairs_per_s": (steps * B / win.seconds, "pairs/s")}
    res.holds["tokens"] = tokens_hold(tokenizer, prog["ids"], prog["captions"],
                                      cfg["text"]["vocab_size"])
    first = rows[:checks * B]
    want = reference(cfg, mix, seed, device, pool, first, prog["ids"], change=change)
    prog["delta"] = want.pop("delta_of_change")
    del change
    res.readings = gaps(prog, want)
    res.notes["worst_leaves"] = worst_leaves(prog, want)
    for name in controls:
        res.controls[name] = gaps(reference(cfg, mix, seed, device, pool, first, prog["ids"],
                                            name, want["masks"]), want)
    return res


def epochs(loader: Callable[[], Iterable], batch_size: int) -> Iterator[Tuple]:
    """``(images, captions)`` of each full batch of a new ``loader()`` an
    epoch, epoch after epoch; closing this closes the epoch's loader."""
    while True:
        it = iter(loader())
        try:
            for (images, captions), n in it:
                if n == batch_size:
                    yield images, captions
        finally:
            it.close()


def tokens_hold(tokenizer, ids_list: List[torch.Tensor], captions_list: List[List[str]],
                vocab_size: int) -> bool:
    """Each row: start-of-text (the vocabulary's last id but one), the ids of
    its caption, end-of-text (the last id), zeros; the ids decode back to the
    caption, lower-cased with single spaces (a row cut at the context length
    to its start). The reference takes the program's ids, so this is where a
    token altered in the tokenizer shows."""
    sot, eot = vocab_size - 2, vocab_size - 1
    for ids, captions in zip(ids_list, captions_list):
        for row, caption in zip(ids.tolist(), captions):
            if row[0] != sot or eot not in row:
                return False
            e = row.index(eot)
            text = " ".join(caption.lower().split())
            got = tokenizer.decode(row[1:e]).strip()
            if any(row[e + 1:]) or not (got == text or (e == len(row) - 1
                                                         and text.startswith(got))):
                return False
    return True


def reference(cfg: Mapping, mix: Mapping, seed: int, device, pool: np.ndarray,
              rows: np.ndarray, ids_list: List[torch.Tensor], mode: str = "fp32",
              masks: Optional[Dict[str, torch.Tensor]] = None,
              change: Optional[Mapping[str, torch.Tensor]] = None) -> Dict:
    """The checked steps from the seed's weights: the augmentation drawn from
    a generator seeded as the program's, both towers, InfoNCE, autograd's
    gradients and AdamW, in float32 with TF32 off. ``mode``: a control in the
    program's place: ``"tf32"`` products on TF32; ``"fp8"`` every product
    in float8 (``lowp``); ``"half_batch"`` the loss over the first half of
    each batch only.

    Returns the losses, each leaf's norm of the first gradient (``g1``) and
    of the change over the steps (``delta``), counting only the elements
    that ``masks`` keeps: by default (and returned as ``masks``) those whose
    first gradient here is at least ``NOUGHT`` of the median leaf's RMS
    element. An element under it (a key's bias under softmax) has no
    gradient but round-off, and Adam, which divides by the gradient's own
    size, moves it a whole step in the direction of that round-off. With
    ``change`` (the program's change, by leaf), also its norms over the
    same elements (``delta_of_change``)."""
    W = make_weights(cfg, seed, device)
    P = {k: v.clone().requires_grad_(True) for k, v in W.items()}
    B = mix["batch_size"]
    aug = {"out_size": cfg["vision"]["image_size"], **mix["augment"]}
    gen = torch.Generator().manual_seed(seed % (1 << 63))
    opt = ref.AdamW(ref.cosine_lr(mix["lr"], mix["warmup"], mix["total_steps"]),
                    mix["weight_decay"])
    mm = lowp.fp8_matmul if mode == "fp8" else ref.fp32_matmul
    out = {"losses": []}
    with (lowp.tf32() if mode == "tf32" else lowp.fp32()):
        for s, ids in enumerate(ids_list):
            tiles = torch.from_numpy(pool[rows[s * B:(s + 1) * B]]).to(device)
            pixels = warp_normalize(tiles, *sample_warp(gen, B, tiles.shape[1], aug), aug)
            ids = ids.to(device)
            if mode == "half_batch":
                pixels, ids = pixels[:B // 2], ids[:B // 2]
            loss = ref.infonce(P, pixels, ids, cfg, mm)
            grads = dict(zip(P, torch.autograd.grad(loss, list(P.values()))))
            if s == 0:
                out["g1"] = _norms(grads)
                if masks is None:
                    rms = [out["g1"][k] / math.sqrt(max(g.numel(), 1)) for k, g in grads.items()]
                    floor = NOUGHT * float(np.median(rms))
                    masks = {k: g.abs() >= floor for k, g in grads.items()}
            opt.step(P, grads)
            with torch.no_grad():
                P["logit_scale"].clamp_(0.0, cfg["logit_scale_max"])
            out["losses"].append(float(loss.detach()))
            del grads, loss
    out["delta"] = _norms({k: (P[k].detach() - W[k])[masks[k]] for k in P})
    if change is not None:
        out["delta_of_change"] = _norms({k: change[k].to(device)[masks[k]] for k in P})
    out["masks"] = masks
    del P, W, opt
    card.free(device)
    return out


def gaps(prog: Mapping, want: Mapping) -> Dict[str, float]:
    """``loss_gap``: the widest relative gap of a checked step's loss.
    ``grad_gap``, ``delta_gap``: by the worst leaf, the gap between the
    program's and the reference's norms of the first gradient and of the
    change, over the larger of the reference's norm of that leaf and of the
    median leaf; leaves with a reference gradient under ``NOUGHT`` of the
    median leaf's are left out."""
    def worst(xs) -> float:
        xs = list(xs)
        return max(xs) if all(math.isfinite(x) for x in xs) else math.inf

    med_g = float(np.median(list(want["g1"].values())))
    keep = [k for k, v in want["g1"].items() if v >= NOUGHT * med_g]
    out = {"loss_gap": worst(abs(p - w) / abs(w)
                             for p, w in zip(prog["losses"], want["losses"], strict=True))}
    for name, key in (("grad_gap", "g1"), ("delta_gap", "delta")):
        med = float(np.median([want[key][k] for k in keep]))
        out[name] = worst(leaf_gaps(prog[key], want[key], keep, med).values())
    return out


def leaf_gaps(prog: Mapping[str, float], want: Mapping[str, float], keep: Sequence[str],
              med: float) -> Dict[str, float]:
    """Each kept leaf's gap of norms over the larger of its reference norm and
    ``med``."""
    return {k: abs(prog[k] - want[k]) / max(want[k], med) for k in keep}


def worst_leaves(prog: Mapping, want: Mapping, top: int = 5) -> Dict[str, list]:
    """The leaves that read the widest gaps: what to look at when a gap is
    wide."""
    med_g = float(np.median(list(want["g1"].values())))
    keep = [k for k, v in want["g1"].items() if v >= NOUGHT * med_g]
    out = {}
    for key in ("g1", "delta"):
        med = float(np.median([want[key][k] for k in keep]))
        g = leaf_gaps(prog[key], want[key], keep, med)
        out[key] = [[k, g[k], prog[key][k], want[key][k]]
                    for k in sorted(g, key=g.get, reverse=True)[:top]]
    return out
