"""The loop of the ``encode`` mixes: bulk tile embedding through
``PLIP.encode_images``, a closed loop with one client.

Set-up draws the weights and a pool of tiles from the seed, cuts the pool
into requests of the mix's fixed size, and warms up the one batch shape they
give. The window sends the requests in turn until ``seconds`` have passed;
each request's latency (a note on standard error, not a metric) runs from
the call to the host embeddings it returns. Once the window has closed the
program is freed and the reference embeds ``check_requests`` distinct
completed requests drawn from the seed.
"""

from __future__ import annotations

import math
import time
from typing import List, Mapping, Sequence

import numpy as np
import torch

from .. import card, counts, traffic
from ..program import build_plip
from ..reference import clip as ref
from ..reference import lowp
from ..reference.preprocess import preprocess
from ..result import Result
from ..trace import Recorder, Window, settle_host
from ..weights import make_weights


def run(cfg: Mapping, mix: Mapping, seed: int, seconds: float, traced: bool, device,
        t0: float, controls: Sequence[str] = ()) -> Result:
    dtype = getattr(torch, mix["dtype"])
    bs, n = mix["batch_size"], mix["request_tiles"]
    pool = traffic.tile_pool(mix["pool_tiles"], mix["tile_px"], seed, device)
    requests = traffic.encode_requests(pool, n)
    plip = build_plip(cfg, seed, dtype, device)
    plip.encode_images(requests[0], batch_size=bs)
    card.sync(device)
    settle_host()
    setup_s = time.perf_counter() - t0

    card.reset_peak(device)
    rec, win = Recorder(traced), Window(traced, device)
    done = []  # (request, embeddings, seconds)
    win.start()
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        k = len(done) % len(requests)
        t = time.perf_counter()
        with rec.span("request"):
            emb = plip.encode_images(requests[k], batch_size=bs)
        done.append((k, emb, time.perf_counter() - t))
    win.stop()
    memory_peak = card.peak_bytes(device)
    del plip
    card.free(device)

    failed = sum(1 for _, emb, _ in done
                 if emb.shape != (n, cfg["embed_dim"]) or not np.isfinite(emb).all())
    lat = np.array([s for _, _, s in done])
    width = counts.WIDTH[mix["dtype"]]
    works = [w for _ in done for b in split(n, bs) for w in counts.vision_forward(cfg, b, width)]
    res = Result(setup_s=setup_s, trace=win.summary, works=works, items=n * len(done),
                 steps=len(done), attempted=len(done), failed=failed,
                 memory_peak_bytes=memory_peak, span_seconds=dict(rec.seconds))
    res.metrics = {"images_per_s": (n * len(done) / win.seconds, "images/s")}
    res.notes["latency_ms"] = {q: float(np.percentile(lat, q)) * 1000.0 if len(lat) else None
                               for q in (0, 50, 95, 100)}

    pick = sample(done, mix["check_requests"], seed)
    chunks = [(requests[done[i][0]], done[i][1]) for i in pick]
    ref_out = reference(cfg, chunks, seed, bs, device)
    res.readings = {"emb_err": emb_err([e for _, e in chunks], ref_out)}
    for name in controls:
        res.controls[name] = {"emb_err": emb_err(
            reference(cfg, chunks, seed, bs, device, name), ref_out)}
    return res


def split(n: int, batch_size: int) -> List[int]:
    """The batches ``encode_images(batch_size=)`` cuts ``n`` tiles into."""
    return [batch_size] * (n // batch_size) + ([n % batch_size] if n % batch_size else [])


def sample(done: List, check_requests: int, seed: int) -> List[int]:
    """Completed requests to compare: ``check_requests`` of them, each of
    other tiles, in an order drawn from the seed."""
    pick, seen = [], set()
    for i in traffic.rng(seed, 4).permutation(len(done)).tolist():
        if done[i][0] not in seen:
            seen.add(done[i][0])
            pick.append(i)
        if len(pick) == check_requests:
            break
    return pick


def _stack(tiles, device) -> torch.Tensor:
    return torch.from_numpy(np.stack(tiles)).to(device)


@torch.no_grad()
def reference(cfg: Mapping, chunks, seed: int, bs: int, device, precision: str = "fp32"
              ) -> List[torch.Tensor]:
    """The reference's embeddings of each request's tiles (float64 rows of
    float32 work): the seed's weights drawn anew, TF32 off. ``precision``:
    the control, ``"tf32"``, every product on TF32."""
    W = make_weights(cfg, seed, device)
    n_px = cfg["vision"]["image_size"]
    out = []
    with (lowp.tf32() if precision == "tf32" else lowp.fp32()):
        for tiles, _ in chunks:
            rows = []
            for lo in range(0, len(tiles), bs):
                pixels = preprocess(_stack(tiles[lo:lo + bs], device), n_px)
                rows.append(ref.encode_image(W, pixels, cfg, ref.fp32_matmul).double())
            out.append(torch.cat(rows))
    return out


def emb_err(program: Sequence, reference_rows: Sequence[torch.Tensor]) -> float:
    """The widest relative gap of an embedding row: max over rows of
    ||program - reference|| / ||reference||."""
    worst = 0.0
    for p, r in zip(program, reference_rows):
        p = torch.as_tensor(p).to(r.device, torch.float64)
        if p.shape != r.shape:
            return math.inf
        gap = float(((p - r).norm(dim=-1) / r.norm(dim=-1)).max())
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst
