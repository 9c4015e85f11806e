"""Streaming whole-slide images: the port of ``plip_tpu.data.wsi``.

A gigapixel slide is tiled into 224x224 patches (the reference does this
offline, ``preprocess_DigestPath.py``); here the tiles stream from the slide
into the port's ``PLIP`` image tower with bounded memory, the background
filtered on the fly.

- ``iter_wsi_tiles`` / ``iter_wsi_pyramid``: the JAX package's numpy/PIL
  iterators, copied. The pyramid keeps the reference's grid exactly: a float
  stride ``tile * (1 - overlap)`` walked with ``np.arange``, tiles touching
  the far edge dropped (its ``x2 >= H`` test).
- ``embed_wsi`` / ``embed_wsi_pyramid``: the tiles go into pinned host
  buffers (two, used in turns), a batch is copied to the device with a
  non-blocking copy, preprocessed there at the tower's ``image_size`` and
  encoded in the model's dtype under ``torch.inference_mode()``, and its
  embeddings copied back into pinned memory behind it, with an event. At
  most two batches are in flight: batch i is fetched (its event waited for)
  after batch i + 1 is launched, so the host tiles batch i + 2 while the
  device encodes batch i + 1. The last batch is not padded (PyTorch runs
  eagerly; the JAX package padded it for XLA's static shapes).
- ``mesh=`` (a ``parallel.mesh.Mesh``, dp x tp): every process reads the
  slide and walks the same tiles; of each batch it copies, preprocesses and
  encodes only its ``local_rows`` (by ``dp_rank``: the ranks of a tp group
  encode the same rows through their shares of the tower), and the rows are
  all-gathered over the dp group before the copy back, so every process
  returns the one-process result.
"""

from __future__ import annotations

from collections import deque
from typing import Iterator, Tuple

import numpy as np
import torch

from ..datagen.preprocess_digestpath import background_ratio
from ..ops.preprocess import preprocess_batch
from ..parallel.mesh import check_mesh, gather_rows, local_rows


def iter_wsi_tiles(
    image,
    tile: int = 224,
    overlap: float = 0.0,
    downsample: int = 1,
    non_bg_threshold: float = 0.0,
    bg_pixel_threshold: int = 200,
) -> Iterator[Tuple[np.ndarray, Tuple[int, int]]]:
    """Lazily yield (tile [tile,tile,3] uint8, (y, x) in downsampled coords).

    image: numpy HWC uint8, PIL image, or path. Downsampling uses PIL for
    paths/PIL inputs, strided numpy (box-free) for arrays. Tiles whose tissue
    fraction (1 - background_ratio) falls below ``non_bg_threshold`` are
    skipped: the DigestPath filtering rule, applied streamingly.
    """
    if isinstance(image, str) or hasattr(image, "convert"):  # path or PIL
        from PIL import Image

        img = Image.open(image) if isinstance(image, str) else image
        if downsample != 1:
            img = img.resize(
                (
                    int(round(img.size[0] / downsample)),
                    int(round(img.size[1] / downsample)),
                )
            )
        arr = np.asarray(img.convert("RGB"))
    else:
        arr = np.asarray(image)
        if downsample != 1:
            arr = arr[::downsample, ::downsample]

    stride = max(1, int(tile * (1 - overlap)))
    for y in range(0, arr.shape[0] - tile + 1, stride):
        for x in range(0, arr.shape[1] - tile + 1, stride):
            patch = arr[y : y + tile, x : x + tile]
            if non_bg_threshold > 0:
                tissue = 1.0 - background_ratio(patch, bg_pixel_threshold)
                if tissue < non_bg_threshold:
                    continue
            yield patch, (y, x)


def iter_wsi_pyramid(
    image,
    downsample_list=(2, 4, 8, 16, 32),
    tile: int = 224,
    overlap: float = 0.1,
    non_bg_threshold: float = 0.5,
    bg_pixel_threshold: int = 200,
) -> Iterator[Tuple[np.ndarray, Tuple[int, int, int]]]:
    """Stream the full multi-downsample sweep of one slide in one pass:
    lazily yield (tile uint8, (downsample, y, x)).

    The slide decodes once; each pyramid level resizes from that decode with
    PIL bicubic. Tiling replicates the reference's offline sweep exactly
    (``preprocess_DigestPath.py:36-108``): float stride ``tile*(1-overlap)``
    walked with np.arange (not an integer-stride grid: the grids diverge from
    the third tile on), tiles touching the far edge dropped (the reference's
    ``x2 >= H`` test), background = all-RGB>=200, keep tissue >=
    ``non_bg_threshold``. Levels smaller than one tile are skipped, as the
    reference does. Defaults are the DigestPath step-1 hyperparameters."""
    from PIL import Image

    if isinstance(image, str):
        base = Image.open(image).convert("RGB")
    elif hasattr(image, "convert"):
        base = image.convert("RGB")
    else:
        base = Image.fromarray(np.asarray(image))

    for downsample in downsample_list:
        new_size = (
            int(np.round(base.size[0] / downsample)),
            int(np.round(base.size[1] / downsample)),
        )
        if new_size[0] < tile or new_size[1] < tile:
            continue
        arr = np.array(base.resize(new_size))
        stride = tile * (1 - overlap)
        x_list = np.arange(0, arr.shape[0], stride).astype(int)
        y_list = np.arange(0, arr.shape[1], stride).astype(int)
        for x1 in x_list:
            for y1 in y_list:
                x2, y2 = x1 + tile, y1 + tile
                if x2 >= arr.shape[0] or y2 >= arr.shape[1]:
                    continue
                patch = arr[x1:x2, y1:y2, :]
                tissue = 1.0 - background_ratio(patch, bg_pixel_threshold)
                if tissue < non_bg_threshold:
                    continue
                yield patch, (downsample, x1, y1)


def embed_wsi(
    model,
    image,
    batch_size: int = 256,
    tile: int = 224,
    overlap: float = 0.0,
    downsample: int = 1,
    non_bg_threshold: float = 0.0,
    mesh=None,
    normalize: bool = True,
):
    """Stream a slide through the image tower of ``model`` (a
    ``plip_tpu_torch.api.PLIP``), on the model's device; with ``mesh``,
    each batch split over its dp processes (module doc).

    Returns (embeddings [N, embed_dim] float32, coords [N, 2] int64: (y, x)),
    L2-normalized rows unless ``normalize=False``."""
    tiles = iter_wsi_tiles(image, tile, overlap, downsample, non_bg_threshold)
    return _embed_tile_stream(model, tiles, batch_size, tile, mesh, normalize, coord_len=2)


def embed_wsi_pyramid(
    model,
    image,
    downsample_list=(2, 4, 8, 16, 32),
    batch_size: int = 256,
    tile: int = 224,
    overlap: float = 0.1,
    non_bg_threshold: float = 0.5,
    mesh=None,
    normalize: bool = True,
):
    """Stream the whole multi-downsample sweep through the image tower in one
    pass: the streaming analog of the reference's offline
    ``preprocess_DigestPath.py --step 1`` harvest; ``mesh`` as in
    ``embed_wsi``.

    Returns (embeddings [N, embed_dim] float32, coords [N, 3] int64:
    (downsample, y, x) per tile). Batches may span level boundaries."""
    tiles = iter_wsi_pyramid(image, downsample_list, tile, overlap, non_bg_threshold)
    return _embed_tile_stream(model, tiles, batch_size, tile, mesh, normalize, coord_len=3)


def _embed_tile_stream(model, tiles, batch_size, tile, mesh, normalize, coord_len):
    check_mesh(mesh, "embed_wsi")
    device = model.device
    n_px = model.cfg.vision.image_size
    pin = device.type == "cuda"
    # two staging buffers, used in turns: batch i + 2 is written into batch
    # i's buffer only after batch i has been fetched (so its copy is done)
    staging = [torch.empty((batch_size, tile, tile, 3), dtype=torch.uint8, pin_memory=pin)
               for _ in range(2)]
    views = [s.numpy() for s in staging]
    embs, coords = [], []
    pending = deque()  # (embedding, its event) launched but not fetched
    buf, count = 0, 0

    def fetch_one():
        emb, done = pending.popleft()
        if done is not None:
            done.synchronize()
        embs.append(emb.numpy())

    def launch():
        nonlocal buf, count
        lo, hi = (0, count) if mesh is None else local_rows(count, mesh)[:2]
        if hi > lo:
            batch = staging[buf][lo:hi].to(device, non_blocking=True)
            pixels = preprocess_batch(batch, n_px, device=device)
            with torch.inference_mode():
                emb = model.model.encode_image(pixels, model.dtype)
        else:  # this process holds no rows of the batch
            emb = torch.zeros((0, model.cfg.embed_dim), device=device)
        if mesh is not None:
            emb = gather_rows(emb, count, mesh)
        done = None
        if pin:  # copied back into pinned memory behind the batch, waited for on fetch
            host = torch.empty(emb.shape, dtype=emb.dtype, pin_memory=True)
            host.copy_(emb, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            emb = host
        pending.append((emb, done))
        buf, count = buf ^ 1, 0
        while len(pending) > 1:  # batch i, once batch i + 1 is launched
            fetch_one()

    for patch, yx in tiles:
        views[buf][count] = patch
        coords.append(yx)
        count += 1
        if count == batch_size:
            launch()
    if count:
        launch()
    while pending:
        fetch_one()

    if not embs:
        dim = model.cfg.embed_dim
        return np.zeros((0, dim), np.float32), np.zeros((0, coord_len), np.int64)
    out = np.concatenate(embs, axis=0)
    if normalize:
        out = out / np.linalg.norm(out, axis=1, keepdims=True)
    return out, np.asarray(coords, np.int64)
