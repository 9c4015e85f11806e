"""The port's WSI streaming (``data.wsi``) and its copy of
``background_ratio`` against the JAX package's (CPU).

- ``iter_wsi_tiles`` and ``iter_wsi_pyramid`` give the JAX iterators' tiles
  and coordinates, tile for tile (``tests/test_wsi.py``'s grids, overlap,
  downsample, background filter, too-small levels), and the pyramid equals
  the reference's offline sweep (``sliding_crop``).
- ``embed_wsi`` and ``embed_wsi_pyramid`` over the port's ``PLIP`` on the CPU
  against the JAX package's over its ``PLIP``, on the same tiny ``.npz``:
  the coordinates equal, the embeddings L2-normalized rows at the fp32 bars
  (row cosine > 0.9999, allclose 2e-4, ``tests/test_wsi.py``'s), and equal
  to the port's ``encode_images`` of the same tiles; an all-background slide
  gives empty arrays; batches that do not divide the tiles.
- A tower at another input size than 224 (the JAX package preprocesses
  every tile at 224 and fails there): the port's stream preprocesses at the
  tower's ``image_size``.
"""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from plip_tpu.api import PLIP as JPLIP
from plip_tpu.data import wsi as jwsi
from plip_tpu.datagen import preprocess_digestpath as jdigest
from plip_tpu.models import clip as jclip
from plip_tpu.models.config import CLIPConfig, TextConfig, VisionConfig
from plip_tpu.utils.checkpoint import save_checkpoint
from plip_tpu_torch.api import PLIP
from plip_tpu_torch.data import wsi
from plip_tpu_torch.datagen import preprocess_digestpath as tdigest


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ckpt(path, image_size=224):
    cfg = CLIPConfig(
        vision=VisionConfig(width=32, layers=1, heads=2, image_size=image_size, patch_size=32),
        text=TextConfig(width=32, layers=1, heads=2, vocab_size=512, context_length=16),
        embed_dim=8,
    )
    params = jax.jit(jclip.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    save_checkpoint(path, params, cfg)
    return path


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = _ckpt(str(tmp_path_factory.mktemp("wsi") / "m.npz"))
    return JPLIP(path), PLIP(path, device="cpu")


def _synthetic_wsi(h=1600, w=2000, seed=0):
    """``tests/test_wsi.py``'s slide: white with tissue blobs."""
    rng = np.random.default_rng(seed)
    arr = np.full((h, w, 3), 255, np.uint8)
    for _ in range(12):
        y, x = rng.integers(0, h - 400), rng.integers(0, w - 400)
        bh, bw = rng.integers(200, 400, 2)
        arr[y: y + bh, x: x + bw] = rng.integers(60, 190, (bh, bw, 3))
    return Image.fromarray(arr)


def _same_stream(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for (gp, gc), (wp, wc) in zip(got, want):
        assert tuple(int(c) for c in gc) == tuple(int(c) for c in wc)
        np.testing.assert_array_equal(gp, wp)
    return got


def _close(got, want):
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() > 0.9999
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_background_ratio_copy():
    rng = np.random.default_rng(0)
    for t in (0, 200, 255):
        for arr in (rng.integers(150, 256, (37, 53, 3), dtype=np.uint8),
                    np.full((8, 8, 3), 255, np.uint8), np.zeros((4, 6, 3), np.uint8)):
            assert tdigest.background_ratio(arr, t) == jdigest.background_ratio(arr, t)


@pytest.mark.parametrize("kw", [dict(), dict(overlap=0.5), dict(downsample=2),
                                dict(non_bg_threshold=0.5), dict(tile=100, overlap=0.3)])
def test_iter_tiles_match_jax(kw):
    rng = np.random.default_rng(1)
    arr = rng.integers(40, 180, (500, 700, 3), dtype=np.uint8)
    arr[:300, :250] = 255  # some background
    got = _same_stream(wsi.iter_wsi_tiles(arr, **kw), jwsi.iter_wsi_tiles(arr, **kw))
    assert got
    # a PIL input takes PIL's downsample, as in the JAX package
    _same_stream(wsi.iter_wsi_tiles(Image.fromarray(arr), **kw),
                 jwsi.iter_wsi_tiles(Image.fromarray(arr), **kw))


def test_iter_tiles_grid_and_filter():
    """``tests/test_wsi.py``'s cases on the port."""
    tiles = list(wsi.iter_wsi_tiles(np.full((500, 700, 3), 100, np.uint8)))
    assert len(tiles) == 6 and tiles[0][0].shape == (224, 224, 3) and tiles[0][1] == (0, 0)
    arr = np.full((896, 896, 3), 100, np.uint8)
    assert len(list(wsi.iter_wsi_tiles(arr, overlap=0.5))) > len(list(wsi.iter_wsi_tiles(arr)))
    assert len(list(wsi.iter_wsi_tiles(arr, downsample=2))) == 4
    bg = np.full((448, 448, 3), 255, np.uint8)
    bg[:224, :224] = 80
    tiles = list(wsi.iter_wsi_tiles(bg, non_bg_threshold=0.5))
    assert len(tiles) == 1 and tiles[0][1] == (0, 0)


def test_pyramid_matches_jax_and_the_offline_sweep(tmp_path):
    img = _synthetic_wsi()
    downs = (2, 4, 8, 16, 32)
    got = _same_stream(wsi.iter_wsi_pyramid(img, downsample_list=downs),
                       jwsi.iter_wsi_pyramid(img, downsample_list=downs))
    i = 0
    for d in downs:
        patches, _ = jdigest.sliding_crop(img, downsample=d, cropsize=224, crop_overlap=0.1,
                                          non_bg_threshold=0.5)
        for j in range(0 if patches is None else patches.shape[0]):
            assert got[i][1][0] == d
            np.testing.assert_array_equal(got[i][0], patches[j])
            i += 1
    assert i == len(got) > 0
    # a path and an array give the same stream
    path = str(tmp_path / "slide.png")
    img.save(path)
    _same_stream(wsi.iter_wsi_pyramid(path, (4, 8)), jwsi.iter_wsi_pyramid(path, (4, 8)))
    _same_stream(wsi.iter_wsi_pyramid(np.asarray(img), (4,)),
                 jwsi.iter_wsi_pyramid(np.asarray(img), (4,)))


def test_pyramid_skips_too_small_levels():
    img = _synthetic_wsi(h=500, w=500)
    streamed = list(wsi.iter_wsi_pyramid(img, downsample_list=(1, 4)))
    assert streamed and all(c[0] == 1 for _, c in streamed)


@pytest.mark.parametrize("batch_size", [4, 5])
def test_embed_wsi_matches_jax(models, batch_size):
    jm, tm = models
    rng = np.random.default_rng(0)
    arr = rng.integers(40, 180, (500, 700, 3), dtype=np.uint8)
    emb, coords = wsi.embed_wsi(tm, arr, batch_size=batch_size)
    want, want_coords = jwsi.embed_wsi(jm, arr, batch_size=batch_size)
    assert emb.shape == (6, 8) and emb.dtype == np.float32
    assert coords.dtype == np.int64 and coords.shape == (6, 2)
    np.testing.assert_array_equal(coords, want_coords)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, rtol=1e-5)
    _close(emb, want)
    tiles = [t for t, _ in wsi.iter_wsi_tiles(arr)]
    direct = tm.encode_images(tiles, batch_size=4)
    np.testing.assert_allclose(emb, direct / np.linalg.norm(direct, axis=1, keepdims=True),
                               rtol=1e-5, atol=1e-6)
    raw, _ = wsi.embed_wsi(tm, arr, batch_size=batch_size, normalize=False)
    np.testing.assert_allclose(raw, direct, rtol=1e-5, atol=1e-6)


def test_embed_wsi_pyramid_matches_jax(models):
    jm, tm = models
    img = _synthetic_wsi(h=900, w=900, seed=3)
    kw = dict(downsample_list=(1, 2), batch_size=4, non_bg_threshold=0.3)
    emb, coords = wsi.embed_wsi_pyramid(tm, img, **kw)
    want, want_coords = jwsi.embed_wsi_pyramid(jm, img, **kw)
    assert coords.shape[1] == 3 and set(coords[:, 0]) <= {1, 2} and len(coords) > 4
    np.testing.assert_array_equal(coords, want_coords)
    _close(emb, want)


def test_embed_wsi_all_background(models):
    _, tm = models
    emb, coords = wsi.embed_wsi(tm, np.full((448, 448, 3), 255, np.uint8),
                                non_bg_threshold=0.5)
    assert emb.shape == (0, 8) and coords.shape == (0, 2)
    emb, coords = wsi.embed_wsi_pyramid(tm, np.full((448, 448, 3), 255, np.uint8), (1,))
    assert emb.shape == (0, 8) and coords.shape == (0, 3)


def test_stream_preprocesses_at_the_towers_size(tmp_path):
    path = _ckpt(str(tmp_path / "px64.npz"), image_size=64)
    tm = PLIP(path, device="cpu")
    rng = np.random.default_rng(2)
    arr = rng.integers(40, 180, (448, 448, 3), dtype=np.uint8)
    emb, coords = wsi.embed_wsi(tm, arr, batch_size=3)
    tiles = [t for t, _ in wsi.iter_wsi_tiles(arr)]
    direct = tm.encode_images(tiles)
    assert emb.shape == (4, 8)
    np.testing.assert_allclose(emb, direct / np.linalg.norm(direct, axis=1, keepdims=True),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(Exception):  # the JAX stream preprocesses at 224
        jwsi.embed_wsi(JPLIP(path), arr, batch_size=3)
    assert os.path.exists(path)
