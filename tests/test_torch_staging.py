"""``PLIP.encode_images``' staged route against the composition it replaces.

A batch of RGB or grey images of one H x W is written into one of the
object's two reused host buffers and copied to the device without blocking;
any other batch takes ``load_image_rgb`` and ``preprocess_images``. Both must
give, bit for bit, what that composition gives: ``load_image_rgb`` of each
image, ``preprocess_images`` of the batch, then ``model.encode_image``.
``api.STAGING`` counts each batch under its route.

The CPU tests use the tiny config. The ``cuda`` tests skip without a CUDA
device; on a GPU machine (no JAX needed, hence no conftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_staging.py
"""

import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from plip_tpu_torch import api
from plip_tpu_torch.api import PLIP
from plip_tpu_torch.data.datasets import load_image_rgb
from plip_tpu_torch.models.clip import CLIP
from plip_tpu_torch.models.config import CLIPConfig
from plip_tpu_torch.ops.preprocess import preprocess_images


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return CLIP(CLIPConfig.tiny()).init_params(torch.Generator().manual_seed(0))


def _plip(model, device="cpu"):
    class TinyPLIP(PLIP):
        @staticmethod
        def _load_model(model_name):
            return model, model.cfg

    return TinyPLIP("tiny", device=device, tokenizer=object())


def _composed(plip, images, batch_size):
    """The route the staged one replaces, a batch at a time."""
    n_px = plip.cfg.vision.image_size
    out = []
    with torch.inference_mode():
        for lo in range(0, len(images), batch_size):
            arrays = [load_image_rgb(im) for im in images[lo:lo + batch_size]]
            pixels = preprocess_images(arrays, n_px, device=plip.device)
            out.append(plip.model.encode_image(pixels, plip.dtype))
    return torch.cat(out).cpu().numpy()


def _counted(fn):
    """(``fn()``, the ``STAGING`` counts it added)."""
    api.reset_staging_counts()
    out = fn()
    return out, {k: v for k, v in api.STAGING.items() if v}


def _pil(arr, mode):
    return Image.fromarray(arr).convert(mode)


def _inputs(case, rng):
    """(images, batch_size, the counts by route)."""
    u8 = lambda h, w, c=3: rng.integers(0, 256, (h, w) + ((c,) if c else ()), np.uint8)  # noqa: E731
    if case == "uint8":
        return [u8(40, 40) for _ in range(6)], 3, {"pinned": 2}
    if case == "partial_last_batch":
        return [u8(40, 40) for _ in range(7)], 3, {"pinned": 3}
    if case == "grey":
        return [u8(40, 48, 0) for _ in range(5)], 4, {"pinned": 2}
    if case == "grey_and_rgb":  # one H x W: one buffer
        return [u8(40, 40, 0 if i % 2 else 3) for i in range(4)], 4, {"pinned": 1}
    if case == "float":  # out of uint8's range and fractional: the unsafe cast
        return ([rng.uniform(-40.0, 300.0, (40, 40, 3)) for _ in range(3)]
                + [rng.uniform(-40.0, 300.0, (40, 40)).astype(np.float32)]
                + [rng.integers(-300, 600, (40, 40, 3))], 5, {"pinned": 1})
    if case == "pil":
        return [_pil(u8(36, 44), mode) for mode in ("RGB", "L", "RGBA", "RGB", "P")], 5, \
            {"pinned": 1}
    if case == "non_contiguous":  # crops of one slide, strided
        slide = u8(200, 200)
        return [slide[i:i + 80:2, i:i + 80:2] for i in range(0, 60, 10)], 4, {"pinned": 2}
    if case == "mixed_sizes":
        return [u8(40, 40), u8(48, 48), u8(40, 40)], 3, {"grouped": 1}
    if case == "one_channel":  # [H, W, 1]: not RGB, the grouped route
        return [u8(40, 40, 1) for _ in range(3)], 3, {"grouped": 1}
    if case == "batches_of_both":
        return [u8(40, 40), u8(40, 40), u8(40, 40), u8(48, 48)], 2, {"pinned": 1, "grouped": 1}
    raise ValueError(case)


CASES = ["uint8", "partial_last_batch", "grey", "grey_and_rgb", "float", "pil",
         "non_contiguous", "mixed_sizes", "one_channel", "batches_of_both"]


@pytest.mark.filterwarnings("ignore:invalid value encountered in cast:RuntimeWarning")
@pytest.mark.parametrize("case", CASES)
def test_staged_route_equals_composition(model, case):
    plip = _plip(model)
    images, bs, routes = _inputs(case, np.random.default_rng(CASES.index(case)))
    got, counts = _counted(lambda: plip.encode_images(images, batch_size=bs, num_workers=3))
    np.testing.assert_array_equal(got, _composed(plip, images, bs))
    assert counts == routes


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_paths_staged_once_decoded(model, tmp_path, fmt):
    """Paths (PNG, and JPEG off the native lane) are decoded first; one
    size is staged, two sizes are grouped."""
    rng = np.random.default_rng(5)
    paths = []
    for i, hw in enumerate([(40, 40)] * 3 + [(48, 40)]):
        p = str(tmp_path / f"{i}.{fmt}")
        Image.fromarray(rng.integers(0, 256, hw + (3,), np.uint8)).save(p)
        paths.append(p)
    plip = _plip(model)
    for images, routes in ((paths[:3], {"pinned": 1}), (paths, {"grouped": 1})):
        got, counts = _counted(lambda: plip.encode_images(images, batch_size=4,
                                                          decode_mode="exact"))
        np.testing.assert_array_equal(got, _composed(plip, images, 4))
        assert counts == routes


def test_reused_buffer_holds_no_stale_rows(model):
    """A second call with fewer (and smaller) tiles reuses buffers that
    still hold the first call's rows; it returns what a fresh PLIP does."""
    rng = np.random.default_rng(1)
    plip = _plip(model)
    first = [rng.integers(0, 256, (48, 48, 3), np.uint8) for _ in range(8)]
    second = [rng.integers(0, 256, (40, 40, 3), np.uint8) for _ in range(3)]
    plip.encode_images(first, batch_size=4)
    got = plip.encode_images(second, batch_size=2)
    np.testing.assert_array_equal(got, _plip(model).encode_images(second, batch_size=2))
    np.testing.assert_array_equal(plip.encode_images(first, batch_size=4),
                                  _composed(plip, first, 4))


def test_buffers_grow_and_alternate(model):
    """Two buffers, used in turns, created together and grown together only
    when a batch needs more bytes than they hold."""
    rng = np.random.default_rng(2)
    plip = _plip(model)
    staging = plip._staging
    plip.encode_images([rng.integers(0, 256, (40, 40, 3), np.uint8) for _ in range(6)],
                       batch_size=3)
    assert [b.numel() for b in staging._bufs] == [3 * 40 * 40 * 3] * 2
    assert staging._bufs[0].data_ptr() != staging._bufs[1].data_ptr()
    bufs = list(staging._bufs)
    plip.encode_images([rng.integers(0, 256, (40, 40, 3), np.uint8) for _ in range(2)],
                       batch_size=2)
    assert all(a is b for a, b in zip(staging._bufs, bufs))  # smaller: reused
    plip.encode_images([rng.integers(0, 256, (80, 80, 3), np.uint8)], batch_size=1)
    assert [b.numel() for b in staging._bufs] == [80 * 80 * 3] * 2


def test_unpinnable_buffer_takes_the_pageable_route(model):
    """Where pinned memory cannot be allocated (here: no accelerator) the
    batch goes the grouped way, counted as ``"pageable"``."""
    rng = np.random.default_rng(3)
    plip = _plip(model)
    plip._staging.pin = True
    images = [rng.integers(0, 256, (40, 40, 3), np.uint8) for _ in range(4)]
    got, counts = _counted(lambda: plip.encode_images(images, batch_size=2))
    np.testing.assert_array_equal(got, _composed(plip, images, 2))
    assert counts == {"pageable": 2}


def test_threads_share_one_plip(model):
    """Eight threads on one PLIP, each encoding its own tiles in several
    batches, with thread switches forced often: each gets what a serial
    call gives."""
    rng = np.random.default_rng(4)
    plip = _plip(model)
    inputs = [[rng.integers(0, 256, (40, 40, 3), np.uint8) for _ in range(5)]
              for _ in range(8)]
    want = [plip.encode_images(x, batch_size=2) for x in inputs]
    got = [None] * len(inputs)

    def work(i):
        for _ in range(3):
            got[i] = plip.encode_images(inputs[i], batch_size=2, num_workers=2)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(inputs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_staged_route(model, dev):
    """On the card: the buffers are pinned; a three-batch call (160 tiles at
    batch 64, the last batch short) is bit-equal to the grouped composition
    on the same tiles, every batch through ``"pinned"``."""
    plip = _plip(model, dev)
    rng = np.random.default_rng(6)
    tiles = [rng.integers(0, 256, (64, 64, 3), np.uint8) for _ in range(160)]
    got, counts = _counted(lambda: plip.encode_images(tiles, batch_size=64))
    assert counts == {"pinned": 3}
    assert all(b.is_pinned() for b in plip._staging._bufs)
    np.testing.assert_array_equal(got, _composed(plip, tiles, 64))


@pytest.mark.cuda
def test_card_threads_share_one_plip(model, dev):
    """Two threads calling ``encode_images`` on one PLIP on the card return
    what two serial calls return."""
    plip = _plip(model, dev)
    rng = np.random.default_rng(7)
    inputs = [[rng.integers(0, 256, (64, 64, 3), np.uint8) for _ in range(96)]
              for _ in range(2)]
    want = [plip.encode_images(x, batch_size=32) for x in inputs]
    got = [None, None]

    def work(i):
        got[i] = plip.encode_images(inputs[i], batch_size=32)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
