"""The port's fused preprocessing (K11, ``ops.preprocess_fused``) and its
plain version against the JAX package's (CPU).

- The plain version (the two-matmul ``preprocess_batch``) against
  ``preprocess_batch_pallas`` in Pallas interpret mode at
  ``test_preprocess_pallas.py``'s shapes (256x256, 300x400, 224x224): at most
  one uint8 level apart (``1 / (255 std_c)``), on at most 1e-3 of the
  elements (an fp32 sum within an ulp of a .5 boundary may round to the
  neighbouring level when the sums run in another order);
- the no-quant mode (``emulate_uint8=False``) against the same at atol 1e-4;
- the kernel's plan: a numpy run of its tiling (the column and row tap
  tables, a block's output rows and the band of input rows it reads, uint8
  ``t``, fmaf sums in the taps' order, the normalize's table) gives the
  plain version's output under the same bar; each tap table holds exactly
  its row of the resize matrices; the shared memory it counts holds what a
  block stages and fits a block; a band that does not fit raises;
- ``preprocess_batch(fused=True)`` on the CPU is the plain version, and float
  and int16 images go through it, truncated and wrapped into 0..255, as
  ``preprocess_batch_pallas`` takes them.
"""

import numpy as np
import pytest
import torch

from plip_tpu.ops.preprocess_pallas import preprocess_batch_pallas
from plip_tpu_torch.models.config import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
from plip_tpu_torch.ops import preprocess_fused as PF
from plip_tpu_torch.ops.preprocess import normalize_constants, preprocess_batch
from plip_tpu_torch.ops.resize import resize_crop_matrices


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPES = [(256, 256), (300, 400), (224, 224)]
LEVEL = 1.0 / (255.0 * np.asarray(CLIP_IMAGE_STD, np.float32))  # one uint8 step, per channel


def _images(shape, seed=0, n=2):
    return np.random.default_rng(seed).integers(0, 256, (n, *shape, 3), dtype=np.uint8)


def _assert_within_a_level(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert (d <= LEVEL * (1 + 1e-4) + 1e-5).all(), d.max()
    assert (d > 1e-5).mean() <= 1e-3, (d > 1e-5).mean()


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_tpu_kernel(shape):
    arr = _images(shape)
    _assert_within_a_level(preprocess_batch(arr).numpy(),
                           preprocess_batch_pallas(arr, interpret=True))


def test_no_quant_mode():
    arr = _images((256, 256), seed=1, n=1)
    got = preprocess_batch(arr, emulate_uint8=False).numpy()
    want = np.asarray(preprocess_batch_pallas(arr, emulate_uint8=False, interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-4)


def _fma_sums(w, v):
    """sum_k w[..., k] v[..., k] as fmaf from 0 in the order of k (fp32; the
    product and add in float64, then rounded)."""
    acc = np.zeros(np.broadcast_shapes(w.shape, v.shape)[:-1], np.float32)
    for k in range(v.shape[-1]):
        acc = (w[..., k].astype(np.float64) * v[..., k] + acc).astype(np.float32)
    return acc


def _run_plan(arr, out_size, emulate=True):
    """The kernel's algorithm in numpy, block by block (``csrc/preprocess.cu``)."""
    p = PF.plan(arr.shape[1], arr.shape[2], out_size, emulate)
    quant = (lambda v: np.clip(np.floor(v + np.float32(0.5)), 0, 255)) if emulate else (
        lambda v: v)
    m, s = (t.numpy() for t in normalize_constants(CLIP_IMAGE_MEAN, CLIP_IMAGE_STD, "cpu"))
    lut = ((np.arange(256, dtype=np.float32)[None] - m[:, None]) / s[:, None]).astype(np.float32)
    taps_r, c_w = p.r_w.shape[1], p.c_w[:, :p.taps_c]
    cols = p.c_start[:, None] + np.arange(p.taps_c)  # [out, taps_c]
    out = np.empty((arr.shape[0], out_size, out_size, 3), np.float32)
    for blk, (y0, ny) in enumerate(p.band):
        i0, i1 = blk * p.rows, min((blk + 1) * p.rows, out_size)
        starts = p.r_start[i0:i1]
        assert ny <= p.ny and ((starts >= y0) & (starts + taps_r <= y0 + ny)).all()
        band = arr[:, y0:y0 + ny].astype(np.float32)  # [b, ny, W, 3]
        t = quant(_fma_sums(c_w[None, None, :, None, :],
                            np.moveaxis(band[:, :, cols], 3, 4)))  # [b, ny, out, 3]
        t = t.astype(np.uint8 if emulate else np.float32)
        tv = np.moveaxis(t[:, starts[:, None] - y0 + np.arange(taps_r)].astype(np.float32),
                         2, 4)  # [b, rows, out, 3, taps_r]
        y = _fma_sums(p.r_w[i0:i1, None, None, :], tv)  # [b, rows, out, 3]
        if emulate:
            out[:, i0:i1] = lut[np.arange(3), quant(y).astype(np.int64)]
        else:
            out[:, i0:i1] = (y - m) / s
    return out


@pytest.mark.parametrize("shape,out_size", [((256, 256), 224), ((300, 400), 224),
                                            ((224, 224), 224), ((256, 256), 336),
                                            ((1024, 700), 224), ((2048, 2048), 224),
                                            ((301, 333), 225)])
def test_kernel_plan_gives_the_plain_version(shape, out_size):
    arr = _images(shape, seed=2, n=1)
    _assert_within_a_level(_run_plan(arr, out_size), preprocess_batch(arr, out_size).numpy())
    R, C = resize_crop_matrices(*shape, out_size, out_size)
    for emulate, out_bytes in ((True, 4), (True, 2), (False, 4)):
        p = PF.plan(*shape, out_size, emulate, out_bytes)
        # each window holds every nonzero of its row, with its value
        for m, start, w in ((C, p.c_start, p.c_w[:, :p.taps_c]), (R, p.r_start, p.r_w)):
            dense = np.zeros_like(m)
            np.put_along_axis(dense, start[:, None] + np.arange(w.shape[1]), w, 1)
            assert np.array_equal(dense, m)
        assert p.words == (p.taps_c >= PF.WORD_TAPS)
        assert p.chunk_rows == p.ny or p.chunk_rows % PF.JOB_ROWS[p.words] == 0
        assert not p.c_w[:, p.taps_c:].any() and p.c_w.shape[1] % 2 == 1
        # what a block stages (the normalize's table, the column tables, its
        # rows' tables, t, two chunks), each part padded to 16 bytes
        staged = ((3 * 256 * out_bytes if emulate else 0) + p.c_start.nbytes + p.c_w.nbytes
                  + p.rows * 4 * (1 + p.r_w.shape[1])
                  + p.ny * 3 * out_size * (1 if emulate else 4) + 2 * p.chunk_rows * 3 * shape[1])
        assert staged <= p.smem <= staged + 15 * (5 + p.ny) + 2 * (32 + 15)
        assert p.smem <= PF.MAX_SMEM and 1 <= p.rows <= out_size
        assert len(p.band) == -(-out_size // p.rows) and p.ny == p.band[:, 1].max()
        assert 1 <= p.chunk_rows <= p.ny


def test_kernel_plan_without_quant():
    arr = _images((300, 400), seed=3, n=1)
    np.testing.assert_allclose(_run_plan(arr, 224, emulate=False),
                               preprocess_batch(arr, emulate_uint8=False).numpy(), atol=1e-4)


def test_plan_refuses_a_band_that_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        PF.plan(20000, 20000, 224)


def test_fused_flag_on_the_cpu():
    arr = _images((256, 256), seed=4)
    want = preprocess_batch(arr)
    assert torch.equal(preprocess_batch(arr, fused=True), want)
    assert torch.equal(PF.preprocess_batch_fused(torch.from_numpy(arr)), want)
    assert torch.equal(PF.preprocess_batch_fused(arr[0]), want[:1])
    assert preprocess_batch(arr, fused=True, dtype=torch.bfloat16).dtype == torch.bfloat16
    assert torch.equal(PF.preprocess_batch_fused(arr, dtype=torch.bfloat16),
                       preprocess_batch(arr, dtype=torch.bfloat16))
    assert PF.LAUNCHES["preprocess_fused"] == 0


def test_float_and_int_input_as_the_jax_wrapper():
    """Float images in [-40, 300] with fractional parts and an int16 batch:
    truncated to int32 and wrapped into 0..255, as ``preprocess_batch_pallas``
    takes them."""
    rng = np.random.default_rng(5)
    floats = rng.uniform(-40, 300, (2, 256, 256, 3)).astype(np.float32)
    ints = rng.integers(-300, 600, (2, 256, 256, 3)).astype(np.int16)
    for arr in (floats, ints):
        want = preprocess_batch_pallas(arr, interpret=True)
        _assert_within_a_level(preprocess_batch(arr, fused=True).numpy(), want)
        _assert_within_a_level(PF.preprocess_batch_fused(torch.from_numpy(arr)).numpy(), want)
