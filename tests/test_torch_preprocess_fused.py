"""The port's fused preprocessing (K11, ``ops.preprocess_fused``) and its
plain version against the JAX package's (CPU).

- The plain version (the two-matmul ``preprocess_batch``) against
  ``preprocess_batch_pallas`` in Pallas interpret mode at
  ``test_preprocess_pallas.py``'s shapes (256x256, 300x400, 224x224): at most
  one uint8 level apart (``1 / (255 std_c)``), on at most 1e-3 of the
  elements (an fp32 sum within an ulp of a .5 boundary may round to the
  neighbouring level when the sums run in another order);
- the no-quant mode (``emulate_uint8=False``) against the same at atol 1e-4;
- the kernel's plan: a numpy run of its tiling (a block's output rows, the
  width-pass rows it keeps, the nonzero extents it sums over) gives the plain
  version's output under the same bar, and every nonzero of the resize
  matrices lies inside its row's extent;
- ``preprocess_batch(fused=True)`` on the CPU is the plain version, and a
  float input raises.
"""

import numpy as np
import pytest
import torch

from plip_tpu.ops.preprocess_pallas import preprocess_batch_pallas
from plip_tpu_torch.models.config import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
from plip_tpu_torch.ops import preprocess_fused as PF
from plip_tpu_torch.ops.preprocess import normalize_constants, preprocess_batch

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


def _run_plan(arr, out_size, emulate=True):
    """The kernel's algorithm in numpy fp32, block by block (``csrc/preprocess.cu``)."""
    R, C, r_lo, r_hi, c_lo, c_hi, rows, ny = PF.plan(arr.shape[1], arr.shape[2], out_size)
    quant = (lambda v: np.clip(np.floor(v + np.float32(0.5)), 0, 255)) if emulate else (
        lambda v: v)
    m, s = (t.numpy() for t in normalize_constants(CLIP_IMAGE_MEAN, CLIP_IMAGE_STD, "cpu"))
    out = np.empty((arr.shape[0], out_size, out_size, 3), np.float32)
    img = arr.astype(np.float32)
    for i0 in range(0, out_size, rows):
        i1 = min(i0 + rows, out_size)
        y0, y1 = r_lo[i0:i1].min(), r_hi[i0:i1].max()
        assert y1 - y0 <= ny
        t = np.zeros((arr.shape[0], y1 - y0, out_size, 3), np.float32)
        for j in range(out_size):
            band = img[:, y0:y1, c_lo[j]:c_hi[j], :]
            t[:, :, j] = quant(np.einsum("byxc,x->byc", band, C[j, c_lo[j]:c_hi[j]]))
        for i in range(i0, i1):
            y = quant(np.einsum("byjc,y->bjc", t[:, r_lo[i] - y0:r_hi[i] - y0],
                                R[i, r_lo[i]:r_hi[i]]))
            out[:, i] = (y - m) / s
    return out


@pytest.mark.parametrize("shape,out_size", [((256, 256), 224), ((300, 400), 224),
                                            ((224, 224), 224), ((256, 256), 336),
                                            ((1024, 700), 224)])
def test_kernel_plan_gives_the_plain_version(shape, out_size):
    arr = _images(shape, seed=2, n=1)
    _assert_within_a_level(_run_plan(arr, out_size), preprocess_batch(arr, out_size).numpy())
    R, C, r_lo, r_hi, c_lo, c_hi, rows, ny = PF.plan(*shape, out_size)
    for m, lo, hi in ((R, r_lo, r_hi), (C, c_lo, c_hi)):
        cols = np.arange(m.shape[1])
        inside = (cols >= lo[:, None]) & (cols < hi[:, None])
        assert not (m[~inside] != 0).any()
    assert 12 * ny * out_size <= PF.MAX_SMEM and 1 <= rows <= PF.ROWS


def test_kernel_plan_without_quant():
    arr = _images((300, 400), seed=3, n=1)
    np.testing.assert_allclose(_run_plan(arr, 224, emulate=False),
                               preprocess_batch(arr, emulate_uint8=False).numpy(), atol=1e-4)


def test_fused_flag_on_the_cpu():
    arr = _images((256, 256), seed=4)
    want = preprocess_batch(arr)
    assert torch.equal(preprocess_batch(arr, fused=True), want)
    assert torch.equal(PF.preprocess_batch_fused(torch.from_numpy(arr)), want)
    assert torch.equal(PF.preprocess_batch_fused(arr[0]), want[:1])
    assert preprocess_batch(arr, fused=True, dtype=torch.bfloat16).dtype == torch.bfloat16
    assert PF.LAUNCHES["preprocess_fused"] == 0


def test_float_input_raises():
    arr = _images((256, 256), seed=5).astype(np.float32)
    with pytest.raises(ValueError, match="uint8"):
        preprocess_batch(arr, fused=True)
    with pytest.raises(ValueError, match="uint8"):
        PF.preprocess_batch_fused(torch.from_numpy(arr))
