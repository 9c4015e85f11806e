"""The towers' LayerNorm (``ops.attention.layer_norm_rows``) against the JAX
package, and the plans of its two kernels, on the CPU.

``layer_norm_rows`` is an autograd function whose forward is K1's ``ln_rows``
and whose backward is K2's ``ln_bwd_rows`` (no residual) and ``col_sum`` of
its partials; on the CPU each wrapper takes its plain version, so these tests
hold the function's wiring. The same inputs, made with numpy from a seed, go
through ``plip_tpu.models.layers.layer_norm`` and ``jax.vjp`` of it. Bars:
fp32 allclose 1e-5 (the summed dscale and dbias: atol 1e-5 of the leaf's
RMS, since each sums every row); bf16 output within one bf16 ulp of the
row's largest value of the JAX package's, grads cosine >= 0.9999.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plip_tpu.models import layers as JL
from plip_tpu_torch.ops import attention as T
from plip_tpu_torch.ops import attention_bwd as TB


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EPS = 1e-5
BF16 = torch.bfloat16
JAX_DTYPES = {torch.float32: jnp.float32, BF16: jnp.bfloat16}


def _inputs(shape, W, seed):
    """(x, scale, bias, the output's grad) as fp32 numpy arrays; x [B, S, W]
    (``x[:, 0]`` taken by the caller), [B*S, W] or [B, S, W]."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((*shape, W)) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(W)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(W)).astype(np.float32)
    return x, scale, bias, rng.standard_normal((*shape, W)).astype(np.float32)


@functools.partial(jax.jit, static_argnums=4)
def _jax_vjp(x, scale, bias, g, strided):
    def f(x, scale, bias):
        return JL.layer_norm(x[:, 0] if strided else x, {"scale": scale, "bias": bias}, EPS)

    y, vjp = jax.vjp(f, x, scale, bias)
    return (y, *vjp(g))


def _jax(x, scale, bias, g, dtype, strided):
    """JAX's forward and (dx, dscale, dbias) of layer_norm on the same inputs."""
    jdt = JAX_DTYPES[dtype]
    out = _jax_vjp(jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias),
                   jnp.asarray(g, jdt), strided)
    return [np.asarray(t.astype(jnp.float32)) for t in out]


def _torch(x, scale, bias, g, dtype, strided):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    st, bt = (torch.from_numpy(t).requires_grad_() for t in (scale, bias))
    y = T.layer_norm_rows(xt[:, 0] if strided else xt, st, bt, EPS)
    assert y.dtype == dtype and y.shape == (xt[:, 0] if strided else xt).shape
    y.backward(torch.from_numpy(g).to(dtype))
    assert xt.grad.dtype == dtype and st.grad.dtype == bt.grad.dtype == torch.float32
    return [t.detach().float().numpy() for t in (y, xt.grad, st.grad, bt.grad)]


def _row_ulp_bf16(v):
    """One bf16 ulp of each row's largest |v| (8 bits of mantissa)."""
    top = np.abs(v).max(-1, keepdims=True)
    return 2.0 ** (np.floor(np.log2(np.maximum(top, 2.0 ** -126))) - 7)


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("W", [32, 100, 512, 768, 1024])
@pytest.mark.parametrize("layout", ["3d", "2d", "strided"])
def test_layer_norm_rows_matches_jax(dtype, W, layout):
    shape = {"3d": (2, 5), "2d": (7,), "strided": (3, 4)}[layout]
    x, scale, bias, g = _inputs(shape, W, seed=W)
    strided = layout == "strided"
    if strided:
        g = g[:, 0]
    T.reset_launch_counts()
    TB.reset_launch_counts()
    got = _torch(x, scale, bias, g, dtype, strided)
    want = _jax(x, scale, bias, g, dtype, strided)
    assert set(T.LAUNCHES.values()) == set(TB.LAUNCHES.values()) == {0}
    names = ("y", "dx", "dscale", "dbias")
    if dtype == torch.float32:
        for name, a, b in zip(names, got, want):
            atol = 1e-5 * (np.sqrt(np.mean(b ** 2)) if name in ("dscale", "dbias") else 1)
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol, err_msg=name)
    else:
        assert np.all(np.abs(got[0] - want[0]) <= _row_ulp_bf16(want[0])), "y: over one ulp"
        for name, a, b in zip(names[1:], got[1:], want[1:]):
            assert _cos(a, b) >= 0.9999, (name, _cos(a, b))


def test_layer_norm_rows_without_grad_is_the_plain_version():
    x, scale, bias, _ = _inputs((3, 6), 48, seed=1)
    args = (torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), EPS)
    with torch.no_grad():
        torch.testing.assert_close(T.layer_norm_rows(*args),
                                   T.layer_norm_rows_reference(*args), rtol=0, atol=0)


@pytest.mark.parametrize("N", [1, 21, 1001, 6400, 9856, 19712])
def test_planned_partial_sums_match_the_old_split(N):
    """The partial rows of ``ln_bwd_rows_reference`` (one per block of
    ``ln_bwd_split``'s rows), summed by ``col_sum_reference``, against the
    same sums taken over blocks of 8 rows, the kernel's first split."""
    W = 64
    rng = np.random.default_rng(N)
    x, dln = (torch.from_numpy(rng.standard_normal((N, W)).astype(np.float32))
              for _ in range(2))
    scale = torch.from_numpy((1 + 0.1 * rng.standard_normal(W)).astype(np.float32))
    dx, partial = TB.ln_bwd_rows_reference(x, dln, None, scale, EPS)
    rows = TB.ln_bwd_split(N, W)
    assert partial.shape == (-(-N // rows), 2 * W)
    assert partial.shape[0] <= TB.LN_BWD_BLOCKS_PER_SM * TB.H100_SMS
    x32 = x.double()
    xhat = (x32 - x32.mean(-1, keepdim=True)) * torch.rsqrt(x32.var(-1, unbiased=False,
                                                                   keepdim=True) + EPS)
    old = torch.cat([dln * xhat.float(), dln], 1)
    old = torch.nn.functional.pad(old, (0, 0, 0, (-N) % 8)).view(-1, 8, 2 * W).sum(1)
    want = TB.col_sum_reference(old)
    rms = want.square().mean().sqrt().item()
    torch.testing.assert_close(TB.col_sum_reference(partial), want, rtol=1e-5,
                               atol=1e-5 * rms)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("max_values", [T.LN_MAX_VALUES, T.LN_BWD_MAX_VALUES])
def test_ln_layout_holds_every_width(itemsize, aligned, max_values):
    """The register layout covers every value of a row once, within a lane's
    bucket and the warps of a block, for widths 1 to past ``LN_MAX_WIDTH``;
    the towers' widths take one warp a row where their values fit it."""
    for W in [*range(1, 130), 255, 256, 257, 512, 768, 1000, 1024, 1280, 1664, 4096, 8191,
              T.LN_MAX_WIDTH, T.LN_MAX_WIDTH + 1, 20000]:
        lay = T.ln_layout(W, itemsize, aligned, max_values)
        if W > T.LN_MAX_WIDTH:
            assert lay.warps == 0, W
            continue
        assert lay.vec in (1, 16 // itemsize) and W % lay.vec == 0
        assert (lay.vec > 1) == (aligned and W % (16 // itemsize) == 0)
        assert lay.warps in (1, 2, 4, 8) and lay.values in T.LN_BUCKETS
        assert lay.values % lay.vec == 0
        lanes = 32 * lay.warps
        assert lay.values // lay.vec * lanes >= W // lay.vec, (W, lay)  # every chunk held
        need = -(-(W // lay.vec) // lanes) * lay.vec
        assert need <= max_values or lay.warps == 8, (W, lay)
        if lay.warps > 1:  # fewer warps would pass the cap
            assert -(-(W // lay.vec) // (lanes // 2)) * lay.vec > max_values
    fwd = {W: T.ln_layout(W, itemsize, True) for W in (512, 768, 1024)}
    assert all(lay.warps == 1 for lay in fwd.values()), fwd


def test_ln_rows_plan_fills_the_card():
    lay = T.ln_layout(768, 2, True)
    assert T.ln_rows_plan(6400, lay) == T.LN_BLOCKS_PER_SM * T.H100_SMS
    assert T.ln_rows_plan(20, lay) == 3  # 8 rows a block of one-warp rows
    assert T.ln_rows_plan(5, T.ln_layout(20000, 2, True)) == 5  # one block a row


def test_ln_bwd_rows_takes_the_grad_in_the_compute_dtype():
    """bf16 dln and no residual (the function's backward) against fp32 dln and
    a zero residual: the same dx and partials."""
    N, W = 40, 96
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((N, W)).astype(np.float32)).to(BF16)
    dln = torch.from_numpy(rng.standard_normal((N, W)).astype(np.float32)).to(BF16)
    scale = torch.from_numpy((1 + 0.1 * rng.standard_normal(W)).astype(np.float32))
    dx, partial = TB.ln_bwd_rows(x, dln, None, scale)
    dx0, partial0 = TB.ln_bwd_rows(x, dln.float(), torch.zeros_like(x), scale)
    assert dx.dtype == BF16
    torch.testing.assert_close(dx, dx0, rtol=0, atol=0)
    torch.testing.assert_close(partial, partial0, rtol=0, atol=0)
