"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device. On a GPU machine
(no JAX needed, hence no conftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Bars: fp32 allclose atol 1e-4, rtol 1e-4 (TF32 off); bf16 per-row cosine
>= 0.999 and allclose atol 3e-2, rtol 1e-2 (one bf16 rounding step is 2^-8
of the value). For a grad whose elements sum the B*S token rows (weights,
biases, LN parameters) the atol is scaled by the leaf's RMS. The attention
cores round P where their plain versions do, so in bf16 they are also held
to every element within one bf16 ulp of its row's largest |value|, with at
most ``CORE_DIFFER`` of the elements not bit-equal; a plain version with a
fault in the softmax's rounding schedule fails that bar. The key-tiled core
backwards (K4, and K2's core past 128 tokens) are held in bf16 to at most
``BWD_DIFFER`` of dqkv's elements not bit-equal and every element within
``BWD_ULPS`` ulps of its row's largest |value|; the plain version in the
other schedule (normalize-first against deferred divide) fails that bar.
K2's bf16 core backward is held to the same bar at every S (its one-block
wgmma kernel up to 128 tokens, the key-tiled pair past them)."""

from unittest import mock

import pytest
import torch

from plip_tpu_torch.ops import attention as T
from plip_tpu_torch.ops import attention_bwd as TB
from plip_tpu_torch.ops import mha as M

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, want, dtype):
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).min().item()
        assert cos >= 0.999, cos
        torch.testing.assert_close(got, want, atol=3e-2, rtol=1e-2)


# The largest share of a bf16 core's elements that may differ from the plain
# version: on the H100 the kernels differ in at most 0.23%, the schedule
# faults of test_core_bar_rejects_schedule_faults in at least 1.4%.
CORE_DIFFER = 0.005


def _ulp_stats(got, want):
    """(share of the elements that differ, the worst |got - want| in bf16
    ulps of the largest |want| of its row)."""
    d = (got.float() - want.float()).abs()
    _, e = torch.frexp(want.float().abs().amax(-1, keepdim=True))
    row_ulp = torch.ldexp(torch.ones_like(d), e - 8)
    return (d != 0).float().mean().item(), (d / row_ulp).max().item()


def _assert_core_close(got, want, dtype, ulps_bar=1):
    """An attention core's bars (module docstring)."""
    _assert_close(got, want, dtype)
    if dtype == torch.bfloat16:
        differ, ulps = _ulp_stats(got, want)
        assert differ <= CORE_DIFFER and ulps <= ulps_bar, (differ, ulps)


def _plain_layer_norm():
    """The towers' LayerNorm (``T.layer_norm_rows``, as ``models.layers``,
    ``ops.mlp`` and ``ops.attention`` call it) on its plain version, so that
    a patched plain path launches no LayerNorm kernel."""
    import contextlib

    from plip_tpu_torch.models import layers as tlayers
    from plip_tpu_torch.ops import mlp as tmlp

    stack = contextlib.ExitStack()
    for mod in (T, tmlp, tlayers):
        stack.enter_context(mock.patch.object(mod, "layer_norm_rows",
                                              T.layer_norm_rows_reference))
    return stack


def _randn(*shape, dev, std=1.0, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g) * std).to(dev)


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,width", [(1, 32), (37, 768), (3200, 512)])
def test_ln_rows(dev, dtype, rows, width):
    x = _randn(rows, width, dev=dev).to(dtype)
    s, b = 1 + _randn(width, dev=dev, std=0.1, seed=1), _randn(width, dev=dev, seed=2)
    T.reset_launch_counts()
    got = T.ln_rows(x, s, b)
    assert T.LAUNCHES["ln_rows"] == 1
    _assert_close(got, T.layer_norm_rows_reference(x, s, b), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N", [(37, 40, 24), (64, 64, 64), (1600, 768, 2304),
                                   (2464, 512, 512)])
@pytest.mark.parametrize("residual", [False, True])
def test_gemm_bias_residual(dev, dtype, M, K, N, residual):
    a = _randn(M, K, dev=dev).to(dtype)
    w = _randn(K, N, dev=dev, std=K ** -0.5, seed=1).to(dtype)
    bias = _randn(N, dev=dev, std=0.1, seed=2)
    r = _randn(M, N, dev=dev, seed=3).to(dtype) if residual else None
    T.reset_launch_counts()
    got = T.gemm_bias_residual(a, w, bias, r)
    assert T.LAUNCHES["gemm_bias_residual"] == 1
    _assert_close(got, T.gemm_bias_residual_reference(a, w, bias, r), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,heads,D,causal,s_valid", [
    (2, 1, 2, 16, False, None),
    (3, 33, 4, 32, True, 30),
    (32, 50, 12, 64, False, None),
    (32, 77, 8, 64, True, None),
    (4, 128, 2, 128, True, 100),
    (3, 129, 4, 32, True, None),  # the first deferred-divide length
    (32, 197, 12, 64, False, None),  # ViT-B/16 vision
    (4, 256, 2, 64, True, 200),
    (3, 193, 2, 96, True, 180),  # v over k (attention.core_v_over_k)
    (2, 192, 2, 128, False, 190),
    (2, 256, 2, 128, False, None),
    (2, 257, 4, 64, True, 250),  # the first key-tiled length (csrc/mha.cu)
    (2, 513, 2, 64, False, None),
    (32, 577, 16, 64, False, None),  # ViT-L/14@336px vision, training
    (2, 1000, 2, 64, True, 900),
    (3, 64, 4, 64, False, 60),
    (3, 65, 4, 64, False, None),
    (5, 257, 4, 64, False, 251),
    (3, 577, 4, 64, True, 570),
    (1, 1056, 4, 64, False, None),
    (3, 1056, 2, 64, False, 1049),
])
def test_attn_core(dev, dtype, B, S, heads, D, causal, s_valid):
    """Every route of core_route against the plain version: bf16 at head_dim
    64 on wgmma up to 128 tokens; fp32, and bf16 at another head_dim, on the
    one-block CUDA-core kernel up to 256 tokens (head_dim a multiple of 4 up
    to 128; v over k where both would not fit); past them the key-tiled
    kernel (head_dim 64)."""
    qkv = _randn(B * S, 3 * heads * D, dev=dev).to(dtype)
    T.reset_launch_counts()
    got = T.attn_core(qkv, S, heads, causal, s_valid)
    assert T.LAUNCHES["attn_core"] == 1
    _assert_core_close(got, T.attn_core_reference(qkv, S, heads, causal, s_valid), dtype)


class _LibSpy:
    """The kernel library with a count of the calls of each entry point."""

    def __init__(self, lib):
        self.lib, self.calls = lib, {}

    def __getattr__(self, name):
        fn = getattr(self.lib, name)

        def counted(*args):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*args)
        return counted


def _spy_lib(module):
    spy = _LibSpy(module._lib())
    return spy, mock.patch.object(module, "_lib", lambda: spy)


@pytest.mark.parametrize("defer", [False, True])
@pytest.mark.parametrize("B,S,heads,causal,s_valid", [
    (32, 50, 12, False, None),  # ViT-B/32 vision
    (32, 77, 8, True, None),  # text
    (32, 77, 8, True, 70),  # text with pad columns
    (8, 128, 4, False, 121), (8, 128, 4, True, None),
    (8, 129, 4, False, None), (8, 129, 4, True, 122),
    (32, 197, 12, False, None),  # ViT-B/16 vision
    (8, 197, 12, True, 190),
    (8, 256, 4, False, 249), (8, 256, 4, True, None),
])
def test_attn_core_one_block_schedules(dev, defer, B, S, heads, causal, s_valid):
    """bf16 attn_core in either softmax schedule at every S up to 256: the
    cores' bars against the plain version; the one-block wgmma core
    (csrc/attention_sublayer.cu) up to 128 tokens, the key-tiled kernel
    (csrc/mha.cu) past them."""
    qkv = _randn(B * S, 3 * heads * 64, dev=dev, seed=S).bfloat16()
    spy, patch = _spy_lib(T)
    with patch:
        got = T.attn_core(qkv, S, heads, causal, s_valid, defer)
    one_block = S <= T.BF16_ROW_MAX_SEQ
    assert spy.calls == {"plip_attn_core" if one_block else "plip_attn_core_tiled": 1}
    _assert_core_close(got, T.attn_core_reference(qkv, S, heads, causal, s_valid, defer),
                       torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,W,heads,causal,s_valid", [
    (32, 50, 768, 12, False, None),
    (32, 77, 512, 8, True, None),
    (32, 77, 512, 8, True, 70),
])
def test_attention_sublayer(dev, dtype, B, S, W, heads, causal, s_valid):
    x = _randn(B, S, W, dev=dev).to(dtype)
    ln = {"scale": 1 + _randn(W, dev=dev, std=0.1, seed=1),
          "bias": _randn(W, dev=dev, std=0.05, seed=2)}
    attn = {"qkv": {"kernel": _randn(W, 3 * W, dev=dev, std=W ** -0.5, seed=3),
                    "bias": _randn(3 * W, dev=dev, std=0.02, seed=4)},
            "out": {"kernel": _randn(W, W, dev=dev, std=W ** -0.5, seed=5),
                    "bias": _randn(W, dev=dev, std=0.02, seed=6)}}
    T.reset_launch_counts()
    got = T.attention_sublayer(x, ln, attn, heads, causal, s_valid)
    assert T.LAUNCHES == {"ln_rows": 1, "gemm_bias_residual": 2, "attn_core": 1}
    want = T.attention_sublayer_reference(x, ln, attn, heads, causal, s_valid)
    _assert_close(got.reshape(B * S, W), want.reshape(B * S, W), dtype)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = torch.randn(20, 64, device=dev)
    s = torch.ones(64, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        T.ln_rows(x.half(), s, s)
    with pytest.raises(ValueError, match="contiguous"):
        T.ln_rows(torch.randn(64, 20, device=dev).t(), s, s)
    with pytest.raises(ValueError, match="expected cuda"):
        T.ln_rows(x, s.cpu(), s.cpu())
    with pytest.raises(ValueError, match="K % 8"):
        T.gemm_bias_residual(x[:, :60].contiguous().bfloat16(),
                             torch.zeros(60, 8, device=dev, dtype=torch.bfloat16),
                             torch.zeros(8, device=dev))
    with pytest.raises(ValueError, match="S <= 1056"):
        T.attn_core(torch.zeros(2114, 384, device=dev), 1057, 2)
    # head_dim 136, which raised before: the key-tiled kernels in 128-column chunks
    for dtype in DTYPES:
        qkv = _randn(514, 816, dev=dev).to(dtype)
        _assert_core_close(T.attn_core(qkv, 257, 2), T.attn_core_reference(qkv, 257, 2), dtype)
        g = _randn(258, 272, dev=dev, seed=1).to(dtype)
        for a, b in zip(TB.attn_core_bwd(qkv[:258], g, 129, 2),
                        TB.attn_core_bwd_reference(qkv[:258], g, 129, 2)):
            _assert_bwd_close(a, b, dtype)
    with pytest.raises(ValueError, match="dtype"):
        T.gemm_bias_residual(x, torch.zeros(64, 8, device=dev, dtype=torch.bfloat16),
                             torch.zeros(8, device=dev))
    # the head widths the key-tiled kernels took only at 64 before: now run
    for dt, S, D, bwd in ((torch.float32, 257, 16, False), (torch.bfloat16, 257, 32, False),
                          (torch.bfloat16, 129, 32, True)):
        qkv = _randn(2 * S, 3 * 2 * D, dev=dev).to(dt)
        assert T.core_route(S, D, dt, bwd) == "tiled"
        if bwd:
            g = _randn(2 * S, 2 * D, dev=dev, seed=1).to(dt)
            ctx, dqkv = TB.attn_core_bwd(qkv, g, S, 2)
            want_ctx, want_dqkv = TB.attn_core_bwd_reference(qkv, g, S, 2)
            _assert_core_close(ctx, want_ctx, dt)
            _assert_bwd_close(dqkv, want_dqkv, dt)
        else:
            _assert_core_close(T.attn_core(qkv, S, 2), T.attn_core_reference(qkv, S, 2), dt)


# ---------------------------------------------------------------------------
# K2: the sublayer backward (ops/attention_bwd.py), at the ViT-B/32 shapes
# ---------------------------------------------------------------------------

# (B, S, W, heads, causal, s_valid): vision, text, text with pad columns
SUBLAYERS = [(32, 50, 768, 12, False, None), (32, 77, 512, 8, True, None),
             (32, 77, 512, 8, True, 70)]
# the same towers at the tuner's batch of 128 (dW sums 6,400 and 9,856 rows)
SUBLAYERS_B128 = [(128, 50, 768, 12, False, None), (128, 77, 512, 8, True, None)]


def _assert_sum_close(got, want, dtype):
    """The module's bars for a leaf whose elements each sum B*S token rows (weight,
    bias and LN grads): the absolute tolerance is scaled by the leaf's RMS.
    Such a sum is tens of times larger than its terms, and in bf16 it adds
    up the rounding differences of every term's intermediate casts, so a
    unit-scale atol would hold it to a tighter bar than a per-row output."""
    got, want = got.float(), want.float()
    scale = want.square().mean().sqrt().item()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4 * scale, rtol=1e-4)
    else:
        cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).min().item()
        assert cos >= 0.999, cos
        torch.testing.assert_close(got, want, atol=3e-2 * scale, rtol=1e-2)


def _assert_leaf(name, got, want, dtype):
    """The module's bars on one grad leaf (per-row cosine along its last axis);
    the summed leaves are held as ``_assert_sum_close`` says."""
    try:
        if name == "dx":
            _assert_close(got, want, dtype)
        else:
            _assert_sum_close(got, want, dtype)
    except AssertionError as e:
        raise AssertionError(f"{name}: {e}") from None


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("M,K,N", [(37, 40, 24), (1600, 768, 768), (1600, 2304, 768),
                                   (2464, 512, 512), (2464, 1536, 512)])
def test_grad_gemm_nt(dev, dtype, out_f32, M, K, N):
    a = _randn(M, K, dev=dev).to(dtype)
    b = _randn(N, K, dev=dev, std=K ** -0.5, seed=1).to(dtype)
    out_dtype = torch.float32 if out_f32 else dtype
    TB.reset_launch_counts()
    got = TB.grad_gemm_nt(a, b, out_dtype)
    assert TB.LAUNCHES["grad_gemm"] == 1 and got.dtype == out_dtype
    _assert_close(got, TB.grad_gemm_nt_reference(a, b, out_dtype), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K,M,N", [(37, 40, 24), (1600, 768, 768), (1600, 768, 2304),
                                   (2464, 512, 1536), (6400, 768, 2304),
                                   (9856, 512, 1536)])
def test_grad_gemm_tn(dev, dtype, K, M, N):
    """dW = a^T . b over K token rows, in the slices of tn_slices (fp32:
    f32_slice_rows); in fp32 its error against a float64 product is at most
    twice the plain fp32 product's (plus 1e-6 of the leaf's scale)."""
    a = _randn(K, M, dev=dev).to(dtype)
    b = _randn(K, N, dev=dev, seed=1).to(dtype)
    TB.reset_launch_counts()
    got = TB.grad_gemm_tn(a, b)
    slices = len(TB.tn_slices(M, N, K, dtype, TB._sm_count(dev)))
    assert TB.LAUNCHES == {"grad_gemm": 1, "attn_core_bwd": 0, "ln_bwd_rows": 0,
                           "col_sum": int(slices > 1), "attention_sublayer_bwd": 0,
                           "attention_sublayer_bwd_split": 0}
    want = TB.grad_gemm_tn_reference(a, b)
    _assert_sum_close(got, want, dtype)
    if dtype == torch.float32:
        exact = a.double().t() @ b.double()
        scale = exact.square().mean().sqrt().item()
        err = (got - exact).abs().max().item()
        assert err <= 2 * (want - exact).abs().max().item() + 1e-6 * scale, err


# bf16 grad_gemm on wgmma at ragged shapes: 128 x 128 tiles cut by M and N of
# 512, 768, 2304 and 3072; K (token rows) of 616 (8 prompts), 1000, 1600,
# 4928, 16448 (ViT-L/14 vision, batch 64), and shorter than one 64-deep step
RAGGED = [(512, 768, 616), (768, 2304, 1000), (2304, 768, 1600), (3072, 512, 4928),
          (768, 3072, 16448), (1024, 3072, 16448), (512, 512, 40), (2304, 3072, 8)]


@pytest.mark.parametrize("M,N,K", RAGGED)
@pytest.mark.parametrize("product", ["NT bf16", "NT fp32", "TN"])
def test_grad_gemm_bf16_ragged(dev, product, M, N, K):
    """Both layouts at ragged M, N and K against the plain versions: NT
    [M, K] . [N, K]^T in bf16 or fp32, TN [K, M]^T . [K, N] in fp32 over the
    slices tn_slices plans (added by col_sum)."""
    TB.reset_launch_counts()
    if product == "TN":
        a = _randn(K, M, dev=dev).bfloat16()
        b = _randn(K, N, dev=dev, seed=1).bfloat16()
        got = TB.grad_gemm_tn(a, b)
        assert got.dtype == torch.float32 and got.shape == (M, N)
        slices = len(TB.tn_slices(M, N, K, torch.bfloat16, TB._sm_count(dev)))
        assert TB.LAUNCHES["col_sum"] == int(slices > 1)
        _assert_sum_close(got, TB.grad_gemm_tn_reference(a, b), torch.bfloat16)
    else:
        out_dtype = torch.float32 if product == "NT fp32" else torch.bfloat16
        a = _randn(M, K, dev=dev).bfloat16()
        b = _randn(N, K, dev=dev, std=K ** -0.5, seed=1).bfloat16()
        got = TB.grad_gemm_nt(a, b, out_dtype)
        assert got.dtype == out_dtype and got.shape == (M, N)
        _assert_close(got, TB.grad_gemm_nt_reference(a, b, out_dtype), torch.bfloat16)
    assert TB.LAUNCHES["grad_gemm"] == 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,heads,D,causal,s_valid", [
    (2, 1, 2, 16, False, None),
    (3, 33, 4, 32, True, 30),
    (32, 50, 12, 64, False, None),
    (32, 77, 8, 64, True, None),
    (32, 77, 8, 64, True, 70),
    (4, 128, 2, 64, True, 100),
    (3, 129, 4, 64, True, 100),  # the first key-tiled length (csrc/mha_bwd.cu)
    (32, 197, 12, 64, False, None),  # ViT-B/16 vision
    (8, 257, 16, 64, False, None),  # ViT-L/14 vision (the hybrid's backward)
    (2, 513, 2, 64, True, 500),
    (4, 577, 16, 64, False, None),  # ViT-L/14@336px vision
    (2, 1000, 2, 64, False, 990),
    (3, 64, 4, 64, False, 60),
    (3, 65, 4, 64, True, None),
    (5, 197, 12, 64, False, 190),
    (3, 257, 16, 64, True, 250),
    (3, 577, 4, 64, False, 570),
    (1, 1056, 4, 64, False, None),
    (3, 1056, 2, 64, True, 1049),
])
def test_attn_core_bwd(dev, dtype, B, S, heads, D, causal, s_valid):
    """fp32 at any head_dim up to 128 tokens and bf16 at head_dim != 64 there
    (the CUDA-core kernel); bf16 at head_dim 64 on wgmma up to 128 tokens;
    key-tiled past them (head_dim 64). bf16 is held to the backward bars at
    every S."""
    qkv = _randn(B * S, 3 * heads * D, dev=dev).to(dtype)
    dctx = _randn(B * S, heads * D, dev=dev, seed=1).to(dtype)
    TB.reset_launch_counts()
    ctx, dqkv = TB.attn_core_bwd(qkv, dctx, S, heads, causal, s_valid)
    assert TB.LAUNCHES["attn_core_bwd"] == 1
    want_ctx, want_dqkv = TB.attn_core_bwd_reference(qkv, dctx, S, heads, causal, s_valid)
    if S > T.BWD_ROW_MAX_SEQ or dtype == torch.bfloat16:  # the cores' bf16 bars
        _assert_core_close(ctx, want_ctx, dtype)
        _assert_bwd_close(dqkv, want_dqkv, dtype)
    else:
        _assert_close(ctx, want_ctx, dtype)
        _assert_close(dqkv, want_dqkv, dtype)


@pytest.mark.parametrize("B,S,heads,causal,s_valid", [
    (3, 1, 2, False, None),
    (5, 50, 12, False, None),  # ViT-B/32 vision
    (33, 50, 12, False, None),
    (3, 64, 4, False, None),
    (3, 65, 4, True, None),
    (7, 77, 8, True, None),  # the text tower
    (7, 77, 8, True, 70),
    (5, 77, 12, True, None),  # ViT-L/14's text tower
    (3, 100, 2, False, 30),  # a key tile wholly past s_valid
    (3, 128, 2, True, 100),
    (5, 128, 4, False, None),
])
def test_attn_core_bwd_one_block_bf16(dev, B, S, heads, causal, s_valid):
    """bf16 at S <= 128: the one-block wgmma kernel, one launch, ctx within
    one ulp and dqkv within the backward bar of the plain version, every
    value finite, and a rerun bit-equal."""
    qkv = _randn(B * S, 3 * heads * D, dev=dev).bfloat16()
    dctx = _randn(B * S, heads * D, dev=dev, seed=1).bfloat16()
    TB.reset_launch_counts()
    ctx, dqkv = TB.attn_core_bwd(qkv, dctx, S, heads, causal, s_valid)
    assert TB.LAUNCHES["attn_core_bwd"] == 1
    assert torch.isfinite(ctx.float()).all() and torch.isfinite(dqkv.float()).all()
    want_ctx, want_dqkv = TB.attn_core_bwd_reference(qkv, dctx, S, heads, causal, s_valid)
    _assert_core_close(ctx, want_ctx, torch.bfloat16)
    _assert_bwd_close(dqkv, want_dqkv, torch.bfloat16)
    again = TB.attn_core_bwd(qkv, dctx, S, heads, causal, s_valid)
    assert torch.equal(again[0], ctx) and torch.equal(again[1], dqkv)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,width", [(1, 32), (37, 768), (1600, 768), (2464, 512)])
def test_ln_bwd_rows(dev, dtype, rows, width):
    x = _randn(rows, width, dev=dev).to(dtype)
    dln = _randn(rows, width, dev=dev, seed=1)
    g = _randn(rows, width, dev=dev, seed=2).to(dtype)
    s = 1 + _randn(width, dev=dev, std=0.1, seed=3)
    TB.reset_launch_counts()
    dx, partial = TB.ln_bwd_rows(x, dln, g, s)
    assert TB.LAUNCHES["ln_bwd_rows"] == 1
    want_dx, want_partial = TB.ln_bwd_rows_reference(x, dln, g, s)
    _assert_close(dx, want_dx, dtype)
    _assert_sum_close(partial, want_partial, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,cols,offset", [
    (1, 5, 0), (1600, 2304, 0), (9856, 512, 0), (3, 1769472, 0),
    # ragged widths and row counts (narrower loads, a partial strip)
    (9, 5, 0), (1601, 2308, 0), (2056, 2050, 0), (6400, 768, 0), (16448, 1024, 0),
    (8, 24, 0), (2, 3 * 2 ** 20 + 4, 0),
    # a view whose base is not 16-byte aligned
    (1600, 2304, 1), (37, 768, 3), (2056, 2048, 2)])
def test_col_sum(dev, dtype, rows, cols, offset):
    """One launch, the fp32 bars of a summed leaf, and the same bits on a
    rerun (the row splits are added in a fixed order: no atomics)."""
    t = _randn(rows * cols + offset, dev=dev).to(dtype)[offset:].view(rows, cols)
    TB.reset_launch_counts()
    got = TB.col_sum(t)
    assert TB.LAUNCHES["col_sum"] == 1 and got.dtype == torch.float32
    _assert_sum_close(got, TB.col_sum_reference(t), torch.float32)
    assert torch.equal(got, TB.col_sum(t)) and TB.LAUNCHES["col_sum"] == 2


def test_col_sum_raises_on_what_the_kernel_does_not_take(dev):
    TB.reset_launch_counts()
    with pytest.raises(ValueError, match="contiguous"):
        TB.col_sum(torch.zeros(64, 20, device=dev).t())
    with pytest.raises(ValueError, match="dtype"):
        TB.col_sum(torch.zeros(64, 20, device=dev).half())
    assert TB.LAUNCHES["col_sum"] == 0


def _sublayer_case(B, S, W, dev, dtype):
    x = _randn(B * S, W, dev=dev).to(dtype)
    g = _randn(B * S, W, dev=dev, seed=7).to(dtype)
    ln = {"scale": 1 + _randn(W, dev=dev, std=0.1, seed=1),
          "bias": _randn(W, dev=dev, std=0.05, seed=2)}
    attn = {"qkv": {"kernel": _randn(W, 3 * W, dev=dev, std=W ** -0.5, seed=3),
                    "bias": _randn(3 * W, dev=dev, std=0.02, seed=4)},
            "out": {"kernel": _randn(W, W, dev=dev, std=W ** -0.5, seed=5),
                    "bias": _randn(W, dev=dev, std=0.02, seed=6)}}
    return x, g, ln, attn


def _bwd_leaves(dx, dln, dattn):
    return {"dx": dx, "ln.scale": dln["scale"], "ln.bias": dln["bias"],
            "qkv.kernel": dattn["qkv"]["kernel"], "qkv.bias": dattn["qkv"]["bias"],
            "out.kernel": dattn["out"]["kernel"], "out.bias": dattn["out"]["bias"]}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,W,heads,causal,s_valid", SUBLAYERS + SUBLAYERS_B128)
def test_attention_sublayer_bwd(dev, dtype, B, S, W, heads, causal, s_valid):
    """The whole backward, kernels against the plain versions, leaf by leaf."""
    x, g, ln, attn = _sublayer_case(B, S, W, dev, dtype)
    T.reset_launch_counts()
    TB.reset_launch_counts()
    got = _bwd_leaves(*TB.attention_sublayer_bwd(x, g, ln, attn, S, heads, causal,
                                                 s_valid))
    assert T.LAUNCHES == {"ln_rows": 1, "gemm_bias_residual": 1, "attn_core": 0}
    assert TB.LAUNCHES["attn_core_bwd"] == 1 and TB.LAUNCHES["ln_bwd_rows"] == 1
    assert TB.LAUNCHES["grad_gemm"] == 4
    want = _bwd_leaves(*TB.attention_sublayer_bwd_reference(x, g, ln, attn, S, heads,
                                                             causal, s_valid))
    for k in want:
        assert got[k].dtype == (dtype if k == "dx" else torch.float32), k
        _assert_leaf(k, got[k], want[k], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_autograd_function_on_the_card(dev, dtype):
    """loss.backward() through attention_sublayer launches K1 forward and K2
    backward, and its grads match the plain backward's."""
    B, S, W, heads, causal, s_valid = SUBLAYERS[2]
    x, g, ln, attn = _sublayer_case(B, S, W, dev, dtype)
    leaves = [x.requires_grad_(), ln["scale"], ln["bias"], attn["qkv"]["kernel"],
              attn["qkv"]["bias"], attn["out"]["kernel"], attn["out"]["bias"]]
    for t in leaves[1:]:
        t.requires_grad_()
    T.reset_launch_counts()
    TB.reset_launch_counts()
    out = T.attention_sublayer(x, ln, attn, heads, causal, s_valid, S=S)
    out.backward(g)
    assert T.LAUNCHES["attn_core"] == 1 and TB.LAUNCHES["attn_core_bwd"] == 1
    want = _bwd_leaves(*TB.attention_sublayer_bwd_reference(
        x.detach(), g, ln, attn, S, heads, causal, s_valid))
    for name, t in zip(want, leaves):
        _assert_leaf(name, t.grad, want[name], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_clip_backward_on_the_card(dev, dtype):
    """The repair: loss.backward() through CLIP on the card gives every
    parameter a grad, and each matches the plain path's (autograd through
    the plain sublayer): leaf cosine >= 0.9999 in fp32, >= 0.995 in bf16."""
    from plip_tpu_torch.models import clip as tclip
    from plip_tpu_torch.models import config as tconfig
    from plip_tpu_torch.models import layers as tlayers
    from plip_tpu_torch.train.contrastive import clip_loss

    cfg = tconfig.CLIPConfig(vision=tconfig.VisionConfig(width=768, layers=2, heads=12),
                             text=tconfig.TextConfig(width=512, layers=2, heads=8))
    model = tclip.CLIP(cfg).init_params(torch.Generator().manual_seed(0)).to(dev)
    g = torch.Generator().manual_seed(1)
    px = torch.randn(8, 224, 224, 3, generator=g).to(dev)
    ids = torch.randint(1, cfg.text.vocab_size - 1, (8, 77), generator=g)
    ids[:, 20] = cfg.text.eot
    ids = ids.to(dev)

    def grads():
        model.zero_grad(set_to_none=True)
        loss, _ = clip_loss(model, px, ids, dtype, "mlp")
        loss.backward()
        return loss.item(), {k: p.grad for k, p in model.named_parameters()}

    TB.reset_launch_counts()
    loss, got = grads()
    assert set(TB.LAUNCHES.values()) != {0}
    with mock.patch.object(tlayers, "attention_sublayer", T.attention_sublayer_reference), \
            _plain_layer_norm():
        loss_ref, want = grads()
    assert loss == pytest.approx(loss_ref, rel=1e-5 if dtype == torch.float32 else 1e-2)
    bar = 0.9999 if dtype == torch.float32 else 0.995
    for k, w in want.items():
        assert got[k] is not None, k
        cos = torch.nn.functional.cosine_similarity(got[k].flatten(), w.flatten(), 0)
        assert cos.item() >= bar, (k, cos.item())


def test_k2_takes_what_k1_takes(dev):
    """K2's backward takes the sequences and head widths K1's forward takes
    (ViT-B/16's S=197 here, through the key-tiled core; head_dim 16 past 128
    tokens) and raises before launching anything past them."""
    S, W, heads = 197, 128, 2
    x = torch.randn(2 * S, W, device=dev)
    ln = {"scale": torch.ones(W, device=dev), "bias": torch.zeros(W, device=dev)}
    attn = {"qkv": {"kernel": torch.randn(W, 3 * W, device=dev) * W ** -0.5,
                    "bias": torch.zeros(3 * W, device=dev)},
            "out": {"kernel": torch.randn(W, W, device=dev) * W ** -0.5,
                    "bias": torch.zeros(W, device=dev)}}
    T.reset_launch_counts()
    TB.reset_launch_counts()
    got = _bwd_leaves(*TB.attention_sublayer_bwd(x, x, ln, attn, S, heads))
    assert TB.LAUNCHES["attn_core_bwd"] == 1
    want = _bwd_leaves(*TB.attention_sublayer_bwd_reference(x, x, ln, attn, S, heads))
    for k in want:
        _assert_leaf(k, got[k], want[k], torch.float32)
    T.reset_launch_counts()
    TB.reset_launch_counts()
    with pytest.raises(ValueError, match="S <= 1056"):
        TB.attention_sublayer_bwd(torch.zeros(2 * 1057, W, device=dev),
                                  torch.zeros(2 * 1057, W, device=dev), ln, attn, 1057, heads)
    assert set(T.LAUNCHES.values()) == {0} and set(TB.LAUNCHES.values()) == {0}
    # head_dim 136, which raised before: the key-tiled kernels, two 128-column chunks
    qkv, g = _randn(258, 816, dev=dev), _randn(258, 272, dev=dev, seed=1)
    got, want = TB.attn_core_bwd(qkv, g, 129, 2), TB.attn_core_bwd_reference(qkv, g, 129, 2)
    assert TB.LAUNCHES["attn_core_bwd"] == 1
    for a, b in zip(got, want):
        _assert_close(a, b, torch.float32)
    TB.reset_launch_counts()
    # head_dim 16 past 128 tokens, which raised before: the key-tiled kernels on CUDA cores
    qkv, g = _randn(258, 96, dev=dev), _randn(258, 32, dev=dev, seed=1)
    got, want = TB.attn_core_bwd(qkv, g, 129, 2), TB.attn_core_bwd_reference(qkv, g, 129, 2)
    assert TB.LAUNCHES["attn_core_bwd"] == 1
    for a, b in zip(got, want):
        _assert_close(a, b, torch.float32)


# ---------------------------------------------------------------------------
# K3 and K5: the composed towers' attention core (ops/mha.py)
# ---------------------------------------------------------------------------


D = M.HEAD_DIM  # the one head width the K3/K5 kernel is built for


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,heads,causal,s_valid", [
    (2, 1, 2, False, None),
    (2, 16, 2, True, 11),  # normalize-first
    (2, 128, 2, True, None),
    (3, 129, 4, True, 100),  # the first deferred-divide length
    (64, 257, 16, False, None),  # ViT-L/14 vision
    (4, 257, 16, True, 250),
    (2, 512, 4, False, 500),
    (3, 50, 12, False, None),
    (3, 64, 4, False, 60),
    (3, 65, 4, False, None),
    (5, 77, 8, True, None),
    (5, 77, 8, True, 70),
    (3, 197, 12, False, 190),
    (3, 257, 16, False, 251),
])
def test_mha_core(dev, dtype, B, S, heads, causal, s_valid):
    qkv = _randn(B, S, 3 * heads * D, dev=dev).to(dtype)
    M.reset_launch_counts()
    got = M.mha_core(qkv, S, heads, causal, s_valid)
    assert M.LAUNCHES == {"mha_core": 1, "flash_core": 0, "mha_core_bwd": 0,
                          "headgrid_core": 0}
    assert got.shape == (B, S, heads * D)
    want = M.mha_core_reference(qkv, S, heads, causal, s_valid)
    _assert_core_close(got.reshape(B * S, -1), want.reshape(B * S, -1), dtype)
    flat = M.mha_core(qkv.reshape(B * S, -1), S, heads, causal, s_valid)
    assert torch.equal(flat, got.reshape(B * S, -1))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,heads,causal", [
    (32, 577, 16, False),  # ViT-L/14@336px vision
    (2, 513, 4, True),
    (2, 577, 2, True),
    (2, 1000, 3, False),
    (2, 200, 2, True),
    (3, 50, 12, False),
    (3, 64, 4, False),
    (3, 65, 4, True),
    (5, 77, 8, True),
    (3, 197, 12, False),
    (3, 257, 16, False),
    (1, 1056, 4, False),
    (3, 1056, 2, True),
])
def test_flash_core(dev, dtype, B, S, heads, causal):
    qkv = _randn(B, S, 3 * heads * D, dev=dev).to(dtype)
    M.reset_launch_counts()
    got = M.flash_core(qkv, S, heads, causal)
    assert M.LAUNCHES == {"mha_core": 0, "flash_core": 1, "mha_core_bwd": 0,
                          "headgrid_core": 0}
    want = M.flash_core_reference(qkv, S, heads, causal)
    _assert_core_close(got.reshape(B * S, -1), want.reshape(B * S, -1), dtype)


_SOFTMAX_PV = T.softmax_pv_reference


def _swapped(logits, v, dt, defer):  # normalize-first, P cast after the divide
    return _SOFTMAX_PV(logits, v, dt, not defer)


def _cast_sum(logits, v, dt, defer):  # the row sum taken of the cast P
    e = torch.exp(logits - logits.amax(-1, keepdim=True)).to(dt).float()
    return (torch.matmul(e, v.float()) / e.sum(-1, keepdim=True)).to(dt)


@pytest.mark.parametrize("fault", [_swapped, _cast_sum])
@pytest.mark.parametrize("core,B,S,heads,causal", [
    ("attn_core", 32, 197, 12, False),  # ViT-B/16 vision
    ("attn_core", 16, 256, 12, True),
    ("mha_core", 8, 257, 16, True),
    ("flash_core", 4, 577, 16, False),  # ViT-L/14@336px vision
])
def test_core_bar_rejects_schedule_faults(dev, fault, core, B, S, heads, causal):
    """Controls of the bf16 core bar, in the deferred-divide schedule: the
    kernel against its plain version with a rounding-schedule fault fails
    it, while it passes against the right plain version."""
    qkv = _randn(B * S, 3 * heads * D, dev=dev).bfloat16()
    if core == "attn_core":
        kernel, plain = T.attn_core, T.attn_core_reference
    else:
        qkv = qkv.view(B, S, -1)
        kernel = getattr(M, core)
        plain = M.mha_core_reference if core == "mha_core" else M.flash_core_reference
    got = kernel(qkv, S, heads, causal).reshape(B * S, -1)
    _assert_core_close(got, plain(qkv, S, heads, causal).reshape(B * S, -1), torch.bfloat16)
    with mock.patch.object(T, "softmax_pv_reference", fault), \
            mock.patch.object(M, "softmax_pv_reference", fault):
        bad = plain(qkv, S, heads, causal).reshape(B * S, -1)
    differ, ulps = _ulp_stats(got, bad)
    assert differ > CORE_DIFFER, (differ, ulps)


# ---------------------------------------------------------------------------
# The key-tiled core backwards: K4 (ops/mha.py) and K2's core past 128
# tokens (ops/attention_bwd.py), csrc/mha_bwd.cu
# ---------------------------------------------------------------------------

# bf16 bar of the key-tiled backwards (dqkv; the recomputed ctx is held to
# the cores' bar): at most BWD_DIFFER of the elements not bit-equal, every
# element within BWD_ULPS bf16 ulps of its row's largest |value|. On the
# H100 the kernels differ in at most 0.13% (0.24% on 2 sequences of 1,000
# tokens), up to 2 ulps at ViT-L/14; the other schedule in 51-54%, also up to
# 2 ulps, so the share is what separates them.
BWD_DIFFER = 0.005
BWD_ULPS = 2


def _assert_bwd_close(got, want, dtype):
    """A key-tiled backward's dqkv (module docstring); rows are tokens."""
    got, want = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    _assert_close(got, want, dtype)
    if dtype == torch.bfloat16:
        differ, ulps = _ulp_stats(got, want)
        assert differ <= BWD_DIFFER and ulps <= BWD_ULPS, (differ, ulps)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,heads,causal,s_valid", [
    (2, 1, 2, False, None),
    (2, 16, 2, True, 11),
    (2, 128, 2, False, None),
    (3, 129, 4, True, 100),
    (64, 257, 16, False, None),  # ViT-L/14 vision (remat=False training)
    (4, 257, 16, True, 250),
    (2, 512, 4, False, 500),
    (3, 50, 12, False, None),
    (3, 64, 4, False, 60),
    (3, 65, 4, True, None),
    (5, 77, 8, True, None),
    (5, 77, 8, True, 70),
    (3, 197, 12, False, 190),
    (3, 257, 16, True, 250),
])
def test_mha_core_bwd(dev, dtype, B, S, heads, causal, s_valid):
    qkv = _randn(B, S, 3 * heads * D, dev=dev).to(dtype)
    g = _randn(B, S, heads * D, dev=dev, seed=1).to(dtype)
    M.reset_launch_counts()
    got = M.mha_core_bwd(qkv, g, S, heads, causal, s_valid)
    assert M.LAUNCHES == {"mha_core": 0, "flash_core": 0, "mha_core_bwd": 1,
                          "headgrid_core": 0}
    assert got.shape == qkv.shape and got.dtype == dtype
    _assert_bwd_close(got, M.mha_core_bwd_reference(qkv, g, S, heads, causal, s_valid), dtype)
    flat = M.mha_core_bwd(qkv.reshape(B * S, -1), g.reshape(B * S, -1), S, heads, causal,
                          s_valid)
    assert torch.equal(flat, got.reshape(B * S, -1))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("core", ["mha_core_bwd", "attn_core_bwd"])
def test_core_bwd_runs_are_bit_equal(dev, dtype, core):
    """No atomics: two runs of a key-tiled backward give the same bits."""
    B, S, heads, causal, s_valid = 4, 577 if core == "attn_core_bwd" else 257, 16, True, None
    qkv = _randn(B * S, 3 * heads * D, dev=dev).to(dtype)
    g = _randn(B * S, heads * D, dev=dev, seed=1).to(dtype)
    fn = M.mha_core_bwd if core == "mha_core_bwd" else TB.attn_core_bwd
    first, second = fn(qkv, g, S, heads, causal, s_valid), fn(qkv, g, S, heads, causal, s_valid)
    for a, b in zip(first if isinstance(first, tuple) else (first,),
                    second if isinstance(second, tuple) else (second,)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("core,B,S,heads,causal,s_valid", [
    ("mha_core_bwd", 8, 257, 16, False, None),  # ViT-L/14 vision
    ("mha_core_bwd", 4, 257, 16, True, 250),
    ("attn_core_bwd", 8, 197, 12, False, None),  # ViT-B/16 vision
    ("attn_core_bwd", 8, 257, 16, False, None),
    ("attn_core_bwd", 4, 577, 16, False, None),  # ViT-L/14@336px vision
    ("attn_core_bwd", 32, 50, 12, False, None),  # the one-block kernel: ViT-B/32
    ("attn_core_bwd", 32, 77, 8, True, None),  # and its text tower
])
def test_bwd_bar_rejects_the_other_schedule(dev, core, B, S, heads, causal, s_valid):
    """Controls of the bf16 backward bar: each kernel passes it against its
    plain version and fails it against the plain version in the other
    schedule (K4 in K2's deferred form; K2's core normalize-first)."""
    qkv = _randn(B * S, 3 * heads * D, dev=dev).bfloat16()
    g = _randn(B * S, heads * D, dev=dev, seed=1).bfloat16()
    args = (S, heads, causal, s_valid)
    if core == "mha_core_bwd":
        got, want = M.mha_core_bwd(qkv, g, *args), M.mha_core_bwd_reference(qkv, g, *args)
        other = TB.attn_core_bwd_reference(qkv, g, *args)[1]
    else:
        got, want = TB.attn_core_bwd(qkv, g, *args)[1], TB.attn_core_bwd_reference(qkv, g, *args)[1]
        other = M.mha_core_bwd_reference(qkv, g, *args)
    _assert_bwd_close(got, want, torch.bfloat16)
    differ, ulps = _ulp_stats(got, other)
    assert differ > BWD_DIFFER or ulps > BWD_ULPS, (differ, ulps)


@pytest.mark.parametrize("core,S", [("mha_core", 300), ("flash_core", 520)])
def test_core_backward_on_the_card(dev, core, S):
    """A backward through K3 launches K4 and gives its plain version's
    dqkv; through K5 it runs the VJP of the JAX package's ``_jnp_mha`` (the
    reference has no flash backward kernel) and launches nothing of ours."""
    qkv = _randn(2, S, 3 * 64, dev=dev).requires_grad_()
    g = _randn(2, S, 64, dev=dev, seed=1)
    M.reset_launch_counts()
    getattr(M, core)(qkv, S, 1).backward(g)
    if core == "mha_core":
        assert M.LAUNCHES == {"mha_core": 1, "flash_core": 0, "mha_core_bwd": 1,
                              "headgrid_core": 0}
        want = M.mha_core_bwd_reference(qkv.detach(), g, S, 1)
    else:
        assert M.LAUNCHES == {"mha_core": 0, "flash_core": 1, "mha_core_bwd": 0,
                              "headgrid_core": 0}
        leaf = qkv.detach().requires_grad_()
        M.jnp_mha_reference(leaf, S, 1).backward(g)
        want = leaf.grad
    _assert_close(qkv.grad, want, torch.float32)


def test_core_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    qkv = torch.zeros(2, 600, 192, device=dev)
    with pytest.raises(ValueError, match="S <= 512"):
        M.mha_core(qkv, 600, 2)
    wide = _randn(2, 600, 816, dev=dev)  # head_dim 136, which raised before: two chunks
    _assert_core_close(M.flash_core(wide, 600, 2), M.flash_core_reference(wide, 600, 2),
                       torch.float32)
    wide = _randn(2, 600, 288, dev=dev)  # head_dim 48, taken on CUDA cores
    _assert_core_close(M.flash_core(wide, 600, 2), M.flash_core_reference(wide, 600, 2),
                       torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        M.flash_core(qkv.half(), 600, 2)
    with pytest.raises(ValueError, match="not \\[B, 601"):
        M.flash_core(qkv, 601, 2)
    with pytest.raises(ValueError, match="contiguous"):
        M.flash_core(qkv.transpose(0, 1), 2, 1)
    shifted = torch.zeros(2 * 600 * 192 + 1, device=dev, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):  # the bf16 kernels' cp.async
        M.flash_core(shifted.view(2, 600, 192), 600, 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch,layers", [("ViT-B/16", 2), ("ViT-L/14", 2),
                                         ("ViT-L/14@336px", 1)])
def test_wide_towers_on_the_card(dev, dtype, arch, layers):
    """The vision towers of the wider architectures, cut to a few layers: the
    kernel path launches the core its shape takes (K1 at S=197, K3 at 257,
    K5 at 577) and matches the same tower run through the plain versions."""
    import dataclasses

    from plip_tpu_torch.models import clip as tclip
    from plip_tpu_torch.models import config as tconfig
    from plip_tpu_torch.models import layers as tlayers

    cfg = tconfig.ARCHITECTURES[arch]()
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, layers=layers))
    model = tclip.CLIP(cfg).init_params(torch.Generator().manual_seed(0)).to(dev)
    n = cfg.vision.image_size
    px = _randn(4, n, n, 3, dev=dev)
    T.reset_launch_counts()
    M.reset_launch_counts()
    with torch.inference_mode():
        got = model.encode_image(px, dtype)
        with mock.patch.multiple(tlayers, attention_sublayer=T.attention_sublayer_reference,
                                 mha_core=M.mha_core_reference,
                                 flash_core=M.flash_core_reference), _plain_layer_norm():
            want = model.encode_image(px, dtype)
    path = tlayers.sublayer_path(cfg.vision.seq_len, cfg.vision.width, False)
    launched = T.LAUNCHES["attn_core"] if path == "attention_sublayer" else M.LAUNCHES[path]
    assert launched == layers, (path, T.LAUNCHES, M.LAUNCHES)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).min().item()
    assert cos >= (0.9999 if dtype == torch.float32 else 0.999), cos


def _plain_versions(*extra):
    """Every kernel wrapper (of ``T``, ``TB``, ``M`` and the modules
    ``extra``) takes its plain version, under the same autograd functions:
    the kernel path's reference."""
    import contextlib

    stack = contextlib.ExitStack()
    for mod in (T, TB, M, *extra):
        stack.enter_context(mock.patch.object(mod, "_on_cpu", lambda t, name: True))
    return stack


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch,remat,kernels", [
    ("ViT-B/16", "mlp", ("attn_core", "attn_core_bwd")),
    ("ViT-L/14", "mlp", ("mha_core", "attn_core_bwd")),  # the hybrid
    ("ViT-L/14", True, ("mha_core", "attn_core_bwd")),
    ("ViT-L/14", False, ("mha_core", "mha_core_bwd")),
    ("ViT-L/14@336px", "mlp", ("attn_core", "attn_core_bwd")),
    ("ViT-L/14@336px", False, ("flash_core",)),
])
def test_wide_train_on_the_card(dev, dtype, arch, remat, kernels):
    """One train step of each wide tower (two layers a tower, batch 4): the
    kernels its path takes are launched, and the loss and every grad leaf
    match the same autograd functions with the plain versions in place (fp32
    loss within 1e-5 relative and leaf cosine >= 0.9999; bf16 leaf cosine
    >= 0.995)."""
    import dataclasses

    from plip_tpu_torch.models import clip as tclip
    from plip_tpu_torch.models import config as tconfig
    from plip_tpu_torch.train.contrastive import clip_loss

    cfg = tconfig.ARCHITECTURES[arch]()
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, layers=2),
                              text=dataclasses.replace(cfg.text, layers=2))
    model = tclip.CLIP(cfg).init_params(torch.Generator().manual_seed(0)).to(dev)
    n = cfg.vision.image_size
    px = _randn(4, n, n, 3, dev=dev)
    ids = torch.randint(1, cfg.text.vocab_size - 1, (4, 77),
                        generator=torch.Generator().manual_seed(1))
    ids[:, 20] = cfg.text.eot
    ids = ids.to(dev)

    def step():
        model.zero_grad(set_to_none=True)
        loss, _ = clip_loss(model, px, ids, dtype, remat)
        loss.backward()
        return loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()}

    for mod in (T, TB, M):
        mod.reset_launch_counts()
    loss, got = step()
    launches = {**T.LAUNCHES, **TB.LAUNCHES, **M.LAUNCHES}
    for k in kernels:
        assert launches[k] > 0, (k, launches)
    with _plain_versions():
        loss_ref, want = step()
    assert {**T.LAUNCHES, **TB.LAUNCHES, **M.LAUNCHES} == launches
    if dtype == torch.float32:
        assert loss == pytest.approx(loss_ref, rel=1e-5)
    bar = 0.9999 if dtype == torch.float32 else 0.995
    for k, w in want.items():
        cos = torch.nn.functional.cosine_similarity(got[k].flatten().double(),
                                                    w.flatten().double(), 0).item()
        assert cos >= bar or (got[k].abs().max() == 0 and w.abs().max() == 0), (k, cos)


# ---------------------------------------------------------------------------
# The MLP half (K8, K9) and the whole-block backward (K7)
# ---------------------------------------------------------------------------

# In bf16 a whole block's backward carries a rounding noise of its own: a
# fp32 sum taken in another order flips a cast somewhere, and the flip
# propagates (kernels and plain versions differ in about a third of K7's dx
# elements, by one or two ulps). A schedule fault adds no more than that
# noise to the outputs, so K7 and K8 are held at their outputs to the bars of
# a summed leaf (dx too: atol scaled by its RMS), and
# at their rounding points, on the inputs the kernel path gave them, to the
# cores' bar: h1 and dh1 to at most CORE_DIFFER of the elements not
# bit-equal and one ulp of the row's largest value, the activation to
# ACT_ULPS (an h1 one ulp apart gives an activation up to two apart: H100
# readings 2 ulps at 0.03-0.27% differing, the bf16 QuickGELU control 29%);
# the core backward to BWD_DIFFER and BWD_ULPS.

from plip_tpu_torch.ops import block_bwd as TBB  # noqa: E402
from plip_tpu_torch.ops import mlp as TMLP  # noqa: E402

ACT_ULPS = 2


def _gelu_case(M, K, N, dev, dtype):
    a = _randn(M, K, dev=dev).to(dtype)
    w = _randn(K, N, dev=dev, std=K ** -0.5, seed=1).to(dtype)
    return a, w, _randn(N, dev=dev, std=0.1, seed=2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N", [(37, 40, 24), (1600, 768, 3072), (6400, 768, 3072),
                                   (9856, 512, 2048), (1576, 768, 3072)])
def test_gemm_bias_gelu(dev, dtype, M, K, N):
    a, w, bias = _gelu_case(M, K, N, dev, dtype)
    TMLP.reset_launch_counts()
    h1, act = TMLP.gemm_bias_gelu(a, w, bias)
    assert TMLP.LAUNCHES["gemm_bias_gelu"] == 1
    want_h1, want_act = TMLP.gemm_bias_gelu_reference(a, w, bias)
    _assert_core_close(h1, want_h1, dtype)
    _assert_core_close(act, want_act, dtype, ACT_ULPS)
    none, act2 = TMLP.gemm_bias_gelu(a, w, bias, keep_h=False)
    assert none is None and torch.equal(act2, act)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N", [(37, 40, 24), (1600, 768, 3072), (6400, 768, 3072),
                                   (9856, 512, 2048), (1576, 768, 3072)])
def test_gemm_nt_gelu_bwd(dev, dtype, M, K, N):
    g = _randn(M, K, dev=dev).to(dtype)
    w = _randn(N, K, dev=dev, std=N ** -0.5, seed=1).to(dtype)
    h = _randn(M, N, dev=dev, std=2.0, seed=2).to(dtype)
    TMLP.reset_launch_counts()
    got = TMLP.gemm_nt_gelu_bwd(g, w, h)
    assert TMLP.LAUNCHES["gemm_nt_gelu_bwd"] == 1
    _assert_core_close(got, TMLP.gemm_nt_gelu_bwd_reference(g, w, h), dtype)


def test_gelu_bar_rejects_the_bf16_quick_gelu(dev):
    """Control: the composed forward's bf16 QuickGELU on the same h1 fails
    the activation's bar."""
    a, w, bias = _gelu_case(1600, 768, 3072, dev, torch.bfloat16)
    h1, act = TMLP.gemm_bias_gelu(a, w, bias)
    differ, ulps = _ulp_stats(act, TMLP.quick_gelu(h1))
    assert differ > CORE_DIFFER, (differ, ulps)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,heads,causal", [(32, 50, 12, False), (32, 77, 8, True),
                                              (8, 197, 12, False), (2, 300, 4, True),
                                              (3, 64, 4, False), (3, 65, 4, True),
                                              (5, 257, 16, False), (3, 577, 4, False),
                                              (1, 1056, 4, True)])
def test_attn_core_normalize_first(dev, dtype, B, S, heads, causal):
    """K7's recomputed context: normalize-first at every S, the logits scaled
    after the dot; the deferred form fails its bar past 128 tokens."""
    qkv = _randn(B * S, 3 * heads * 64, dev=dev).to(dtype)
    T.reset_launch_counts()
    got = T.attn_core(qkv, S, heads, causal, None, False)
    assert T.LAUNCHES["attn_core"] == 1
    _assert_core_close(got, T.attn_core_reference(qkv, S, heads, causal, None, False), dtype)
    if dtype == torch.bfloat16 and S > T.DEFER_ABOVE:
        differ, ulps = _ulp_stats(got, T.attn_core_reference(qkv, S, heads, causal, None, True))
        assert differ > CORE_DIFFER or ulps > 1, (differ, ulps)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,heads,causal,s_valid", [(3, 50, 12, False, 45), (5, 77, 8, True, 70),
                                                      (3, 197, 12, False, 190),
                                                      (3, 257, 4, True, 250),
                                                      (3, 577, 4, False, 570)])
def test_attn_core_normalize_first_pad_columns(dev, dtype, B, S, heads, causal, s_valid):
    """K7's recomputed context with pad columns (s_valid < S)."""
    qkv = _randn(B * S, 3 * heads * 64, dev=dev).to(dtype)
    T.reset_launch_counts()
    got = T.attn_core(qkv, S, heads, causal, s_valid, False)
    assert T.LAUNCHES["attn_core"] == 1
    _assert_core_close(got, T.attn_core_reference(qkv, S, heads, causal, s_valid, False), dtype)


# the kernels whose bf16 instantiations run on wgmma, and how many there are:
# the key-tiled cores (K1/K3/K5/K12 scale placements; K2/K4 schedules), K1's
# one-block core (1-2 key tiles), grad_gemm (NT and TN, fp32 or bf16 out),
# the epilogue GEMMs (gemm_bias_residual, gemm_bias_gelu, gemm_bias_gelu_f32,
# gemm_nt_gelu_bwd) and K2's one-block core backward (1-2 tiles)
WGMMA_KERNELS = {"mha_kernel": 2, "core_bwd_rows": 2, "core_bwd_keys": 2,
                 "attn_core_wgmma": 2, "grad_gemm_wgmma": 4, "epilogue_gemm_wgmma": 4,
                 "attn_core_bwd_wgmma": 2}


def test_bf16_cores_issue_wgmma(dev):
    """The bf16 instantiations of the attention cores (csrc/mha.cu's
    mha_kernel, csrc/mha_bwd.cu's core_bwd_rows and core_bwd_keys,
    csrc/attention_sublayer.cu's attn_core_wgmma_kernel,
    csrc/attention_sublayer_bwd.cu's attn_core_bwd_wgmma_kernel), of
    grad_gemm (csrc/attention_sublayer_bwd.cu's grad_gemm_wgmma_kernel) and
    of the epilogue GEMMs (csrc/gemm.cuh's epilogue_gemm_wgmma_kernel) run on
    wgmma: their SASS in the built library holds HGMMA instructions. fp32,
    and the key-tiled cores' bf16 at another head_dim (tiled_fwd_kernel,
    tiled_bwd_rows_kernel, tiled_bwd_keys_kernel), run on CUDA cores (full
    fp32, no TF32)."""
    from plip_tpu_torch.ops import _build

    counts = _build.sass_counts("HGMMA")
    for kernel, n in WGMMA_KERNELS.items():
        bf16 = {k: c for k, c in counts.items() if kernel in k and "nv_bfloat16" in k}
        fp32 = {k: c for k, c in counts.items() if kernel in k and "nv_bfloat16" not in k}
        assert len(bf16) == n and all(c > 0 for c in bf16.values()), (kernel, bf16)
        assert not any(fp32.values()), (kernel, fp32)
    # fp32, and bf16 at another head_dim, run the key-tiled cores on CUDA cores
    for kernel in ("tiled_fwd_kernel", "tiled_bwd_rows_kernel", "tiled_bwd_keys_kernel"):
        for bf in (False, True):
            mine = {k: c for k, c in counts.items() if kernel in k and ("nv_bfloat16" in k) == bf}
            assert mine and not any(mine.values()), (kernel, mine)


def _block_params(W, dev, seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, std=1.0, mean=0.0):
        return (mean + torch.randn(*shape, generator=g) * std).to(dev)

    return {"ln1": {"scale": r(W, std=0.1, mean=1.0), "bias": r(W, std=0.05)},
            "attn": {"qkv": {"kernel": r(W, 3 * W, std=W ** -0.5), "bias": r(3 * W, std=0.02)},
                     "out": {"kernel": r(W, W, std=W ** -0.5), "bias": r(W, std=0.02)}},
            "ln2": {"scale": r(W, std=0.1, mean=1.0), "bias": r(W, std=0.05)},
            "mlp": {"fc1": {"kernel": r(W, 4 * W, std=W ** -0.5), "bias": r(4 * W, std=0.02)},
                    "fc2": {"kernel": r(4 * W, W, std=(4 * W) ** -0.5),
                            "bias": r(W, std=0.02)}}}


def _flat_leaves(dx, dp):
    out = {"dx": dx}

    def walk(t, pre):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{pre}{k}.")
            else:
                out[pre + k] = v

    walk(dp, "")
    return out


class _Spy:
    """Records the inputs and outputs of the kernel chain's activation,
    activation VJP, core and core backward (``ops.mlp.KERNEL_FNS``,
    ``ops.block_bwd._ATTN_KERNELS``) while it is entered."""

    def __init__(self):
        self.seen = {}
        fns, attn = list(TMLP.KERNEL_FNS), list(TBB._ATTN_KERNELS)
        for tup, i, name in ((fns, 1, "gelu"), (fns, 2, "gelu_bwd"), (attn, 2, "core"),
                             (attn, 3, "core_bwd")):
            tup[i] = self._wrap(name, tup[i])
        self.patches = [mock.patch.object(TMLP, "KERNEL_FNS", tuple(fns)),
                        mock.patch.object(TBB, "KERNEL_FNS", tuple(fns)),
                        mock.patch.object(TBB, "_ATTN_KERNELS", tuple(attn))]

    def _wrap(self, name, fn):
        def spy(*args):
            out = fn(*args)
            self.seen[name] = (args, out)
            return out
        return spy

    def __enter__(self):
        for p in self.patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self.patches:
            p.stop()


def _assert_rounding_points(seen, dtype, gelu=TMLP.gemm_bias_gelu_reference,
                            core_bwd=M.mha_core_bwd_reference):
    """Each recorded kernel output against its plain version on the same
    inputs (the bars above)."""
    args, (h1, act) = seen["gelu"]
    want_h1, want_act = gelu(*args)
    if h1 is not None:  # K9 keeps no h1
        _assert_core_close(h1, want_h1, dtype)
    _assert_core_close(act, want_act, dtype, ACT_ULPS)
    args, dh1 = seen["gelu_bwd"]
    _assert_core_close(dh1, TMLP.gemm_nt_gelu_bwd_reference(*args), dtype)
    if "core_bwd" in seen:
        args, dqkv = seen["core_bwd"]
        want = core_bwd(*args)
        _assert_close(dqkv, want, dtype)
        if dtype == torch.bfloat16:
            differ, ulps = _ulp_stats(dqkv, want)
            assert differ <= BWD_DIFFER and ulps <= BWD_ULPS, (differ, ulps)


# (B, S, W, heads, causal): ViT-B/32 vision and text at the tuner's batch,
# ViT-B/16 vision at batch 8 (N = 1576 rows: bf16 needs only the widths to
# be multiples of 8), a short odd sequence
BLOCKS = [(128, 50, 768, 12, False), (128, 77, 512, 8, True), (8, 197, 768, 12, False),
          (3, 13, 128, 2, True)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,W,heads,causal", BLOCKS)
def test_block_bwd(dev, dtype, B, S, W, heads, causal):
    p = _block_params(W, dev)
    x = _randn(B * S, W, dev=dev, seed=5).to(dtype)
    g = _randn(B * S, W, dev=dev, seed=6).to(dtype)
    for mod in (T, TB, M, TMLP, TBB):
        mod.reset_launch_counts()
    with _Spy() as spy:
        got = _flat_leaves(*TBB.block_bwd(x, g, p, S, heads, causal))
    assert TBB.LAUNCHES["block_bwd"] == 1 and M.LAUNCHES["mha_core_bwd"] == 1
    assert TMLP.LAUNCHES["gemm_bias_gelu"] == 1 and TMLP.LAUNCHES["gemm_nt_gelu_bwd"] == 1
    assert T.LAUNCHES["attn_core"] == 1 and TMLP.LAUNCHES["mlp_bwd"] == 0
    want = _flat_leaves(*TBB.block_bwd_reference(x, g, p, S, heads, causal))
    for k in want:
        assert got[k].dtype == (dtype if k == "dx" else torch.float32), k
        _assert_sum_close(got[k], want[k], dtype)  # dx too: the chain's noise (above)
    _assert_rounding_points(spy.seen, dtype)


def test_b16_block_recompute_takes_the_key_tiled_core(dev):
    """K7 at ViT-B/16 vision (S=197) recomputes the normalize-first context:
    in bf16 through the key-tiled wgmma kernel (faster there than holding
    the head on chip), never the one-block core."""
    B, S, W, heads, causal = BLOCKS[2]
    p = _block_params(W, dev)
    x = _randn(B * S, W, dev=dev, seed=5).bfloat16()
    g = _randn(B * S, W, dev=dev, seed=6).bfloat16()
    spy, patch = _spy_lib(T)
    with patch, _Spy() as seen:
        TBB.block_bwd(x, g, p, S, heads, causal)
    assert spy.calls.get("plip_attn_core_tiled") == 1 and "plip_attn_core" not in spy.calls
    args, ctx = seen.seen["core"]
    assert args[1:] == (S, heads, causal, None, False)
    _assert_core_close(ctx, T.attn_core_reference(*args), torch.bfloat16)


@pytest.mark.parametrize("control", ["deferred core", "bf16 QuickGELU"])
def test_block_bwd_bar_rejects_the_controls(dev, control):
    """K7's rounding points held against a plain version with K2's deferred
    core backward, or the composed forward's bf16 QuickGELU, fail."""
    B, S, W, heads, causal = BLOCKS[0]
    p = _block_params(W, dev)
    x = _randn(B * S, W, dev=dev, seed=5).bfloat16()
    g = _randn(B * S, W, dev=dev, seed=6).bfloat16()
    with _Spy() as spy:
        TBB.block_bwd(x, g, p, S, heads, causal)
    if control == "deferred core":
        kw = {"core_bwd": lambda *a: TB.attn_core_bwd_reference(*a)[1]}
    else:
        kw = {"gelu": lambda a, w, b, keep_h=True: (
            T.gemm_bias_residual_reference(a, w, b),
            TMLP.quick_gelu(T.gemm_bias_residual_reference(a, w, b)))}
    with pytest.raises(AssertionError):
        _assert_rounding_points(spy.seen, torch.bfloat16, **kw)


@pytest.mark.parametrize("dtype", DTYPES)
def test_block_bwd_runs_are_bit_equal(dev, dtype):
    B, S, W, heads, causal = BLOCKS[1]
    p = _block_params(W, dev)
    x = _randn(B * S, W, dev=dev, seed=5).to(dtype)
    g = _randn(B * S, W, dev=dev, seed=6).to(dtype)
    a = _flat_leaves(*TBB.block_bwd(x, g, p, S, heads, causal))
    b = _flat_leaves(*TBB.block_bwd(x, g, p, S, heads, causal))
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N,W", [(6400, 768), (9856, 512), (37, 64)])
def test_mlp_fwd_and_bwd_flat(dev, dtype, N, W):
    p = _block_params(W, dev, seed=1)
    x = _randn(N, W, dev=dev, seed=7).to(dtype)
    g = _randn(N, W, dev=dev, seed=8).to(dtype)
    TMLP.reset_launch_counts()
    with _Spy() as spy:
        out = TMLP.mlp_fwd_flat(x, p["ln2"], p["mlp"])
        dx, dln, dmlp = TMLP.mlp_bwd_flat(x, g, p["ln2"], p["mlp"])
    assert TMLP.LAUNCHES == {"gemm_bias_gelu": 2, "gemm_nt_gelu_bwd": 1, "mlp_fwd": 1,
                             "mlp_bwd": 1, "gemm_bias_gelu_f32": 0}
    _assert_close(out, TMLP.mlp_fwd_reference(x, p["ln2"], p["mlp"]), dtype)
    got = _flat_leaves(dx, {"ln": dln, **dmlp})
    dx, dln, dmlp = TMLP.mlp_bwd_reference(x, g, p["ln2"], p["mlp"])
    want = _flat_leaves(dx, {"ln": dln, **dmlp})
    for k in want:
        _assert_sum_close(got[k], want[k], dtype)
    _assert_rounding_points(spy.seen, dtype)


def test_mlp_sublayer_flat_on_the_card(dev):
    """The autograd function's backward is K8 where the gate passes."""
    p = _block_params(768, dev, seed=2)
    leaves = [t.requires_grad_() for t in (p["ln2"]["scale"], p["mlp"]["fc1"]["kernel"])]
    x = _randn(32 * 50, 768, dev=dev, seed=3).bfloat16().requires_grad_()
    TMLP.reset_launch_counts()
    TMLP.mlp_sublayer_flat(x, p["ln2"], p["mlp"], 50).float().square().sum().backward()
    assert TMLP.LAUNCHES["mlp_bwd"] == 1 and x.grad is not None
    assert all(t.grad is not None for t in leaves)


def test_block_bwd_raises_on_what_the_kernels_do_not_take(dev):
    p = _block_params(128, dev)
    x = _randn(2 * 600, 128, dev=dev).bfloat16()
    TBB.reset_launch_counts()
    T.reset_launch_counts()
    with pytest.raises(ValueError, match="512"):
        TBB.block_bwd(x, x, p, 600, 2)
    with pytest.raises(ValueError, match="head_dim"):  # 3 heads do not divide 128
        TBB.block_bwd(x, x, p, 60, 3)
    assert TBB.LAUNCHES["block_bwd"] == 0 and T.LAUNCHES["ln_rows"] == 0


def test_block_step_matches_mlp_step(dev):
    """remat="block" is the same model as "mlp": one fp32 train step of a
    two-layer ViT-B/32 gives the same loss (1e-5 relative) and grads (leaf
    cosine >= 0.9999); "block" launches K7 once a layer, "mlp" never."""
    import dataclasses

    from plip_tpu_torch.models import clip as tclip
    from plip_tpu_torch.models import config as tconfig
    from plip_tpu_torch.train.contrastive import clip_loss

    cfg = tconfig.CLIPConfig.vit_b32()
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, layers=2),
                              text=dataclasses.replace(cfg.text, layers=2))
    model = tclip.CLIP(cfg).init_params(torch.Generator().manual_seed(0)).to(dev)
    px = _randn(8, 224, 224, 3, dev=dev)
    ids = torch.randint(1, cfg.text.vocab_size - 1, (8, 77),
                        generator=torch.Generator().manual_seed(1))
    ids[:, 20] = cfg.text.eot
    ids = ids.to(dev)
    results = {}
    for remat in ("mlp", "block"):
        TBB.reset_launch_counts()
        model.zero_grad(set_to_none=True)
        loss, _ = clip_loss(model, px, ids, torch.float32, remat)
        loss.backward()
        results[remat] = (loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()},
                          TBB.LAUNCHES["block_bwd"])
    (l0, g0, n0), (l1, g1, n1) = results["mlp"], results["block"]
    assert n0 == 0 and n1 == 4
    assert l1 == pytest.approx(l0, rel=1e-5)
    for k in g0:
        cos = torch.nn.functional.cosine_similarity(g1[k].flatten().double(),
                                                    g0[k].flatten().double(), 0).item()
        assert cos >= 0.9999, (k, cos)


# ---------------------------------------------------------------------------
# Slice 6: K12 (headgrid_core, jnp_mha_core), K10 (ops/block.py and the
# fp32-h1 GEMM), K6 (the split backward, BWD_MODE), K11 (preprocess_fused)
# ---------------------------------------------------------------------------

from plip_tpu_torch.models.config import CLIP_IMAGE_STD  # noqa: E402
from plip_tpu_torch.ops import block as TBK  # noqa: E402
from plip_tpu_torch.ops import preprocess_fused as TPF  # noqa: E402
from plip_tpu_torch.ops.preprocess import preprocess_batch  # noqa: E402


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,heads,causal", [(64, 257, 16, False), (64, 257, 16, True),
                                              (4, 577, 16, False), (3, 33, 2, True),
                                              (3, 50, 12, False), (3, 64, 4, True),
                                              (3, 65, 4, False), (5, 77, 8, True),
                                              (3, 197, 12, False), (1, 1056, 4, False)])
def test_headgrid_core(dev, dtype, B, S, heads, causal):
    """K12 normalize-first at every S; K3's deferred form fails its bf16 bar
    past 128 tokens."""
    qkv = _randn(B, S, 3 * heads * 64, dev=dev).to(dtype)
    M.reset_launch_counts()
    got = M.headgrid_core(qkv, S, heads, causal)
    assert M.LAUNCHES["headgrid_core"] == 1 and got.shape == (B, S, heads * 64)
    want = M.headgrid_core_reference(qkv, S, heads, causal)
    _assert_core_close(got.reshape(B * S, -1), want.reshape(B * S, -1), dtype)
    if dtype == torch.bfloat16 and S > T.DEFER_ABOVE:
        bad = M.flash_core_reference(qkv, S, heads, causal)
        differ, ulps = _ulp_stats(got.reshape(B * S, -1), bad.reshape(B * S, -1))
        assert differ > CORE_DIFFER or ulps > 1, (differ, ulps)


@pytest.mark.parametrize("dtype", DTYPES)
def test_jnp_mha_core_on_the_card(dev, dtype):
    """The forward launches K12; the backward is the ``_jnp_mha`` VJP."""
    B, S, heads = 2, 577, 16
    qkv = _randn(B, S, 3 * heads * 64, dev=dev).to(dtype)
    g = _randn(B, S, heads * 64, dev=dev, seed=1).to(dtype)
    M.reset_launch_counts()
    leaf = qkv.clone().requires_grad_()
    out = M.jnp_mha_core(leaf, S, heads)
    out.backward(g)
    assert M.LAUNCHES == {"mha_core": 0, "flash_core": 0, "mha_core_bwd": 0,
                          "headgrid_core": 1}
    ref = qkv.clone().requires_grad_()
    want = M.jnp_mha_reference(ref, S, heads)
    want.backward(g)
    _assert_core_close(out.detach().reshape(B * S, -1), want.detach().reshape(B * S, -1), dtype)
    _assert_close(leaf.grad.reshape(B * S, -1), ref.grad.reshape(B * S, -1), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M_,K,N", [(37, 40, 24), (12800, 768, 3072), (19712, 512, 2048)])
def test_gemm_bias_gelu_f32(dev, dtype, M_, K, N):
    """QuickGELU on the fp32 h1 (K10); in bf16 the activation of the cast h1
    (K7-K9's epilogue) fails its bar."""
    a, w, bias = _gelu_case(M_, K, N, dev, dtype)
    TMLP.reset_launch_counts()
    got = TMLP.gemm_bias_gelu_f32(a, w, bias)
    assert TMLP.LAUNCHES["gemm_bias_gelu_f32"] == 1
    _assert_core_close(got, TMLP.gemm_bias_gelu_f32_reference(a, w, bias), dtype)
    if dtype == torch.bfloat16 and M_ > 1000:
        differ, ulps = _ulp_stats(got, TMLP.gemm_bias_gelu_reference(a, w, bias)[1])
        assert differ > CORE_DIFFER, (differ, ulps)


class _Recorder:
    """Records every call of K10's chain (``ops.block.KERNEL_FNS``): (index
    in the chain, inputs, output)."""

    def __init__(self):
        self.calls = []
        fns = [self._wrap(i, fn) for i, fn in enumerate(TBK.KERNEL_FNS)]
        self.patch = mock.patch.object(TBK, "KERNEL_FNS", tuple(fns))

    def _wrap(self, i, fn):
        def spy(*args):
            out = fn(*args)
            self.calls.append((i, args, out))
            return out
        return spy

    def __enter__(self):
        self.patch.start()
        return self

    def __exit__(self, *exc):
        self.patch.stop()


def _assert_block_rounding_points(calls, dtype, gelu=TMLP.gemm_bias_gelu_f32_reference):
    """Each kernel of the chain against its plain version on the inputs the
    kernel path gave it: LN1, qkv, ctx, a, LN2, the activation (``gelu``),
    out. The two residual sums (a, out) round twice (y cast, then x + y), so
    one flip of the first rounding is up to two ulps after the second; the
    activation of the fp32 h1 is cast once."""
    plain = list(TBK.REFERENCE_FNS)
    plain[3] = gelu
    for i, args, out in calls:
        _assert_core_close(out, plain[i](*args), dtype, 2 if len(args) == 4 else 1)


# (B, S, W, heads, causal): ViT-B/32 vision and text at batch 256, a short odd case
K10_BLOCKS = [(256, 50, 768, 12, False), (256, 77, 512, 8, True), (3, 13, 128, 2, True)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,W,heads,causal", K10_BLOCKS)
def test_block_fwd(dev, dtype, B, S, W, heads, causal):
    p = _block_params(W, dev)
    x = _randn(B * S, W, dev=dev, seed=5).to(dtype)
    for mod in (T, TMLP, TBK):
        mod.reset_launch_counts()
    with _Recorder() as rec:
        got = TBK.block_fwd(x, p, S, heads, causal)
    assert TBK.LAUNCHES["block_fwd"] == 1 and TMLP.LAUNCHES["gemm_bias_gelu_f32"] == 1
    assert T.LAUNCHES == {"ln_rows": 2, "gemm_bias_residual": 3, "attn_core": 1}
    _assert_close(got, TBK.block_fwd_reference(x, p, S, heads, causal), dtype)
    _assert_block_rounding_points(rec.calls, dtype)


def test_block_fwd_bar_rejects_the_cast_h1_activation(dev):
    B, S, W, heads, causal = K10_BLOCKS[0]
    p = _block_params(W, dev)
    x = _randn(B * S, W, dev=dev, seed=5).bfloat16()
    with _Recorder() as rec:
        TBK.block_fwd(x, p, S, heads, causal)
    with pytest.raises(AssertionError):
        _assert_block_rounding_points(
            rec.calls, torch.bfloat16, lambda a, w, b: TMLP.gemm_bias_gelu_reference(a, w, b)[1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [50, 197])
def test_transformer_block_on_the_card(dev, dtype, S):
    """The kernel path at S <= 128, the composed block past it; the backward
    the composed block's: output and every grad against the plain versions."""
    B, W, heads = 8, 768, 12
    p = _block_params(W, dev)
    x = _randn(B, S, W, dev=dev, seed=3).to(dtype)
    g = _randn(B, S, W, dev=dev, seed=4).to(dtype)

    def run():
        leaves = [x.clone().requires_grad_()] + [
            t.clone().requires_grad_() for t in (p["ln1"]["scale"], p["mlp"]["fc1"]["kernel"])]
        q = {**p, "ln1": {**p["ln1"], "scale": leaves[1]},
             "mlp": {**p["mlp"], "fc1": {**p["mlp"]["fc1"], "kernel": leaves[2]}}}
        out = TBK.transformer_block(leaves[0], q, heads)
        out.backward(g)
        return [out.detach()] + [t.grad for t in leaves]

    TBK.reset_launch_counts()
    got = run()
    assert TBK.LAUNCHES["block_fwd"] == int(S <= TBK.MAX_SEQ)
    with _plain_versions(TMLP, TBK, TBB):
        want = run()
    for name, a, b in zip(("out", "dx", "ln1.scale", "fc1.kernel"), got, want):
        try:  # dx: a whole block's bf16 backward (the K7 note above)
            if name == "out":
                _assert_close(a.reshape(B * S, W), b.reshape(B * S, W), dtype)
            else:
                _assert_sum_close(a, b, dtype)
        except AssertionError as e:
            raise AssertionError(f"{name}: {e}") from None


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("saved", [False, True])
@pytest.mark.parametrize("B,S,W,heads,causal,s_valid", [SUBLAYERS_B128[0], SUBLAYERS[2],
                                                        (8, 197, 768, 12, False, None)])
def test_attention_sublayer_bwd_split(dev, dtype, saved, B, S, W, heads, causal, s_valid):
    """K6 against its plain version, with the qkv recomputed or saved."""
    x, g, ln, attn = _sublayer_case(B, S, W, dev, dtype)
    qkv2 = None
    if saved:
        h = T.ln_rows(x, ln["scale"], ln["bias"])
        qkv2 = T.gemm_bias_residual(h, attn["qkv"]["kernel"].to(dtype), attn["qkv"]["bias"])
    T.reset_launch_counts()
    TB.reset_launch_counts()
    got = _bwd_leaves(*TB.attention_sublayer_bwd_split(x, g, ln, attn, S, heads, causal,
                                                       s_valid, qkv2=qkv2))
    assert TB.LAUNCHES["attention_sublayer_bwd_split"] == 1
    assert TB.LAUNCHES["attention_sublayer_bwd"] == 0
    assert T.LAUNCHES["gemm_bias_residual"] == int(not saved)
    want = _bwd_leaves(*TB.attention_sublayer_bwd_split_reference(
        x, g, ln, attn, S, heads, causal, s_valid, qkv2=qkv2))
    for k in want:
        assert got[k].dtype == (dtype if k == "dx" else torch.float32), k
        _assert_leaf(k, got[k], want[k], dtype)


@pytest.mark.parametrize("mode", ["dwsplit", "dwsplit_saveqkv"])
def test_bwd_modes_on_the_card(dev, mode):
    """One fp32 train step of a two-layer ViT-B/32 under each split mode
    gives the "fused" step's loss (1e-5 relative) and grads (leaf cosine >=
    0.9999), calling the split backward once a layer and K2 never."""
    import dataclasses

    from plip_tpu_torch.models import clip as tclip
    from plip_tpu_torch.models import config as tconfig
    from plip_tpu_torch.train.contrastive import clip_loss

    cfg = tconfig.CLIPConfig.vit_b32()
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, layers=2),
                              text=dataclasses.replace(cfg.text, layers=2))
    model = tclip.CLIP(cfg).init_params(torch.Generator().manual_seed(0)).to(dev)
    px = _randn(8, 224, 224, 3, dev=dev)
    ids = torch.randint(1, cfg.text.vocab_size - 1, (8, 77),
                        generator=torch.Generator().manual_seed(1))
    ids[:, 20] = cfg.text.eot
    ids = ids.to(dev)
    results = {}
    for m in ("fused", mode):
        TB.reset_launch_counts()
        model.zero_grad(set_to_none=True)
        with mock.patch.object(T, "BWD_MODE", m):
            loss, _ = clip_loss(model, px, ids, torch.float32, "mlp")
            loss.backward()
        results[m] = (loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()},
                      dict(TB.LAUNCHES))
    (l0, g0, n0), (l1, g1, n1) = results["fused"], results[mode]
    assert n0["attention_sublayer_bwd"] == 4 and n0["attention_sublayer_bwd_split"] == 0
    assert n1["attention_sublayer_bwd"] == 0 and n1["attention_sublayer_bwd_split"] == 4
    assert l1 == pytest.approx(l0, rel=1e-5)
    for k in g0:
        cos = torch.nn.functional.cosine_similarity(g1[k].flatten().double(),
                                                    g0[k].flatten().double(), 0).item()
        assert cos >= 0.9999, (k, cos)


# one uint8 step of the normalized output, per channel
_LEVEL = 1 / (255 * torch.tensor(CLIP_IMAGE_STD))


def _assert_within_a_level(got, want):
    """At most one uint8 level apart, on at most 1e-3 of the elements."""
    d = (got.float() - want.float()).abs()
    assert (d <= _LEVEL.to(d.device) * (1 + 1e-4) + 1e-5).all(), d.max().item()
    assert (d > 1e-5).float().mean().item() <= 1e-3


def _preprocess_bars(imgs, out_size):
    """The fused path (one launch) against the two-matmul path: within a
    level; without the uint8 stores atol 1e-4; bf16 out the fp32 out
    rounded; a rerun bit-equal. Returns the fp32 output."""
    TPF.reset_launch_counts()
    got = preprocess_batch(imgs, out_size, fused=True)
    assert TPF.LAUNCHES["preprocess_fused"] == 1
    assert got.shape == (len(imgs), out_size, out_size, 3) and got.dtype == torch.float32
    _assert_within_a_level(got, preprocess_batch(imgs, out_size))
    raw = preprocess_batch(imgs, out_size, fused=True, emulate_uint8=False)
    torch.testing.assert_close(raw, preprocess_batch(imgs, out_size, emulate_uint8=False),
                               atol=1e-4, rtol=0)
    half = preprocess_batch(imgs, out_size, fused=True, dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16 and torch.equal(half, got.to(torch.bfloat16))
    raw_half = preprocess_batch(imgs, out_size, fused=True, emulate_uint8=False,
                                dtype=torch.bfloat16)
    assert torch.equal(raw_half, raw.to(torch.bfloat16))
    assert torch.equal(preprocess_batch(imgs, out_size, fused=True), got)
    assert TPF.LAUNCHES["preprocess_fused"] == 5
    return got


@pytest.mark.parametrize("shape,out_size", [((256, 256), 224), ((300, 400), 224),
                                            ((256, 256), 336), ((224, 224), 224),
                                            ((1024, 700), 224), ((2048, 2048), 224),
                                            ((301, 333), 225)])
def test_preprocess_fused(dev, shape, out_size):
    """At most one uint8 level from the two-matmul path, on at most 1e-3 of
    the elements; without the uint8 stores, atol 1e-4; bf16 out bit-equal to
    fp32 out cast; reruns bit-equal. Float and int16 images are truncated and
    wrapped into 0..255 (as the JAX package's kernel wrapper takes them):
    the same bars against the plain path on that uint8 batch, and
    bit-equal to the kernel on it."""
    gen = torch.Generator().manual_seed(0)
    imgs = torch.randint(0, 256, (16 if shape[0] <= 1024 else 4, *shape, 3), dtype=torch.uint8,
                         generator=gen).to(dev)
    _preprocess_bars(imgs, out_size)
    floats = (torch.rand(imgs.shape, generator=gen) * 340 - 40).to(dev)
    ints = torch.randint(-300, 600, imgs.shape, generator=gen, dtype=torch.int16).to(dev)
    for odd in (floats, ints):
        as_u8 = odd.to(torch.int32).to(torch.uint8)
        got = preprocess_batch(odd, out_size, fused=True)
        _assert_within_a_level(got, preprocess_batch(as_u8, out_size))
        assert torch.equal(got, preprocess_batch(as_u8, out_size, fused=True))


def test_preprocess_fused_views_and_dtypes(dev):
    """Unaligned input: imgs[1:] at 1024x700 (each band starts 2,100 bytes a
    row in) and a batch whose first byte is 3 past a 16-byte boundary; a
    float16 output is the fp32 output cast."""
    imgs = torch.randint(0, 256, (5, 1024, 700, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(1)).to(dev)
    flat = torch.empty(imgs.numel() + 16, dtype=torch.uint8, device=dev)
    shifted = flat[3:3 + imgs.numel()].view(imgs.shape)
    shifted.copy_(imgs)
    assert shifted.data_ptr() % 16 == 3
    want = _preprocess_bars(imgs, 224)
    for view, rows in ((imgs[1:], slice(1, None)), (shifted, slice(None))):
        got = preprocess_batch(view, 224, fused=True)
        assert torch.equal(got, want[rows])
    half = preprocess_batch(imgs, 224, fused=True, dtype=torch.float16)
    assert half.dtype == torch.float16 and torch.equal(half, want.to(torch.float16))


def test_preprocess_fused_band_too_large(dev):
    """A band that does not fit a block's shared memory raises ValueError
    (the 20000 x 20000 image is a stride-0 view: no memory behind it)."""
    huge = torch.zeros(1, 1, 1, 3, dtype=torch.uint8, device=dev).expand(1, 20000, 20000, 3)
    with pytest.raises(ValueError, match="shared memory"):
        preprocess_batch(huge, 224, fused=True)


@pytest.mark.parametrize("shape,emulate,dtype", [((300, 400), True, torch.float32),
                                                 ((300, 400), True, torch.bfloat16),
                                                 ((300, 400), False, torch.float32),
                                                 ((2048, 2048), False, torch.float32)])
def test_preprocess_fused_smem_is_the_kernels(dev, shape, emulate, dtype):
    """The plan's count of a block's shared memory (``smem_bytes``) is the
    kernel's own layout's: the plan launches, and the kernel refuses the
    same plan with one byte more or one less."""
    import dataclasses

    imgs = torch.randint(0, 256, (2, *shape, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(2)).to(dev)
    def run():
        return preprocess_batch(imgs, 224, fused=True, emulate_uint8=emulate, dtype=dtype)

    want = run()
    torch.cuda.synchronize()
    real = TPF._device_plan
    for delta in (1, -1):
        def shifted(*args, delta=delta):
            p, tables = real(*args)
            return dataclasses.replace(p, smem=p.smem + delta), tables

        with mock.patch.object(TPF, "_device_plan", shifted):
            with pytest.raises(RuntimeError, match="launch failed"):
                run()
    assert torch.equal(run(), want)


def test_336_block_step_launches_headgrid(dev):
    """The @336 "block" fallback's core is K12 (normalize-first, the JAX
    package's _jnp_mha), not K5: two vision layers, forward and recompute."""
    import dataclasses

    from plip_tpu_torch.models import clip as tclip
    from plip_tpu_torch.models import config as tconfig
    from plip_tpu_torch.train.contrastive import clip_loss

    cfg = tconfig.ARCHITECTURES["ViT-L/14@336px"]()
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, layers=2),
                              text=dataclasses.replace(cfg.text, layers=1))
    model = tclip.CLIP(cfg).init_params(torch.Generator().manual_seed(0)).to(dev)
    px = _randn(2, 336, 336, 3, dev=dev)
    ids = torch.randint(1, cfg.text.vocab_size - 1, (2, 77),
                        generator=torch.Generator().manual_seed(1))
    ids[:, 20] = cfg.text.eot
    M.reset_launch_counts()
    loss, _ = clip_loss(model, px, ids.to(dev), torch.bfloat16, "block")
    loss.backward()
    assert M.LAUNCHES["headgrid_core"] == 4 and M.LAUNCHES["flash_core"] == 0, M.LAUNCHES


# ---------------------------------------------------------------------------
# The epilogue GEMMs on wgmma (csrc/gemm.cuh): gemm_bias_residual,
# gemm_bias_gelu, gemm_bias_gelu_f32 (NN) and gemm_nt_gelu_bwd (NT) at
# ragged edges, and what their wrappers refuse
# ---------------------------------------------------------------------------

# (M, K, N): M not a multiple of 128, N a multiple of 8 but not of 64, K not
# a multiple of 64 (K = 40 is one partly zero-filled K step); the last is
# B/16 text's 1576 rows
EPILOGUE_RAGGED = [(37, 40, 24), (200, 72, 136), (777, 520, 1000), (1576, 776, 3064)]
EPILOGUE_ENTRIES = ["gemm_bias_residual", "gemm_bias_residual with R", "gemm_bias_gelu",
                    "gemm_bias_gelu_f32", "gemm_nt_gelu_bwd"]


@pytest.mark.parametrize("M_,K,N", EPILOGUE_RAGGED)
@pytest.mark.parametrize("entry", EPILOGUE_ENTRIES)
def test_epilogue_gemm_bf16_ragged(dev, entry, M_, K, N):
    """Each bf16 entry point against its plain version at its bars: the
    residual GEMM at step 2's, h1, dh1 and K10's activation within one ulp
    of the row max, the activation of the cast h1 within ACT_ULPS, at most
    CORE_DIFFER of the elements differing."""
    dt = torch.bfloat16
    a, w, bias = _gelu_case(M_, K, N, dev, dt)
    T.reset_launch_counts()
    TMLP.reset_launch_counts()
    if entry.startswith("gemm_bias_residual"):
        r = _randn(M_, N, dev=dev, seed=3).to(dt) if entry.endswith("R") else None
        _assert_close(T.gemm_bias_residual(a, w, bias, r),
                      T.gemm_bias_residual_reference(a, w, bias, r), dt)
        assert T.LAUNCHES["gemm_bias_residual"] == 1
    elif entry == "gemm_bias_gelu":
        h1, act = TMLP.gemm_bias_gelu(a, w, bias)
        want_h1, want_act = TMLP.gemm_bias_gelu_reference(a, w, bias)
        _assert_core_close(h1, want_h1, dt)
        _assert_core_close(act, want_act, dt, ACT_ULPS)
    elif entry == "gemm_bias_gelu_f32":
        _assert_core_close(TMLP.gemm_bias_gelu_f32(a, w, bias),
                           TMLP.gemm_bias_gelu_f32_reference(a, w, bias), dt)
    else:  # NT: g [M, K], fc2's weight [N, K], h [M, N]
        wt = _randn(N, K, dev=dev, std=N ** -0.5, seed=1).to(dt)
        h = _randn(M_, N, dev=dev, std=2.0, seed=4).to(dt)
        _assert_core_close(TMLP.gemm_nt_gelu_bwd(a, wt, h),
                           TMLP.gemm_nt_gelu_bwd_reference(a, wt, h), dt)
    if entry in TMLP.LAUNCHES:
        assert TMLP.LAUNCHES[entry] == 1


def _misaligned(t):
    """t's values in a tensor whose data starts 2 bytes past a 16-byte
    boundary (contiguous, same shape)."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = flat[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def test_epilogue_gemm_wrappers_refuse_strided_and_misaligned(dev):
    """A residual that is a strided view, or R, h or the bias 16-byte
    misaligned, raises in the wrapper: no launch, no fallback."""
    dt = torch.bfloat16
    a, w, bias = _gelu_case(256, 64, 192, dev, dt)
    r_wide = _randn(256, 256, dev=dev, seed=3).to(dt)
    h = _randn(256, 192, dev=dev, seed=4).to(dt)
    g = _randn(256, 64, dev=dev, seed=5).to(dt)
    wt = _randn(192, 64, dev=dev, seed=6).to(dt)
    T.reset_launch_counts()
    TMLP.reset_launch_counts()
    with pytest.raises(ValueError, match="contiguous"):
        T.gemm_bias_residual(a, w, bias, r_wide[:, :192])
    with pytest.raises(ValueError, match="16-byte aligned"):
        T.gemm_bias_residual(a, w, bias, _misaligned(r_wide[:, :192].contiguous()))
    with pytest.raises(ValueError, match="16-byte aligned"):
        T.gemm_bias_residual(a, w, _misaligned(bias))
    with pytest.raises(ValueError, match="16-byte aligned"):
        TMLP.gemm_bias_gelu(a, w, _misaligned(bias))
    with pytest.raises(ValueError, match="16-byte aligned"):
        TMLP.gemm_nt_gelu_bwd(g, wt, _misaligned(h))
    with pytest.raises(ValueError, match="contiguous"):
        TMLP.gemm_nt_gelu_bwd(g, wt, r_wide[:, :192])
    with pytest.raises(ValueError, match="N % 8"):
        TMLP.gemm_nt_gelu_bwd(g, wt[:190].contiguous(), h[:, :190].contiguous())
    assert T.LAUNCHES["gemm_bias_residual"] == 0
    assert not any(TMLP.LAUNCHES.values()), TMLP.LAUNCHES
    # the aligned, contiguous tensors launch
    T.gemm_bias_residual(a, w, bias, r_wide[:, :192].contiguous())
    assert T.LAUNCHES["gemm_bias_residual"] == 1


def test_epilogue_gemm_runs_are_bit_equal(dev):
    """No K slices and no atomics: two runs of each bf16 entry point give the
    same bits."""
    a, w, bias = _gelu_case(1576, 768, 3072, dev, torch.bfloat16)
    wt = _randn(3072, 768, dev=dev, std=3072 ** -0.5, seed=1).bfloat16()
    h = _randn(1576, 3072, dev=dev, std=2.0, seed=4).bfloat16()
    for fn in (lambda: TMLP.gemm_bias_gelu(a, w, bias), lambda: TMLP.gemm_nt_gelu_bwd(a, wt, h),
               lambda: TMLP.gemm_bias_gelu_f32(a, w, bias),
               lambda: T.gemm_bias_residual(a, w, bias, h)):
        x, y = fn(), fn()
        for u, v in zip(x if isinstance(x, tuple) else (x,), y if isinstance(y, tuple) else (y,)):
            assert torch.equal(u, v)


# ---------------------------------------------------------------------------
# fp32, the default dtype: the GEMM of csrc/simt_gemm.cuh and the one-block
# CUDA-core core; bf16 at head_dim != 64 (CLIPConfig.tiny)
# ---------------------------------------------------------------------------

# (M, K, N) at the serving shapes (ViT-B/32 vision W=768 at batch 32 and 256,
# text W=512 at 8 and 256 prompts: every tile of simt_gemm_plan), ragged
# edges, and K or N not a multiple of 4 (one float at a time)
F32_GEMM = [(1600, 768, 2304), (1600, 768, 768), (12800, 768, 2304), (12800, 768, 768),
            (616, 512, 1536), (616, 512, 512), (19712, 512, 1536), (19712, 512, 512),
            (37, 40, 24), (777, 520, 1000), (200, 42, 136), (130, 64, 70)]


@pytest.mark.parametrize("M_,K,N", F32_GEMM)
@pytest.mark.parametrize("entry", EPILOGUE_ENTRIES)
def test_epilogue_gemm_fp32(dev, entry, M_, K, N):
    """Each fp32 entry point on the CUDA-core GEMM against its plain version
    (fp32 bars, TF32 off), on the block tile simt_gemm_plan picks."""
    dt = torch.float32
    a, w, bias = _gelu_case(M_, K, N, dev, dt)
    T.reset_launch_counts()
    TMLP.reset_launch_counts()
    if entry.startswith("gemm_bias_residual"):
        r = _randn(M_, N, dev=dev, seed=3) if entry.endswith("R") else None
        _assert_close(T.gemm_bias_residual(a, w, bias, r),
                      T.gemm_bias_residual_reference(a, w, bias, r), dt)
        assert T.LAUNCHES["gemm_bias_residual"] == 1
    elif entry == "gemm_bias_gelu":
        got, want = TMLP.gemm_bias_gelu(a, w, bias), TMLP.gemm_bias_gelu_reference(a, w, bias)
        _assert_close(got[0], want[0], dt)
        _assert_close(got[1], want[1], dt)
    elif entry == "gemm_bias_gelu_f32":
        _assert_close(TMLP.gemm_bias_gelu_f32(a, w, bias),
                      TMLP.gemm_bias_gelu_f32_reference(a, w, bias), dt)
    else:  # NT: g [M, K], fc2's weight [N, K], h [M, N]
        wt = _randn(N, K, dev=dev, std=N ** -0.5, seed=1)
        h = _randn(M_, N, dev=dev, std=2.0, seed=4)
        _assert_close(TMLP.gemm_nt_gelu_bwd(a, wt, h), TMLP.gemm_nt_gelu_bwd_reference(a, wt, h),
                      dt)
    if entry in TMLP.LAUNCHES:
        assert TMLP.LAUNCHES[entry] == 1


def test_fp32_gemm_takes_misaligned_operands(dev):
    """fp32 accepts tensors off a 16-byte boundary (one float at a time) and
    gives the same values; two runs give the same bits."""
    a, w, bias = _gelu_case(300, 256, 192, dev, torch.float32)
    r = _randn(300, 192, dev=dev, seed=3)
    want = T.gemm_bias_residual_reference(a, w, bias, r)
    got = T.gemm_bias_residual(_misaligned(a), _misaligned(w), _misaligned(bias),
                               _misaligned(r))
    _assert_close(got, want, torch.float32)
    aligned = T.gemm_bias_residual(a, w, bias, r)
    _assert_close(aligned, want, torch.float32)
    assert torch.equal(aligned, T.gemm_bias_residual(a, w, bias, r))


@pytest.mark.parametrize("defer", [False, True])
@pytest.mark.parametrize("B,S,heads,D,causal,s_valid", [
    (32, 50, 12, 64, False, None),  # ViT-B/32 vision
    (256, 50, 12, 64, False, None),
    (32, 77, 8, 64, True, None),  # text
    (32, 77, 8, 64, True, 70),
    (32, 197, 12, 64, False, None),  # ViT-B/16 vision
    (8, 256, 4, 64, True, 250),
    (4, 100, 2, 128, False, 30),  # a key tile wholly past s_valid
    (6, 65, 4, 36, True, None),  # rows of 9 16-byte units: k unpadded
])
def test_attn_core_fp32_one_block(dev, defer, B, S, heads, D, causal, s_valid):
    """fp32 attn_core at S <= 256 in either schedule: the one-block kernel,
    one launch, at the fp32 bars; a rerun bit-equal."""
    qkv = _randn(B * S, 3 * heads * D, dev=dev, seed=S + D)
    spy, patch = _spy_lib(T)
    with patch:
        got = T.attn_core(qkv, S, heads, causal, s_valid, defer)
    assert spy.calls == {"plip_attn_core": 1}
    _assert_close(got, T.attn_core_reference(qkv, S, heads, causal, s_valid, defer),
                  torch.float32)
    assert torch.equal(got, T.attn_core(qkv, S, heads, causal, s_valid, defer))


@pytest.mark.parametrize("defer", [False, True])
@pytest.mark.parametrize("B,S,heads,D,causal,s_valid", [
    (8, 5, 4, 16, False, None),  # CLIPConfig.tiny vision
    (8, 16, 4, 8, True, None),  # tiny text
    (8, 16, 4, 8, True, 13),
    (32, 50, 24, 32, False, None),
    (32, 77, 16, 32, True, 70),
    (4, 128, 2, 128, True, 100),
    (4, 197, 48, 16, False, None),
    (4, 256, 8, 32, True, 250),
])
def test_attn_core_bf16_other_head_dims(dev, defer, B, S, heads, D, causal, s_valid):
    """bf16 at head_dim != 64 up to 256 tokens: the one-block CUDA-core
    kernel (plip_attn_core), at the cores' bars against the plain version,
    in either schedule."""
    qkv = _randn(B * S, 3 * heads * D, dev=dev, seed=S + D).bfloat16()
    assert T.core_route(S, D, torch.bfloat16) == "one_block"
    spy, patch = _spy_lib(T)
    with patch:
        got = T.attn_core(qkv, S, heads, causal, s_valid, defer)
    assert spy.calls == {"plip_attn_core": 1}
    _assert_core_close(got, T.attn_core_reference(qkv, S, heads, causal, s_valid, defer),
                       torch.bfloat16)


@pytest.mark.parametrize("B,S,heads,D,causal,s_valid", [
    (8, 5, 4, 16, False, None), (8, 16, 4, 8, True, None), (8, 16, 4, 8, True, 13),
    (32, 77, 16, 32, True, None), (4, 128, 2, 128, False, 100),
])
def test_attn_core_bwd_bf16_other_head_dims(dev, B, S, heads, D, causal, s_valid):
    """bf16 at head_dim != 64 up to 128 tokens: the CUDA-core kernel, ctx at
    the cores' bar and dqkv at the backward bar; a rerun bit-equal."""
    qkv = _randn(B * S, 3 * heads * D, dev=dev, seed=S).bfloat16()
    dctx = _randn(B * S, heads * D, dev=dev, seed=S + 1).bfloat16()
    TB.reset_launch_counts()
    ctx, dqkv = TB.attn_core_bwd(qkv, dctx, S, heads, causal, s_valid)
    assert TB.LAUNCHES["attn_core_bwd"] == 1
    want_ctx, want_dqkv = TB.attn_core_bwd_reference(qkv, dctx, S, heads, causal, s_valid)
    _assert_core_close(ctx, want_ctx, torch.bfloat16)
    _assert_bwd_close(dqkv, want_dqkv, torch.bfloat16)
    again = TB.attn_core_bwd(qkv, dctx, S, heads, causal, s_valid)
    assert torch.equal(again[0], ctx) and torch.equal(again[1], dqkv)


def test_tiny_bf16_encode_and_train_step_on_the_card(dev):
    """CLIPConfig.tiny (head_dim 16 and 8) in bf16: the encode and one train
    step launch attn_core and attn_core_bwd and match the plain path (row
    cosine >= 0.999, leaf cosine >= 0.995)."""
    from plip_tpu_torch.models import clip as tclip
    from plip_tpu_torch.models import config as tconfig
    from plip_tpu_torch.train.contrastive import clip_loss

    cfg = tconfig.CLIPConfig.tiny()
    model = tclip.CLIP(cfg).init_params(torch.Generator().manual_seed(0)).to(dev)
    n = cfg.vision.image_size
    px = _randn(8, n, n, 3, dev=dev)
    ids = torch.randint(1, cfg.text.vocab_size - 1, (8, cfg.text.context_length),
                        generator=torch.Generator().manual_seed(1))
    ids[:, 9] = cfg.text.eot
    ids = ids.to(dev)
    dt = torch.bfloat16

    def run():
        with torch.no_grad():
            emb = (model.encode_image(px, dt).float(), model.encode_text(ids, dt).float())
        model.zero_grad(set_to_none=True)
        loss, _ = clip_loss(model, px, ids, dt, "mlp")
        loss.backward()
        return emb, {k: p.grad.clone() for k, p in model.named_parameters()}

    T.reset_launch_counts()
    TB.reset_launch_counts()
    emb, got = run()
    assert T.LAUNCHES["attn_core"] > 0 and TB.LAUNCHES["attn_core_bwd"] > 0
    with _plain_versions():
        emb_ref, want = run()
    for a, b in zip(emb, emb_ref):
        assert torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item() >= 0.999
    for k, w in want.items():
        cos = torch.nn.functional.cosine_similarity(got[k].flatten().double(),
                                                    w.flatten().double(), 0).item()
        assert cos >= 0.995 or (got[k].abs().max() == 0 and w.abs().max() == 0), (k, cos)


# ---------------------------------------------------------------------------
# The key-tiled cores at every head_dim up to 128 (csrc/mha.cu, csrc/mha_bwd.cu
# on CUDA cores), K2's fp32 grad_gemm on csrc/simt_gemm.cuh and its
# register-tiled one-block core backward
# ---------------------------------------------------------------------------

# (B, S, heads, head_dim): ViT-H/14's vision head width at L/14's length,
# ViT-bigG/14's at @336's, a narrow head at @336's
WIDE_HEADS = [(4, 257, 4, 80), (2, 577, 4, 104), (2, 577, 8, 32)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,heads,D", WIDE_HEADS)
def test_key_tiled_cores_at_other_head_dims(dev, dtype, B, S, heads, D):
    """attn_core (both schedules), attn_core_bwd, mha_core, mha_core_bwd,
    flash_core and headgrid_core past 128 tokens at a head_dim other than
    64: one launch each, against the plain versions at the cores' bars."""
    qkv = _randn(B * S, 3 * heads * D, dev=dev, seed=D).to(dtype)
    g = _randn(B * S, heads * D, dev=dev, seed=D + 1).to(dtype)
    causal, s_valid = True, S - 3
    assert T.core_route(S, D, dtype) == T.core_route(S, D, dtype, True) == "tiled"
    for mod in (T, TB, M):
        mod.reset_launch_counts()
    for defer in (False, True):
        args = (S, heads, causal, s_valid, defer)
        _assert_core_close(T.attn_core(qkv, *args), T.attn_core_reference(qkv, *args), dtype)
    ctx, dqkv = TB.attn_core_bwd(qkv, g, S, heads, causal, s_valid)
    want_ctx, want_dqkv = TB.attn_core_bwd_reference(qkv, g, S, heads, causal, s_valid)
    _assert_core_close(ctx, want_ctx, dtype)
    _assert_bwd_close(dqkv, want_dqkv, dtype)
    q3 = qkv.view(B, S, -1)
    for name, fn, ref in (("flash_core", M.flash_core, M.flash_core_reference),
                          ("headgrid_core", M.headgrid_core, M.headgrid_core_reference)):
        _assert_core_close(fn(q3, S, heads, causal), ref(q3, S, heads, causal), dtype)
    if S <= M.MAX_SEQ:
        args = (S, heads, causal, s_valid)
        _assert_core_close(M.mha_core(q3, *args), M.mha_core_reference(q3, *args), dtype)
        g3 = g.view(B, S, -1)
        _assert_bwd_close(M.mha_core_bwd(q3, g3, *args), M.mha_core_bwd_reference(q3, g3, *args),
                          dtype)
    assert T.LAUNCHES["attn_core"] == 2 and TB.LAUNCHES["attn_core_bwd"] == 1
    short = S <= M.MAX_SEQ
    assert M.LAUNCHES == {"mha_core": int(short), "flash_core": 1, "mha_core_bwd": int(short),
                          "headgrid_core": 1}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,W,heads,causal", [(4, 257, 320, 4, False), (2, 300, 416, 4, True),
                                                (4, 257, 256, 8, False)])
def test_block_bwd_at_other_head_dims(dev, dtype, B, S, W, heads, causal):
    """K7 past 128 tokens at head_dim 80, 104 and 32 (its core backward is
    K4 on CUDA cores): every leaf at the bars of test_block_bwd, the
    rounding points at the cores' bars."""
    p = _block_params(W, dev)
    x = _randn(B * S, W, dev=dev, seed=5).to(dtype)
    g = _randn(B * S, W, dev=dev, seed=6).to(dtype)
    for mod in (T, TB, M, TMLP, TBB):
        mod.reset_launch_counts()
    with _Spy() as spy:
        got = _flat_leaves(*TBB.block_bwd(x, g, p, S, heads, causal))
    assert TBB.LAUNCHES["block_bwd"] == 1 and M.LAUNCHES["mha_core_bwd"] == 1
    want = _flat_leaves(*TBB.block_bwd_reference(x, g, p, S, heads, causal))
    for k in want:
        _assert_sum_close(got[k], want[k], dtype)
    _assert_rounding_points(spy.seen, dtype)


# fp32 grad_gemm at odd M, N and K (one float at a time) and sums shorter
# and longer than a slice: (M, N, K) of C = A . B^T (NT) or A^T . B (TN)
ODD_F32 = [(37, 41, 43), (129, 255, 1000), (6400, 770, 771), (769, 2305, 6401), (3, 5, 7)]


@pytest.mark.parametrize("M_,N,K", ODD_F32)
@pytest.mark.parametrize("layout", ["NT", "TN"])
@pytest.mark.parametrize("shifted", [False, True])
def test_grad_gemm_fp32_odd_and_misaligned(dev, layout, shifted, M_, N, K):
    """fp32 grad_gemm on csrc/simt_gemm.cuh at odd shapes, with the operands
    off a 16-byte boundary or not, in the planned K slices: one launch (and
    col_sum where there are slices), the fp32 bars; a rerun bit-equal."""
    move = _misaligned if shifted else (lambda t: t)
    if layout == "NT":
        a, b = _randn(M_, K, dev=dev), _randn(N, K, dev=dev, std=K ** -0.5, seed=1)
        fn = lambda: TB.grad_gemm_nt(move(a), move(b), torch.float32)
        want = TB.grad_gemm_nt_reference(a, b, torch.float32)
    else:
        a, b = _randn(K, M_, dev=dev), _randn(K, N, dev=dev, seed=1)
        fn = lambda: TB.grad_gemm_tn(move(a), move(b))
        want = TB.grad_gemm_tn_reference(a, b)
    TB.reset_launch_counts()
    got = fn()
    slices = len(TB.tn_slices(M_, N, K, torch.float32, TB._sm_count(dev)))
    assert TB.LAUNCHES["grad_gemm"] == 1 and TB.LAUNCHES["col_sum"] == int(slices > 1)
    assert got.shape == (M_, N) and got.dtype == torch.float32
    (_assert_sum_close if layout == "TN" else _assert_close)(got, want, torch.float32)
    assert torch.equal(got, fn())


# (S, heads, head_dim, causal, s_valid); bf16 at head_dim 64 runs the wgmma
# kernel (test_attn_core_bwd_one_block_bf16)
REGISTER_TILED = [(1, 4, 48, False, None), (5, 4, 16, True, None), (50, 12, 64, False, None),
                  (50, 6, 80, False, 45), (77, 8, 64, True, None), (77, 4, 104, True, 70),
                  (77, 8, 32, False, 60), (128, 2, 128, True, 100), (128, 4, 36, False, None),
                  (100, 3, 10, True, None)]


@pytest.mark.parametrize("dtype,S,heads,D,causal,s_valid",
                         [(dt, *case) for dt in DTYPES for case in REGISTER_TILED
                          if not (dt == torch.bfloat16 and case[2] == 64)])
def test_attn_core_bwd_register_tiled(dev, dtype, S, heads, D, causal, s_valid):
    """The one-block CUDA-core core backward (fp32 at every head_dim, bf16
    at another than 64) at S <= 128: one launch, fp32 at the fp32 bars and
    bf16 at the cores' bars, every value finite, a rerun bit-equal, and the
    same values from operands off a 16-byte boundary."""
    B = 6
    qkv = _randn(B * S, 3 * heads * D, dev=dev, seed=S + D).to(dtype)
    g = _randn(B * S, heads * D, dev=dev, seed=S + D + 1).to(dtype)
    assert T.core_route(S, D, dtype, backward=True) == "one_block"
    TB.reset_launch_counts()
    ctx, dqkv = TB.attn_core_bwd(qkv, g, S, heads, causal, s_valid)
    assert TB.LAUNCHES["attn_core_bwd"] == 1
    assert torch.isfinite(ctx.float()).all() and torch.isfinite(dqkv.float()).all()
    want_ctx, want_dqkv = TB.attn_core_bwd_reference(qkv, g, S, heads, causal, s_valid)
    if dtype == torch.float32:
        _assert_close(ctx, want_ctx, dtype)
        _assert_close(dqkv, want_dqkv, dtype)
    else:
        _assert_core_close(ctx, want_ctx, dtype)
        _assert_bwd_close(dqkv, want_dqkv, dtype)
    again = TB.attn_core_bwd(qkv, g, S, heads, causal, s_valid)
    assert torch.equal(again[0], ctx) and torch.equal(again[1], dqkv)
    shifted = TB.attn_core_bwd(_misaligned(qkv), _misaligned(g), S, heads, causal, s_valid)
    assert torch.equal(shifted[0], ctx) and torch.equal(shifted[1], dqkv)


# ---------------------------------------------------------------------------
# The key-tiled cores off wgmma, redesigned (csrc/tf32_attn.cuh: TF32
# tensor-core products, fp32 as three): the logits of a query tile computed
# once into shared memory, every head_dim (128-column chunks past 128), the
# tails of the last query and key tiles
# ---------------------------------------------------------------------------

# (B, S, heads, head_dim, causal, s_valid): S from 1 to 1056 across the tails
# (129, 257, 577, 1056), head_dims 1 to 256, causal and pad columns
TILED = [(2, 1, 2, 16, False, None), (2, 129, 2, 80, True, None),
         (2, 257, 2, 64, False, 250), (2, 577, 2, 64, True, None),
         (1, 1056, 1, 64, False, 1000), (3, 257, 2, 1, False, None),
         (2, 130, 2, 104, True, 120), (2, 257, 1, 128, False, None),
         (2, 200, 2, 160, True, 190), (2, 300, 1, 256, False, None),
         (1, 577, 1, 160, True, None), (2, 65, 3, 10, False, 60), (1, 1056, 1, 128, True, 1000)]


def _tiled_cores(qkv, g, S, heads, causal, s_valid, dtype):
    """Every core of the key-tiled kernels at one shape against its plain
    version (the cores' bars); returns the launches it expects."""
    D = qkv.shape[-1] // 3 // heads
    want = {"attn_core": 0, "attn_core_bwd": 0}
    for defer in (False, True):
        if T.core_route(S, D, dtype) == "tiled":
            args = (S, heads, causal, s_valid, defer)
            _assert_core_close(T.attn_core(qkv, *args), T.attn_core_reference(qkv, *args), dtype)
            want["attn_core"] += 1
    if T.core_route(S, D, dtype, backward=True) == "tiled":
        ctx, dqkv = TB.attn_core_bwd(qkv, g, S, heads, causal, s_valid)
        want_ctx, want_dqkv = TB.attn_core_bwd_reference(qkv, g, S, heads, causal, s_valid)
        _assert_core_close(ctx, want_ctx, dtype)
        _assert_bwd_close(dqkv, want_dqkv, dtype)
        want["attn_core_bwd"] = 1
    for name, fn, ref in (("flash_core", M.flash_core, M.flash_core_reference),
                          ("headgrid_core", M.headgrid_core, M.headgrid_core_reference)):
        _assert_core_close(fn(qkv, S, heads, causal), ref(qkv, S, heads, causal), dtype)
    short = S <= M.MAX_SEQ
    if short:
        args = (S, heads, causal, s_valid)
        _assert_core_close(M.mha_core(qkv, *args), M.mha_core_reference(qkv, *args), dtype)
        _assert_bwd_close(M.mha_core_bwd(qkv, g, *args), M.mha_core_bwd_reference(qkv, g, *args),
                          dtype)
    want.update({"mha_core": int(short), "mha_core_bwd": int(short), "flash_core": 1,
                 "headgrid_core": 1})
    return want


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,heads,D,causal,s_valid", TILED)
def test_tiled_cores_off_wgmma(dev, dtype, B, S, heads, D, causal, s_valid):
    """The redesigned key-tiled kernels (fp32, and bf16 at head_dim != 64,
    on TF32 tensor-core products) against their plain versions, each core
    launched once."""
    if dtype == torch.bfloat16 and D == T.TILED_HEAD_DIM:
        pytest.skip("bf16 at head_dim 64 runs the wgmma kernels (their own tests)")
    qkv = _randn(B * S, 3 * heads * D, dev=dev, seed=S + D).to(dtype)
    g = _randn(B * S, heads * D, dev=dev, seed=S + D + 1).to(dtype)
    for mod in (T, TB, M):
        mod.reset_launch_counts()
    want = _tiled_cores(qkv, g, S, heads, causal, s_valid, dtype)
    got = {**T.LAUNCHES, **TB.LAUNCHES, **M.LAUNCHES}
    assert all(got[k] == n for k, n in want.items()), (got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,D", [(257, 80), (200, 160), (577, 64)])
def test_tiled_cores_take_misaligned_operands(dev, dtype, S, D):
    """qkv and g one element off a 16-byte boundary: the tiles come a value
    at a time, with the same products."""
    if dtype == torch.bfloat16 and D == T.TILED_HEAD_DIM:
        D = 48
    heads, B = 2, 2
    flat = _randn(B * S * 3 * heads * D + 1, dev=dev, seed=3).to(dtype)
    qkv = flat[1:].view(B * S, 3 * heads * D)
    gflat = _randn(B * S * heads * D + 1, dev=dev, seed=4).to(dtype)
    g = gflat[1:].view(B * S, heads * D)
    assert qkv.data_ptr() % 16 and g.data_ptr() % 16
    _tiled_cores(qkv, g, S, heads, True, S - 5, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_tiled_reruns_are_bit_equal(dev, dtype):
    """No atomics: two runs of each redesigned kernel give the same bits."""
    B, S, heads, D = 2, 257, 4, 80
    qkv = _randn(B * S, 3 * heads * D, dev=dev, seed=7).to(dtype)
    g = _randn(B * S, heads * D, dev=dev, seed=8).to(dtype)
    calls = (lambda: T.attn_core(qkv, S, heads), lambda: M.flash_core(qkv, S, heads),
             lambda: M.mha_core_bwd(qkv, g, S, heads, True, 250),
             lambda: TB.attn_core_bwd(qkv, g, S, heads))
    for fn in calls:
        a, b = fn(), fn()
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("S,D", [(120, 128), (200, 256), (65, 80)])
def test_tiled_rows_and_keys_kernels_agree_bit_for_bit(dev, S, D):
    """fp32 K4: the rows kernel's dS (in dq) and the keys kernel's (in dk) are
    the same bits. With q = k = the identity's first S rows, dq[i][j] =
    dS[i][j] * scale and dk[j][i] = dS[i][j] * scale, each one product of
    exact 1s and 0s: equal only if both kernels rebuilt the same dS."""
    B = 2
    eye = torch.eye(S, D, device=dev)
    qkv = torch.cat([eye, eye, _randn(S, D, dev=dev, seed=9)], 1).repeat(B, 1)
    g = _randn(B * S, D, dev=dev, seed=10)
    for causal in (False, True):
        dqkv = M.mha_core_bwd(qkv, g, S, 1, causal).view(B, S, 3, D)
        dq, dk = dqkv[:, :, 0, :S], dqkv[:, :, 1, :S]
        assert dq.abs().max() > 0
        assert torch.equal(dq, dk.transpose(1, 2))


@pytest.mark.parametrize("dtype", DTYPES)
def test_tiled_plan_takes_windows(dev, dtype):
    """Where the strip of every key would pass the shared memory the plan
    takes windows (the logits computed twice): flash_core at 2,000 tokens and
    the backward at 1,056 at head_dim 128 against their plain versions."""
    assert T.tiled_plan(2000, 128)[1] < -(-2000 // T.TILED_KEYS)
    assert T.tiled_plan(1056, 128, backward=True)[1] < -(-1056 // T.TILED_KEYS)
    qkv = _randn(2000, 3 * 128, dev=dev, seed=11).to(dtype)
    _assert_core_close(M.flash_core(qkv, 2000, 1, True), M.flash_core_reference(qkv, 2000, 1, True),
                       dtype)
    qkv, g = qkv[:1056].contiguous(), _randn(1056, 128, dev=dev, seed=12).to(dtype)
    for a, b in zip(TB.attn_core_bwd(qkv, g, 1056, 1, True, 1000),
                    TB.attn_core_bwd_reference(qkv, g, 1056, 1, True, 1000)):
        _assert_bwd_close(a, b, dtype)


# ---------------------------------------------------------------------------
# ln_rows and ln_bwd_rows on the register row layout; the towers' LayerNorm
# ---------------------------------------------------------------------------

# (rows, width): every width the JAX package takes (odd ones on one value a
# load), the towers' widths (text 512, B/32 768, L/14 1024, ViT-H/14 1280,
# ViT-bigG/14 1664) at the B/32 batch-128 and batch-256 row counts, and one
# width past the register layout's reach (one block a row)
LN_SHAPES = [(1, 1), (3, 33), (37, 100), (5, 512), (6400, 768), (9856, 512), (19712, 512),
             (1600, 768), (257, 1024), (64, 1280), (333, 1664), (7, T.LN_MAX_WIDTH + 8)]


def _assert_ln_close(got, want, dtype, scale=None):
    """The LayerNorm kernels' bars (PERF.md section 2): fp32 allclose 1e-5;
    bf16 every element within one bf16 ulp of its row's largest |want| (of
    ``scale`` where given), as the cores' bar: an element near zero is a
    difference of O(1) fp32 terms, whose last bits differ with the order of
    the row's sums."""
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        top = (want.abs() if scale is None else scale.float()).flatten(0, -2).amax(-1)
        _, e = torch.frexp(top.clamp_min(2.0 ** -126))
        ulps = (got - want).abs().flatten(0, -2) / torch.ldexp(torch.ones_like(top), e - 8)[:, None]
        assert ulps.max().item() <= 1, f"{ulps.max().item()} ulps"


def _ln_rows_input(rows, width, dtype, dev, offset=0, seed=0):
    x = _randn(rows * width + offset, dev=dev, std=2, seed=seed).add_(0.5).to(dtype)
    return x[offset:].view(rows, width)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,width", LN_SHAPES)
@pytest.mark.parametrize("offset", [0, 1])
def test_ln_rows_widths(dev, dtype, rows, width, offset):
    """One launch on the planned layout (a view 1 element past a 16-byte
    boundary takes one value a load), the bars against the plain version and
    the same bits on a rerun."""
    x = _ln_rows_input(rows, width, dtype, dev, offset)
    s, b = 1 + _randn(width, dev=dev, std=0.1, seed=1), _randn(width, dev=dev, std=0.1, seed=2)
    lay = T.ln_layout(width, x.element_size(), x.data_ptr() % 16 == 0)
    assert (lay.vec > 1) == (offset == 0 and width % (16 // x.element_size()) == 0
                             and width <= T.LN_MAX_WIDTH)
    T.reset_launch_counts()
    got = T.ln_rows(x, s, b)
    assert T.LAUNCHES["ln_rows"] == 1
    _assert_ln_close(got, T.layer_norm_rows_reference(x, s, b), dtype)
    assert torch.equal(got, T.ln_rows(x, s, b))


def _layouts(width, itemsize):
    """Every layout the kernels take at this width: each vec, warps a row and
    the smallest bucket that holds the row."""
    out = []
    for vec in {16 // itemsize if width % (16 // itemsize) == 0 else 1, 1}:
        for warps in (1, 2, 4, 8):
            need = -(-(width // vec) // (32 * warps)) * vec
            out += [T.LnLayout(vec, warps, b) for b in T.LN_BUCKETS if b >= need][:1]
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", [40, 768, 1664])
def test_ln_kernels_on_every_layout(dev, dtype, width):
    """Forced layouts (one to eight warps a row, 16-byte and one-value loads,
    every bucket that holds the row): the forward and the backward against
    their plain versions, the backward's partial sums to the same leaf."""
    rows = 203
    x = _ln_rows_input(rows, width, dtype, dev)
    dln = _randn(rows, width, dev=dev, seed=3)
    s, b = 1 + _randn(width, dev=dev, std=0.1, seed=1), _randn(width, dev=dev, std=0.1, seed=2)
    want = T.layer_norm_rows_reference(x, s, b)
    want_dx, want_partial = TB.ln_bwd_rows_reference(x, dln, None, s)
    layouts = _layouts(width, x.element_size())
    assert len(layouts) >= 4
    for lay in layouts:
        _assert_ln_close(T.ln_rows(x, s, b, layout=lay), want, dtype)
        dx, partial = TB.ln_bwd_rows(x, dln, None, s, layout=lay)
        _assert_ln_close(dx, want_dx, dtype)
        _assert_sum_close(TB.col_sum(partial), TB.col_sum_reference(want_partial),
                          torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,width", LN_SHAPES)
@pytest.mark.parametrize("dln_f32,residual,offset", [(True, True, 0), (False, False, 0),
                                                      (True, False, 1), (False, True, 1)])
def test_ln_bwd_rows_widths(dev, dtype, rows, width, dln_f32, residual, offset):
    """dln fp32 (K2, K7, K8) or in the compute dtype (``layer_norm_rows``'
    backward), with and without the residual g, aligned or one element past
    16 bytes: dx within the bars of the plain version (bf16 one ulp of |dx| +
    |g|: dx = g + cast(dx_ln) rounds twice), the planned partial's shape and
    sums, the same bits on a rerun."""
    x = _ln_rows_input(rows, width, dtype, dev, offset)
    dln = _ln_rows_input(rows, width, torch.float32 if dln_f32 else dtype, dev, offset, seed=4)
    g = _ln_rows_input(rows, width, dtype, dev, offset, seed=5) if residual else None
    s = 1 + _randn(width, dev=dev, std=0.1, seed=3)
    TB.reset_launch_counts()
    dx, partial = TB.ln_bwd_rows(x, dln, g, s)
    assert TB.LAUNCHES["ln_bwd_rows"] == 1 and dx.dtype == dtype
    split = TB.ln_bwd_split(rows, width, T._sm_count(x.device))
    assert partial.shape == (-(-rows // split), 2 * width)
    want_dx, want_partial = TB.ln_bwd_rows_reference(x, dln, g, s)
    _assert_ln_close(dx, want_dx, dtype, None if g is None else want_dx.abs() + g.abs())
    assert partial.shape == want_partial.shape
    _assert_sum_close(TB.col_sum(partial), TB.col_sum_reference(want_partial), torch.float32)
    dx2, partial2 = TB.ln_bwd_rows(x, dln, g, s)
    assert torch.equal(dx, dx2) and torch.equal(partial, partial2)


def test_ln_bwd_rows_raises_on_what_the_kernel_does_not_take(dev):
    x = torch.randn(20, 64, device=dev)
    s = torch.ones(64, device=dev)
    TB.reset_launch_counts()
    with pytest.raises(ValueError, match="dln: dtype"):
        TB.ln_bwd_rows(x.bfloat16(), x.half(), None, s)
    with pytest.raises(ValueError, match="contiguous"):
        TB.ln_bwd_rows(x, torch.randn(64, 20, device=dev).t(), None, s)
    with pytest.raises(ValueError, match="g: dtype"):
        TB.ln_bwd_rows(x, x, x.bfloat16(), s)
    assert TB.LAUNCHES["ln_bwd_rows"] == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,strided", [((4, 50, 768), False), ((9856, 512), False),
                                           ((32, 50, 1024), True), ((3, 7, 100), True)])
def test_layer_norm_rows_grads_on_the_card(dev, dtype, shape, strided):
    """The towers' LayerNorm (``ln_rows`` forward, ``ln_bwd_rows`` and
    ``col_sum`` backward; ``x[:, 0]`` made contiguous) against autograd of the
    plain version: y and dx within the kernels' bars, dscale and dbias within
    a summed leaf's."""
    W = shape[-1]
    x = _randn(*shape, dev=dev, std=2, seed=6).to(dtype)
    s, b = 1 + _randn(W, dev=dev, std=0.1, seed=1), _randn(W, dev=dev, std=0.1, seed=2)
    gy = _randn(*(shape[:1] + shape[2:] if strided else shape), dev=dev, seed=7).to(dtype)
    out = {}
    for name, fn in (("kernels", T.layer_norm_rows), ("plain", T.layer_norm_rows_reference)):
        xl, sl, bl = (t.clone().requires_grad_() for t in (x, s, b))
        y = fn(xl[:, 0] if strided else xl, sl, bl, 1e-5)
        y.backward(gy)
        out[name] = (y.detach(), xl.grad, sl.grad, bl.grad)
    T.reset_launch_counts()
    TB.reset_launch_counts()
    xl = x.clone().requires_grad_()
    T.layer_norm_rows(xl[:, 0] if strided else xl, s, b).backward(gy)
    assert T.LAUNCHES["ln_rows"] == 1 and TB.LAUNCHES["ln_bwd_rows"] == 1
    assert TB.LAUNCHES["col_sum"] == 1
    (y, dx, ds, db), (y0, dx0, ds0, db0) = out["kernels"], out["plain"]
    assert y.dtype == dx.dtype == dtype and ds.dtype == db.dtype == torch.float32
    _assert_ln_close(y, y0, dtype)
    _assert_ln_close(dx, dx0, dtype)
    _assert_sum_close(ds, ds0, torch.float32)
    _assert_sum_close(db, db0, torch.float32)


# (architecture, remat, ln_rows launches of a train step at L layers a tower):
# every LayerNorm launches ln_rows once forward (2L + 2 vision, 2L + 1 text)
# and once more for each recompute: K2's LN1 (K1 and the hybrid, not the
# composed sublayer), LN2 under "mlp", "mlp_h1" and "block" (K7/K8 recompute
# LN1 and LN2), the whole block under True; ln_bwd_rows once a LayerNorm
LN_STEPS = [("ViT-B/32", False, lambda L: 6 * L + 3), ("ViT-B/32", "mlp", lambda L: 8 * L + 3),
            ("ViT-B/32", "mlp_h1", lambda L: 8 * L + 3), ("ViT-B/32", True, lambda L: 10 * L + 3),
            ("ViT-B/32", "block", lambda L: 8 * L + 3),
            ("ViT-L/14", "mlp", lambda L: 8 * L + 3),  # the hybrid
            ("ViT-L/14", False, lambda L: 5 * L + 3)]  # vision composed over K3


@pytest.mark.parametrize("arch,remat,ln_rows", LN_STEPS)
def test_every_layer_norm_runs_the_kernels(dev, arch, remat, ln_rows):
    """Two layers a tower, batch 4, bf16: an image encode launches ln_rows 2L
    + 2 times and a text encode 2L + 1 (ln_pre, ln_post or ln_final, LN1 and
    LN2 of every block), no other kernel of the step is a LayerNorm's plain
    version, and one train step launches ln_rows as ``LN_STEPS`` counts and
    ln_bwd_rows once a LayerNorm (4L + 3)."""
    import dataclasses

    from plip_tpu_torch.models import clip as tclip
    from plip_tpu_torch.models import config as tconfig
    from plip_tpu_torch.train.contrastive import clip_loss

    L = 2
    cfg = tconfig.ARCHITECTURES[arch]()
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, layers=L),
                              text=dataclasses.replace(cfg.text, layers=L))
    model = tclip.CLIP(cfg).init_params(torch.Generator().manual_seed(0)).to(dev)
    n = cfg.vision.image_size
    px = _randn(4, n, n, 3, dev=dev)
    ids = torch.randint(1, cfg.text.vocab_size - 1, (4, 77),
                        generator=torch.Generator().manual_seed(1))
    ids[:, 20] = cfg.text.eot
    ids = ids.to(dev)
    with torch.inference_mode():
        for encode, want in ((lambda: model.encode_image(px, torch.bfloat16), 2 * L + 2),
                             (lambda: model.encode_text(ids, torch.bfloat16), 2 * L + 1)):
            T.reset_launch_counts()
            encode()
            assert T.LAUNCHES["ln_rows"] == want, (T.LAUNCHES, want)
    T.reset_launch_counts()
    TB.reset_launch_counts()
    loss, _ = clip_loss(model, px, ids, torch.bfloat16, remat)
    loss.backward()
    counts = (T.LAUNCHES["ln_rows"], TB.LAUNCHES["ln_bwd_rows"])
    assert counts == (ln_rows(L), 4 * L + 3), counts
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())


# ---- device retrieval (ops.retrieval): torch ops on the card, held to the
# same functions on the CPU


@pytest.mark.parametrize("M,N,D", [(64, 8192, 512), (1, 37, 13), (17, 8, 8), (24, 1000, 64)])
def test_int8_dot_on_the_card_is_exact(dev, M, N, D):
    from plip_tpu_torch.ops import retrieval as R

    g = torch.Generator().manual_seed(M)
    a = torch.randint(-127, 128, (M, D), dtype=torch.int8, generator=g)
    b = torch.randint(-127, 128, (N, D), dtype=torch.int8, generator=g)
    got = R.int8_dot(R.int8_operand(a.to(dev)), b.to(dev))[:M].cpu()
    assert torch.equal(got, a.int() @ b.int().T)


@pytest.mark.parametrize("n,chunk", [(20000, 8192), (500, 64), (37, 512)])
def test_device_topk_matches_the_cpu(dev, n, chunk):
    """The stream on the card gives the CPU's indices (duplicates included:
    ties earliest index first) and scores within fp32 sum order; the int8
    stream with its rescore the same indices."""
    import numpy as np

    from plip_tpu_torch.ops import retrieval as R

    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 64)).astype(np.float32)
    x[1::3] = x[0::3][: len(x[1::3])]  # exact duplicates
    q = rng.standard_normal((5, 64)).astype(np.float32)
    want = R.cosine_topk(q, x, k=12, normalize="queries", chunk=chunk)
    got = R.cosine_topk(q, torch.as_tensor(x, device=dev), k=12, normalize="queries",
                        chunk=chunk)
    assert np.array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    q8, inv = R.quantize_rows(x, normalize=False)
    want = R.cosine_topk_int8(q, q8, inv, k=12, rescore_vectors=x, chunk=chunk)
    got = R.cosine_topk_int8(q, torch.as_tensor(q8, device=dev), torch.as_tensor(inv, device=dev),
                             k=12, rescore_vectors=x, chunk=chunk)
    assert np.array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,chunk", [(20000, 8192), (37, 512)])
def test_device_topk_pad_rows_match_the_cpu(dev, n, chunk):
    """An index pre-padded on the card to a chunk multiple, with ``n_valid``:
    every real score is negative, so an unmasked zero pad row (score 0)
    would rank first; fp32 and int8 (rescored) give the CPU's indices on
    the unpadded index."""
    import numpy as np

    from plip_tpu_torch.ops import retrieval as R

    rng = np.random.default_rng(n + 1)
    x = -np.abs(rng.standard_normal((n, 64))).astype(np.float32)
    q = np.abs(rng.standard_normal((5, 64))).astype(np.float32)
    pad = -n % chunk
    xd = torch.nn.functional.pad(torch.as_tensor(x, device=dev), (0, 0, 0, pad))
    want = R.cosine_topk(q, x, k=12, normalize="queries", chunk=chunk)
    got = R.cosine_topk(q, xd, k=12, normalize="queries", chunk=chunk, n_valid=n)
    assert np.array_equal(got[0], want[0]) and (got[1] < 0).all()
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    q8, inv = R.quantize_rows(x, normalize=False)
    want = R.cosine_topk_int8(q, q8, inv, k=12, rescore_vectors=x, chunk=chunk)
    got = R.cosine_topk_int8(q, torch.as_tensor(np.pad(q8, ((0, pad), (0, 0))), device=dev),
                             torch.as_tensor(np.pad(inv, (0, pad)), device=dev), k=12,
                             rescore_vectors=x, chunk=chunk, n_valid=n)
    assert np.array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("quantize", [False, "int8"])
def test_api_device_retrieval_on_the_card(dev, tmp_path, quantize):
    """``PLIP.retrieval(backend="device")`` on the card over a 20,000-row
    index (padded once to three chunks, the pad rows masked by ``n_valid``),
    fp32 and int8: the host backend's indices."""
    import numpy as np

    from plip_tpu_torch import api
    from plip_tpu_torch.models import clip as tclip
    from plip_tpu_torch.models import config as tconfig
    from plip_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = tconfig.CLIPConfig.tiny(vocab_size=49408)  # the default tokenizer's ids
    path = str(tmp_path / "tiny.npz")
    save_checkpoint(path, tclip.CLIP(cfg).init_params(torch.Generator().manual_seed(0)), cfg)
    model = api.PLIP(path, device=dev)
    emb = np.random.default_rng(6).standard_normal((20000, cfg.embed_dim)).astype(np.float32)
    model.set_image_index(emb, quantize=quantize)
    queries = ["tumor tissue", "benign gland", "an H&E image of stroma"]
    got = model.retrieval(queries, top_k=5, backend="device")
    assert model._device_index_key == (id(model.image_vectors), 20000, quantize)
    assert np.array_equal(got, model.retrieval(queries, top_k=5, backend="host"))


# ---------------------------------------------------------------------------
# W8A8 serving (ops.quant): the int8 product on the card, and the quantized
# vision tower's route (chip_smoke.py step 21a at full depth)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,K,N", [(5, 64, 96), (33, 60, 36), (514, 1024, 3072)])
def test_w8a8_linear_on_the_card_equals_the_cpu(dev, M, K, N):
    """The int8 product's int32 sums are exact and the scales are IEEE fp32
    arithmetic: the card's W8A8 linear is bit-equal to the CPU's (rows and
    columns padded to the int8 product's multiples where needed)."""
    from plip_tpu_torch.ops import quant as Q

    w = _randn(K, N, dev="cpu", std=K ** -0.5)
    p = Q.quantize_linear({"kernel": w, "bias": _randn(N, dev="cpu", std=0.1, seed=1)})
    on_card = Q.quantize_linear({"kernel": w.to(dev)})
    for k in ("kernel_q", "wscale"):  # the scales divide on the card, as on the CPU
        assert torch.equal(on_card[k].cpu(), p[k])
    x = _randn(M, K, dev="cpu", seed=2)
    want = Q.linear_w8a8(x, p)
    pd = {k: v.to(dev) for k, v in p.items()}
    assert pd["kernel_q"].stride() == p["kernel_q"].stride() == (1, K)  # column-major
    Q.reset_launch_counts()
    got = Q.linear_w8a8(x.to(dev), pd)
    assert Q.LAUNCHES["int8_mm"] == 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(Q.linear_w8a8(x.to(dev).bfloat16(), pd).cpu(),
                       Q.linear_w8a8(x.bfloat16(), p))


@pytest.mark.parametrize("image_size,core", [(224, "mha_core"), (336, "flash_core")])
@pytest.mark.parametrize("dtype", DTYPES)
def test_w8a8_tower_routes_and_launches(dev, image_size, core, dtype):
    """A two-layer W8A8 ViT-L/14 vision tower (S=257 and 577): K3 or K5 once a
    layer, no K1 sublayer kernel (attn_core, gemm_bias_residual), four int8
    products a layer, every LayerNorm on ln_rows; the embeddings against the
    same model with plain cores and plain LayerNorm: row cosine >= 0.999 in
    bf16, > 0.9999 in fp32. Not allclose 5e-3 in fp32: the cores' fp32 sums
    differ from the plain ones' in the last bits, which flips some
    activation integers, and one flip moves a width-1024 embedding by about
    1e-2 (tests/test_torch_quant.py)."""
    import dataclasses

    from plip_tpu_torch.models import clip as tclip
    from plip_tpu_torch.models import config as tconfig
    from plip_tpu_torch.models import layers as tlayers
    from plip_tpu_torch.ops import quant as Q

    base = tconfig.CLIPConfig.vit_l14()
    cfg = dataclasses.replace(base, vision=dataclasses.replace(
        base.vision, layers=2, image_size=image_size))
    model = tclip.CLIP(cfg).init_params(torch.Generator().manual_seed(0)).to(dev)
    model.requires_grad_(False)
    Q.quantize_block_linears(model.visual.blocks)
    assert all(b.attn["qkv"]["kernel_q"].device.type == "cuda" for b in model.visual.blocks)
    px = _randn(4, image_size, image_size, 3, dev=dev, seed=4)
    for mod in (T, M, Q):
        mod.reset_launch_counts()
    with torch.inference_mode():
        got = model.encode_image(px, dtype)
    torch.cuda.synchronize()
    assert M.LAUNCHES[core] == 2 and Q.LAUNCHES["int8_mm"] == 8
    assert T.LAUNCHES["attn_core"] == 0 and T.LAUNCHES["gemm_bias_residual"] == 0
    assert T.LAUNCHES["ln_rows"] == 2 * 2 + 2  # LN1 and LN2 a layer, ln_pre and ln_post
    with _plain_layer_norm(), mock.patch.multiple(
            tlayers, mha_core=M.mha_core_reference, flash_core=M.flash_core_reference), \
            torch.inference_mode():
        want = model.encode_image(px, dtype)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).min().item()
    assert cos > 0.9999 if dtype == torch.float32 else cos >= 0.999, cos
