"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device. On a GPU machine
(no JAX needed, hence no conftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Bars: fp32 allclose atol 1e-4, rtol 1e-4 (TF32 off); bf16 per-row cosine
>= 0.999 and allclose atol 3e-2, rtol 1e-2 (one bf16 rounding step is 2^-8
of the value). For a grad whose elements sum the B*S token rows (weights,
biases, LN parameters) the atol is scaled by the leaf's RMS."""

import pytest
import torch

from plip_tpu_torch.ops import attention as T
from plip_tpu_torch.ops import attention_bwd as TB

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
])
def test_attn_core(dev, dtype, B, S, heads, D, causal, s_valid):
    qkv = _randn(B * S, 3 * heads * D, dev=dev).to(dtype)
    T.reset_launch_counts()
    got = T.attn_core(qkv, S, heads, causal, s_valid)
    assert T.LAUNCHES["attn_core"] == 1
    _assert_close(got, T.attn_core_reference(qkv, S, heads, causal, s_valid), dtype)


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
    with pytest.raises(ValueError, match="S <= 128"):
        T.attn_core(torch.zeros(258, 96, device=dev), 129, 2)
    with pytest.raises(ValueError, match="dtype"):
        T.gemm_bias_residual(x, torch.zeros(64, 8, device=dev, dtype=torch.bfloat16),
                             torch.zeros(8, device=dev))


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
    """dW = a^T . b over K token rows, in slices of at most K_SLICE rows; in
    fp32 its error against a float64 product is at most twice the plain
    fp32 product's (plus 1e-6 of the leaf's scale)."""
    a = _randn(K, M, dev=dev).to(dtype)
    b = _randn(K, N, dev=dev, seed=1).to(dtype)
    TB.reset_launch_counts()
    got = TB.grad_gemm_tn(a, b)
    slices = -(-K // TB.K_SLICE)
    assert TB.LAUNCHES == {"grad_gemm": 1, "attn_core_bwd": 0, "ln_bwd_rows": 0,
                           "col_sum": int(slices > 1)}
    want = TB.grad_gemm_tn_reference(a, b)
    _assert_sum_close(got, want, dtype)
    if dtype == torch.float32:
        exact = a.double().t() @ b.double()
        scale = exact.square().mean().sqrt().item()
        err = (got - exact).abs().max().item()
        assert err <= 2 * (want - exact).abs().max().item() + 1e-6 * scale, err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,heads,D,causal,s_valid", [
    (2, 1, 2, 16, False, None),
    (3, 33, 4, 32, True, 30),
    (32, 50, 12, 64, False, None),
    (32, 77, 8, 64, True, None),
    (32, 77, 8, 64, True, 70),
    (4, 128, 2, 64, True, 100),
])
def test_attn_core_bwd(dev, dtype, B, S, heads, D, causal, s_valid):
    qkv = _randn(B * S, 3 * heads * D, dev=dev).to(dtype)
    dctx = _randn(B * S, heads * D, dev=dev, seed=1).to(dtype)
    TB.reset_launch_counts()
    ctx, dqkv = TB.attn_core_bwd(qkv, dctx, S, heads, causal, s_valid)
    assert TB.LAUNCHES["attn_core_bwd"] == 1
    want_ctx, want_dqkv = TB.attn_core_bwd_reference(qkv, dctx, S, heads, causal, s_valid)
    _assert_close(ctx, want_ctx, dtype)
    _assert_close(dqkv, want_dqkv, dtype)


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
@pytest.mark.parametrize("rows,cols", [(1, 5), (1600, 2304), (9856, 512), (3, 1769472)])
def test_col_sum(dev, dtype, rows, cols):
    t = _randn(rows, cols, dev=dev).to(dtype)
    TB.reset_launch_counts()
    got = TB.col_sum(t)
    assert TB.LAUNCHES["col_sum"] == 1 and got.dtype == torch.float32
    _assert_sum_close(got, TB.col_sum_reference(t), torch.float32)


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
    from unittest import mock

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
    with mock.patch.object(tlayers, "attention_sublayer", T.attention_sublayer_reference):
        loss_ref, want = grads()
    assert loss == pytest.approx(loss_ref, rel=1e-5 if dtype == torch.float32 else 1e-2)
    bar = 0.9999 if dtype == torch.float32 else 0.995
    for k, w in want.items():
        assert got[k] is not None, k
        cos = torch.nn.functional.cosine_similarity(got[k].flatten(), w.flatten(), 0)
        assert cos.item() >= bar, (k, cos.item())
