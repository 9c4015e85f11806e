"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device. On a GPU machine
(no JAX needed, hence no conftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Bars: fp32 allclose atol 1e-4, rtol 1e-4 (TF32 off); bf16 per-row cosine
>= 0.999 and allclose atol 3e-2, rtol 1e-2 (one bf16 rounding step is 2^-8
of the value)."""

import pytest
import torch

from plip_tpu_torch.ops import attention as T

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
