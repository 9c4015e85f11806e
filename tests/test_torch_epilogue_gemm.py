"""The epilogue GEMMs' accumulation order on Hopper, emulated in plain PyTorch
on the CPU, against the port's plain versions.

``csrc/gemm.cuh`` runs ``gemm_bias_residual``, ``gemm_bias_gelu``,
``gemm_bias_gelu_f32`` (NN) and ``gemm_nt_gelu_bwd`` (NT) in bf16 on the
``wgmma`` main loop of ``csrc/wgmma_gemm.cuh``: a 128 x 128 tile a block, a
fresh fp32 accumulator a tile, the whole K range in 64-deep stages of four
16-deep ``wgmma`` k-steps (zero past K), no K slices; then each epilogue at
the TPU kernels' rounding points (``h1 = cast(acc + bias)``; QuickGELU in
fp32 on the cast h1, or on the fp32 sum for K10; ``dh1 = cast(acc *
dgelu(h))``; ``cast(acc + bias)`` then ``+ R`` in the compute dtype). Only
the fp32 summation order differs from the plain versions, whose fp32 sum is
one ``addmm`` over all of K. So the emulated results must meet the bf16 bars
the card holds the kernels to (PERF.md section 2): h1, dh1, K10's activation
and the residual GEMM's cast sum within one bf16 ulp of the row's largest
value, the activation of the cast h1 within ``ACT_ULPS``, at most
``DIFFER`` of the elements not bit-equal; the residual GEMM with R at the
step-2 bars (row cosine >= 0.999, allclose atol 3e-2, rtol 1e-2). The
composed forward's bf16 QuickGELU of the same h1 is the control: it must
fail the activation's bar.

Inputs are made with numpy from a seed. The emulation repeats the kernel's
order of work (stages and k-steps into one accumulator), not the tensor
cores' order inside a 16-deep k-step. An element's sum does not depend on
its tile, so the emulation takes every tile at once.
"""

import numpy as np
import pytest
import torch

from plip_tpu_torch.ops import attention as T
from plip_tpu_torch.ops import mlp as TM


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STAGE, KSTEP = 64, 16  # the main loop's K stage and wgmma's k-step
DIFFER = 0.005
ACT_ULPS = 2
BF16 = torch.bfloat16
# (M, K, N): small ragged shapes (M not a multiple of 128, N a multiple of 8
# but not of 64, K not of 64; K = 40 a single, partly zero-filled stage), and
# the ViT-B/32 MLP widths (W = 768, 4W = 3072) with M cut from 6,400 rows
RAGGED = [(37, 40, 24), (200, 72, 136), (130, 520, 1000)]
B32_FC1 = (256, 768, 3072)  # fc1 (NN) and the NT product dh1 = g . W2^T
B32_FC2 = (256, 3072, 768)  # fc2 with its residual: the longest sum


def _randn(*shape, seed, std=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))


def _case(M, K, N, seed=0):
    """bf16 a [M, K], w [K, N], fp32 bias [N]."""
    return (_randn(M, K, seed=seed).to(BF16), _randn(K, N, seed=seed + 1, std=K ** -0.5).to(BF16),
            _randn(N, seed=seed + 2, std=0.1))


def wgmma_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 ``a . b`` (``b`` as ``[K, N]``) in the kernel's order: one fp32
    accumulator, 64-deep stages, each four 16-deep k-steps added in turn."""
    a32, b32 = a.float(), b.float()
    K = a32.shape[1]
    acc = torch.zeros(a32.shape[0], b32.shape[1])
    for k0 in range(0, K, STAGE):
        for k in range(k0, min(k0 + STAGE, K), KSTEP):
            acc += a32[:, k:k + KSTEP] @ b32[k:k + KSTEP]
    return acc


def _gelu(h32):
    return h32 * torch.sigmoid(1.702 * h32)


# the four epilogues on the emulated sum, at the TPU kernels' rounding points
def bias_residual(a, w, bias, r=None):
    y = (wgmma_sum(a, w) + bias).to(a.dtype)
    return y if r is None else r + y


def bias_gelu(a, w, bias):
    h1 = (wgmma_sum(a, w) + bias).to(a.dtype)
    return h1, _gelu(h1.float()).to(a.dtype)


def bias_gelu_f32(a, w, bias):
    return _gelu(wgmma_sum(a, w) + bias).to(a.dtype)


def gelu_bwd(g, wt, h):
    """NT: fc2's weight ``wt [N, K]``, read K-major."""
    h32 = h.float()
    s = torch.sigmoid(1.702 * h32)
    return (wgmma_sum(g, wt.t()) * (s + 1.702 * h32 * s * (1.0 - s))).to(g.dtype)


def _ulp_stats(got, want):
    """(share of the elements that differ, the worst |got - want| in bf16 ulps
    of the largest |want| of its row)."""
    d = (got.float() - want.float()).abs()
    _, e = torch.frexp(want.float().abs().amax(-1, keepdim=True))
    return (d != 0).float().mean().item(), (d / torch.ldexp(torch.ones_like(d), e - 8)).max().item()


def _assert_core(got, want, ulps=1):
    differ, worst = _ulp_stats(got, want)
    assert differ <= DIFFER and worst <= ulps, (differ, worst)


def _assert_step2(got, want):
    got, want = got.float(), want.float()
    assert torch.nn.functional.cosine_similarity(got, want, dim=-1).min().item() >= 0.999
    torch.testing.assert_close(got, want, atol=3e-2, rtol=1e-2)


def test_emulated_sum_is_the_product():
    """The emulation's fp32 sum is the product to fp32 rounding; K = 40 and
    520 leave a partial stage and a partial k-step."""
    for M, K, N in RAGGED:
        a, w, _ = _case(M, K, N)
        want = a.double() @ w.double()
        torch.testing.assert_close(wgmma_sum(a, w).double(), want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("M,K,N", RAGGED + [B32_FC1])
def test_gemm_bias_gelu_order_meets_the_bars(M, K, N):
    a, w, bias = _case(M, K, N, seed=1)
    h1, act = bias_gelu(a, w, bias)
    want_h1, want_act = TM.gemm_bias_gelu_reference(a, w, bias)
    _assert_core(h1, want_h1)
    _assert_core(act, want_act, ACT_ULPS)


@pytest.mark.parametrize("M,K,N", RAGGED + [B32_FC1])
def test_gemm_bias_gelu_f32_order_meets_the_bars(M, K, N):
    a, w, bias = _case(M, K, N, seed=2)
    _assert_core(bias_gelu_f32(a, w, bias), TM.gemm_bias_gelu_f32_reference(a, w, bias))


@pytest.mark.parametrize("M,K,N", RAGGED + [B32_FC1])
def test_gemm_nt_gelu_bwd_order_meets_the_bars(M, K, N):
    g = _randn(M, K, seed=3).to(BF16)
    wt = _randn(N, K, seed=4, std=N ** -0.5).to(BF16)
    h = _randn(M, N, seed=5, std=2.0).to(BF16)
    _assert_core(gelu_bwd(g, wt, h), TM.gemm_nt_gelu_bwd_reference(g, wt, h))


@pytest.mark.parametrize("M,K,N", RAGGED + [B32_FC1, B32_FC2])
@pytest.mark.parametrize("residual", [False, True])
def test_gemm_bias_residual_order_meets_the_bars(M, K, N, residual):
    a, w, bias = _case(M, K, N, seed=6)
    r = _randn(M, N, seed=9).to(BF16) if residual else None
    got, want = bias_residual(a, w, bias, r), T.gemm_bias_residual_reference(a, w, bias, r)
    _assert_step2(got, want)
    if not residual:  # the cast sum alone: h1's bar
        _assert_core(got, want)


@pytest.mark.parametrize("M,K,N", [(200, 72, 136), B32_FC1])
def test_bf16_quick_gelu_fails_the_activation_bar(M, K, N):
    """Control: the composed forward's bf16 QuickGELU of the emulated h1."""
    a, w, bias = _case(M, K, N, seed=1)
    h1, _ = bias_gelu(a, w, bias)
    differ, worst = _ulp_stats(TM.quick_gelu(h1), TM.gemm_bias_gelu_reference(a, w, bias)[1])
    assert differ > DIFFER or worst > ACT_ULPS, (differ, worst)
