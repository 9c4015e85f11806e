"""The attention cores at every head_dim, and K2's fp32 kernels on CUDA
cores, on the CPU.

- ``ops.attention.core_route`` past the one-block lengths (S = 129, 257,
  577): every head_dim from 1 to 128 takes the key-tiled kernels in both
  dtypes, forward and backward (on ``wgmma`` in bf16 at 64, on CUDA cores
  otherwise), and a wider head (129 to 512) takes them at every length.
- The fp32 products' K slices (``f32_slice_rows``, NT and TN alike):
  pinned at the ViT-B/32 and ViT-L/14 training shapes, whole 8-deep K
  steps, and the fewest slices whose 128 x 128 blocks fill their waves
  over the card (two blocks an SM) within 5% of the best count's fill.
- ``grad_gemm``'s fp32 sum order on ``csrc/simt_gemm.cuh``: each output a
  sequential FMA chain over its slice's token rows (the 8-deep K steps
  share one accumulator), the slices added in ``col_sum``'s fixed order.
  Emulated, it must meet the fp32 bar against ``grad_gemm_*_reference``
  (allclose 1e-4, of its RMS for a sum over token rows) and be no further
  from the exact product than twice the plain fp32 product is.
- The one-block core backward on CUDA cores (``attn_core_bwd_simt_kernel``
  in ``csrc/attention_sublayer_bwd.cu``): the logits and dp as FMA chains
  over d, the row statistics as each of a row's 16 threads' sums over its
  keys in order followed by a 16-lane butterfly, ctx and dq as FMA chains
  over the keys, dk and dv over the rows; every divide by denom a multiply
  by the row's fp32 reciprocal; e_c, ds_u, q / denom and g / denom rounded
  to the compute dtype. Emulated, it must meet the fp32 bar (allclose 1e-4)
  and in bf16 the cores' backward bars (PERF.md section 2) against
  ``attn_core_bwd_reference``.
- The plain versions of the repaired modules at head_dim 80 and 32 past 128
  tokens against the JAX package: K3 and K4 (``mha_core``,
  ``mha_core_bwd``) against ``_pallas_mha`` / ``_pallas_mha_bwd`` in Pallas
  interpret mode, K2's core (``attn_core_bwd``) against
  ``_core_fwd_bwd_block``, K7 (``block_bwd``) against
  ``_pallas_block_bwd_flat`` in interpret mode: fp32 cosine > 0.9999 plus
  allclose 5e-3.

Inputs are made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plip_tpu.ops.attention as A
import plip_tpu.ops.block_bwd as JB
import test_torch_col_sum as CSUM
from plip_tpu_torch.ops import attention as T
from plip_tpu_torch.ops import attention_bwd as TB
from plip_tpu_torch.ops import block_bwd as TBB
from plip_tpu_torch.ops import mha as M


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BF16 = torch.bfloat16
DIFFER, CORE_ULPS, BWD_ULPS = 0.005, 1, 2  # the bf16 core bars (PERF.md section 2)


# ---------------------------------------------------------------------------
# core_route past the one-block lengths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("S", [129, 257, 577])
def test_core_route_takes_every_head_dim(S, dtype, backward):
    """Past 128 tokens every head_dim has a kernel: the key-tiled ones,
    except the forward's one-block core up to 256 tokens at a multiple of 4
    up to ONE_BLOCK_MAX_HEAD_DIM (bf16 at 64 excepted: wgmma's key-tiled
    kernel); every wider head (129 to 512) the key-tiled ones at every
    length, one-block lengths included."""
    for D in range(1, T.ONE_BLOCK_MAX_HEAD_DIM + 1):
        one_block = (not backward and S <= T.ROW_MAX_SEQ and D % 4 == 0
                     and not (dtype == BF16 and D == T.TILED_HEAD_DIM))
        assert T.core_route(S, D, dtype, backward) == ("one_block" if one_block
                                                       else "tiled"), D
    for D in range(T.ONE_BLOCK_MAX_HEAD_DIM + 1, 513):
        for s in (1, 50, 77, 128, S):
            assert T.core_route(s, D, dtype, backward) == "tiled", (s, D)


def test_forward_takes_the_key_tiled_kernel_where_the_one_block_core_cannot():
    """The one-block forward loads 4-column groups: a head_dim that is not a
    multiple of 4 takes the key-tiled kernel at any length; the one-block
    backward takes every head_dim."""
    for D in (1, 2, 3, 5, 6, 10, 22, 127):
        assert T.core_route(50, D, torch.float32) == "tiled"
        assert T.core_route(50, D, BF16) == "tiled"
        assert T.core_route(50, D, torch.float32, backward=True) == "one_block"
    assert T.core_route(50, 80, torch.float32) == "one_block"
    assert T.core_route(77, 104, BF16, backward=True) == "one_block"


# ---------------------------------------------------------------------------
# The fp32 TN products' slices
# ---------------------------------------------------------------------------

# (M, N, K) -> (rows a slice, slices): at ViT-B/32 batch 128, vision (6,400
# token rows) and text (9,856), dWout and dWqkv (TN), dctx and dln (NT); at
# ViT-L/14 vision batch 64 (16,448 rows) dWout and dln
FP32_PLANS = {(768, 768, 6400): (920, 7), (768, 2304, 6400): (920, 7),
              (6400, 768, 768): (160, 5), (6400, 768, 2304): (464, 5),
              (512, 512, 9856): (616, 16), (512, 1536, 9856): (896, 11),
              (9856, 512, 512): (128, 4), (9856, 512, 1536): (312, 5),
              (1024, 1024, 16448): (4112, 4), (16448, 1024, 3072): (3072, 1)}


@pytest.mark.parametrize("M,N,K", list(FP32_PLANS))
def test_fp32_slices_are_planned(M, N, K):
    rows, n = FP32_PLANS[M, N, K]
    assert TB.f32_slice_rows(M, N, K) == rows == TB.tn_slice_rows(M, N, K, torch.float32)
    slices = TB.tn_slices(M, N, K, torch.float32)
    assert len(slices) == n and rows % TB.SIMT_K_STEP == 0 and rows >= TB.SIMT_MIN_SLICE
    # no count it may take (slices of SIMT_MIN_SLICE rows or more, at most
    # SIMT_MAX_SLICES) fills the waves more than 1 / 0.95 as well
    tiles = -(-M // 128) * -(-N // 128)
    slots = TB.SIMT_BLOCKS_PER_SM * TB.H100_SMS

    def fill(k):
        return tiles * k / (slots * -(-tiles * k // slots))

    best = max(fill(k) for k in range(1, min(TB.SIMT_MAX_SLICES, K // TB.SIMT_MIN_SLICE) + 1))
    assert fill(n) >= TB.SIMT_FILL_SLACK * best
    assert all(fill(k) < TB.SIMT_FILL_SLACK * best for k in range(1, n))


@pytest.mark.parametrize("M,N,K", [(37, 40, 24), (40, 24, 255), (3000, 3000, 200)])
def test_short_fp32_sums_take_one_slice(M, N, K):
    """Fewer than two SIMT_MIN_SLICE runs of token rows, or a grid that fills
    the card alone, take one slice (no col_sum)."""
    assert TB.tn_slices(M, N, K, torch.float32) == [(0, K)]


# ---------------------------------------------------------------------------
# grad_gemm's fp32 sum order
# ---------------------------------------------------------------------------

def _fma_chain(a, b):
    """``a [K, M]^T . b [K, N]`` as fp32 FMA chains over K in order (each
    product exact, one rounding a step)."""
    acc = np.zeros((a.shape[1], b.shape[1]), np.float32)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    for k in range(a.shape[0]):
        acc = (np.outer(a64[k], b64[k]) + acc).astype(np.float32)
    return acc


def emulated_grad_gemm(a: np.ndarray, b: np.ndarray) -> torch.Tensor:
    """``a [K, M]^T . b [K, N]`` in the fp32 kernel's order (either layout:
    NT's ``a [M, K] . b [N, K]^T`` is this of the transposes): a chain a
    slice, the slices added by col_sum's plan."""
    K, M = a.shape
    N = b.shape[1]
    slices = TB.tn_slices(M, N, K, torch.float32)
    parts = torch.from_numpy(np.stack([_fma_chain(a[s:e], b[s:e]) for s, e in slices]))
    if len(slices) == 1:
        return parts[0]
    flat = parts.view(len(slices), M * N)
    return CSUM.emulated_col_sum(flat, TB.col_sum_plan(len(slices), M * N, 4)).view(M, N)


@pytest.mark.parametrize("K,M,N", [(2000, 48, 40), (900, 64, 36), (37, 40, 24)])
def test_fp32_grad_gemm_tn_order_meets_the_bar(K, M, N):
    rng = np.random.default_rng(K)
    a = rng.standard_normal((K, M), dtype=np.float32)
    b = rng.standard_normal((K, N), dtype=np.float32)
    got = emulated_grad_gemm(a, b)
    want = TB.grad_gemm_tn_reference(torch.from_numpy(a), torch.from_numpy(b))
    rms = want.square().mean().sqrt().item()
    torch.testing.assert_close(got, want, atol=1e-4 * rms, rtol=1e-4)
    exact = torch.from_numpy(a.astype(np.float64).T @ b.astype(np.float64))
    err = (got.double() - exact).abs().max().item()
    assert err <= 2 * (want.double() - exact).abs().max().item() + 1e-6 * rms, err


@pytest.mark.parametrize("M,K,N", [(40, 300, 24), (37, 77, 41), (48, 1500, 40)])
def test_fp32_grad_gemm_nt_order_meets_the_bar(M, K, N):
    rng = np.random.default_rng(M + K)
    a = rng.standard_normal((M, K), dtype=np.float32)
    b = (rng.standard_normal((N, K)) * K ** -0.5).astype(np.float32)
    got = emulated_grad_gemm(a.T.copy(), b.T.copy())
    want = TB.grad_gemm_nt_reference(torch.from_numpy(a), torch.from_numpy(b), torch.float32)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# The one-block core backward's order
# ---------------------------------------------------------------------------

def _fma(acc, x, y):
    return (acc.double() + x.double() * y.double()).float()


def _round(x, dt):
    return x.to(dt).float()


def emulated_core_bwd(qkv2, dctx2, S, heads, causal=False, s_valid=None):
    """``attn_core_bwd_simt_kernel``'s sums, in its order (the module doc):
    ``[B*S, 3W]`` and ``[B*S, W]`` -> (ctx, dqkv) in qkv's dtype."""
    N, W3 = qkv2.shape
    W = W3 // 3
    D, B, dt = W // heads, N // S, qkv2.dtype
    scale = torch.tensor(D ** -0.5, dtype=torch.float32)
    q, k, v = qkv2.view(B, S, 3, heads, D).permute(2, 0, 3, 1, 4).float().unbind(0)
    g = dctx2.view(B, S, heads, D).transpose(1, 2).float()
    keep = T.keep_mask(S, causal, s_valid, "cpu")
    logits = torch.zeros(B, heads, S, S)
    dp = torch.zeros(B, heads, S, S)
    for d in range(D):
        logits = _fma(logits, q[..., :, d, None], k[..., None, :, d])
        dp = _fma(dp, g[..., :, d, None], v[..., None, :, d])
    logits = torch.where(keep, logits * scale, torch.tensor(float("-inf")))
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    # a row's 16 threads: thread tx sums keys tx, tx + 16, ... in order, then
    # the butterfly over xor 8, 4, 2, 1
    nk = -(-S // 16) * 16
    pad = lambda t: torch.nn.functional.pad(t, (0, nk - S)).view(B, heads, S, nk // 16, 16)
    lanes = torch.zeros(B, heads, S, 16)
    dlanes = torch.zeros(B, heads, S, 16)
    ep, dpe = pad(e), pad(dp * e)
    for c in range(nk // 16):
        lanes = lanes + ep[..., c, :]
        dlanes = dlanes + dpe[..., c, :]
    idx = torch.arange(16)
    for o in (8, 4, 2, 1):
        lanes = lanes + lanes[..., idx ^ o]
        dlanes = dlanes + dlanes[..., idx ^ o]
    denom, dsum = lanes[..., :1], dlanes[..., :1]
    inv = 1 / denom
    e_c = _round(e, dt)
    ds = torch.where(e == 0, torch.zeros(()), _round(e * (dp - dsum / denom), dt))
    qn, gn = _round(q * inv, dt), _round(g * inv, dt)
    ctx = torch.zeros(B, heads, S, D)
    dq = torch.zeros(B, heads, S, D)
    dk = torch.zeros(B, heads, S, D)
    dv = torch.zeros(B, heads, S, D)
    for j in range(S):
        ctx = _fma(ctx, e_c[..., :, j, None], v[..., None, j, :])
        dq = _fma(dq, ds[..., :, j, None], k[..., None, j, :])
    for r in range(S):
        dv = _fma(dv, e_c[..., r, :, None], gn[..., None, r, :])
        dk = _fma(dk, ds[..., r, :, None], qn[..., None, r, :])
    ctx, dq = (ctx * inv).to(dt), (dq * scale * inv).to(dt)
    dqkv = torch.stack([dq, (dk * scale).to(dt), dv.to(dt)], 2)
    return (ctx.transpose(1, 2).reshape(N, W), dqkv.permute(0, 3, 2, 1, 4).reshape(N, W3))


def _ulp_stats(got, want):
    d = (got.float() - want.float()).abs()
    _, e = torch.frexp(want.float().abs().amax(-1, keepdim=True))
    return (d != 0).float().mean().item(), (d / torch.ldexp(torch.ones_like(d), e - 8)).max().item()


CORE_BWD_CASES = [(1, 2, 16, False, None), (5, 3, 80, True, None), (50, 2, 64, False, None),
                  (50, 2, 80, False, 45), (77, 2, 64, True, None), (77, 2, 32, True, 70),
                  (77, 1, 104, False, None), (128, 1, 36, True, 100), (33, 2, 10, False, 30)]


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("S,heads,D,causal,s_valid", CORE_BWD_CASES)
def test_core_bwd_order_meets_the_bars(S, heads, D, causal, s_valid, dtype):
    rng = np.random.default_rng(S + D)
    qkv = torch.from_numpy(rng.standard_normal((2 * S, 3 * heads * D), dtype=np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal((2 * S, heads * D), dtype=np.float32)).to(dtype)
    assert T.core_route(S, D, dtype, backward=True) == ("wgmma" if dtype == BF16 and D == 64
                                                        else "one_block")
    ctx, dqkv = emulated_core_bwd(qkv, g, S, heads, causal, s_valid)
    want_ctx, want_dqkv = TB.attn_core_bwd_reference(qkv, g, S, heads, causal, s_valid)
    if dtype == torch.float32:
        torch.testing.assert_close(ctx, want_ctx, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(dqkv, want_dqkv, atol=1e-4, rtol=1e-4)
        return
    for got, want, ulps in ((ctx, want_ctx, CORE_ULPS), (dqkv, want_dqkv, BWD_ULPS)):
        differ, worst = _ulp_stats(got, want)
        assert differ <= DIFFER and worst <= ulps, (differ, worst)


# ---------------------------------------------------------------------------
# The repaired modules at head_dim 80 and 32 against the JAX package
# ---------------------------------------------------------------------------

def _assert_parity(got, want):
    """fp32 cosine > 0.9999 plus allclose 5e-3."""
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    cos = float(got.ravel() @ want.ravel() / (np.linalg.norm(got) * np.linalg.norm(want)))
    assert cos > 0.9999, cos
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=5e-3)


WIDE = [pytest.param(D, causal, s_valid, id=f"D{D}{'-causal' if causal else ''}-sv{s_valid}")
        for D in (80, 32) for causal, s_valid in ((False, None), (True, 131))]
S_WIDE, HEADS = 136, 2


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("D,causal,s_valid", WIDE)
def test_mha_core_and_bwd_match_k3_k4(D, causal, s_valid):
    S, W = S_WIDE, HEADS * D
    qkv, g = _rand((2, S, 3 * W), D + causal), _rand((2, S, W), D + 7)
    want = A._pallas_mha(jnp.asarray(qkv), HEADS, causal, interpret=True, s_valid=s_valid)
    _assert_parity(M.mha_core(torch.from_numpy(qkv), S, HEADS, causal, s_valid), want)
    want = A._pallas_mha_bwd(jnp.asarray(qkv), jnp.asarray(g), HEADS, causal, interpret=True,
                             s_valid=s_valid)
    got = M.mha_core_bwd(torch.from_numpy(qkv), torch.from_numpy(g), S, HEADS, causal, s_valid)
    _assert_parity(got, want)


@pytest.mark.parametrize("D,causal,s_valid", WIDE)
def test_attn_core_bwd_matches_k2_core(D, causal, s_valid):
    S, W = S_WIDE, HEADS * D
    qkv, g = _rand((2 * S, 3 * W), D + 1), _rand((2 * S, W), D + 2)
    assert T.core_route(S, D, torch.float32, backward=True) == "tiled"
    ctx, dqkv = A._core_fwd_bwd_block(jnp.asarray(qkv), jnp.asarray(g),
                                      A._blockdiag_mask(2 * S, S, causal, s_valid), heads=HEADS,
                                      D=D, W=W, dtype=jnp.float32, pipeline=True)
    got_ctx, got_dqkv = TB.attn_core_bwd(torch.from_numpy(qkv), torch.from_numpy(g), S, HEADS,
                                         causal, s_valid)
    _assert_parity(got_ctx, ctx)
    _assert_parity(got_dqkv, dqkv)


def _block_params(W, seed):
    rng = np.random.default_rng(seed)

    def r(*shape, std=1.0, mean=0.0):
        return (mean + rng.standard_normal(shape) * std).astype(np.float32)

    return {"ln1": {"scale": r(W, std=0.1, mean=1.0), "bias": r(W, std=0.05)},
            "attn": {"qkv": {"kernel": r(W, 3 * W, std=W ** -0.5), "bias": r(3 * W, std=0.1)},
                     "out": {"kernel": r(W, W, std=W ** -0.5), "bias": r(W, std=0.1)}},
            "ln2": {"scale": r(W, std=0.1, mean=1.0), "bias": r(W, std=0.05)},
            "mlp": {"fc1": {"kernel": r(W, 4 * W, std=W ** -0.5), "bias": r(4 * W, std=0.1)},
                    "fc2": {"kernel": r(4 * W, W, std=(4 * W) ** -0.5),
                            "bias": r(W, std=0.1)}}}


@pytest.mark.parametrize("D,causal", [(80, False), (32, True)])
def test_block_bwd_matches_k7(D, causal):
    S, W = S_WIDE, HEADS * D
    x, g = _rand((2 * S, W), D), _rand((2 * S, W), D + 1)
    p = _block_params(W, seed=D)
    jdx, jdp = JB._pallas_block_bwd_flat(jnp.asarray(x), jnp.asarray(g), p, S, HEADS, causal,
                                         1e-5, interpret=True)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), p)
    dx, dp = TBB.block_bwd(torch.from_numpy(x), torch.from_numpy(g), tp, S, HEADS, causal)
    _assert_parity(dx, jdx)
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(jdp), jax.tree.leaves(dp)):
        try:
            _assert_parity(got, want)
        except AssertionError as e:
            raise AssertionError(f"{jax.tree_util.keystr(path)}: {e}") from None
