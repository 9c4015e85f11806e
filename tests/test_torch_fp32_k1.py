"""K1's routes on the CPU: the core routing, the fp32 GEMM's tile plan, and
bf16 at the head widths of ``CLIPConfig.tiny`` against the JAX package.

``ops.attention.core_route`` decides which kernel ``attn_core`` and
``attn_core_bwd`` launch on the card: bf16 at head_dim 64 keeps its wgmma
kernels; bf16 at another head_dim (tiny's vision tower has 16, its text
tower 8) and fp32 take the one-block CUDA-core kernels up to their lengths
(256 tokens forward, 128 backward); past them the key-tiled kernels, which
take every head_dim up to 128 (on CUDA cores where it is not 64 in bf16);
above 128 the route raises, naming the head_dim. ``ops.attention.simt_gemm_plan``
picks the fp32 GEMM's block tile (``csrc/simt_gemm.cuh``): the grid must
cover C exactly and give every SM of an H100 a block at the serving shapes.

The bf16 cores at tiny's head dims are held to the bf16 core bars of PERF.md
section 2 (at most ``DIFFER`` of the elements not bit-equal, every element
within one bf16 ulp of its row's largest value, dqkv within ``BWD_ULPS``)
against the core of the JAX package's K2, ``_core_fwd_bwd_block``, the body
its Pallas kernel runs (its ctx is K1's in either schedule: normalize-first
unpipelined, deferred pipelined; its dqkv is K2's). Both the port's plain
versions and an emulation of the one-block forward kernel's schedule (64
query rows a block, live key tiles only, P rounded before P . v) are held.
The whole bf16 sublayer, forward and backward, runs against K1 and K2 in
Pallas interpret mode at the sublayer bars (leaf cosine >= 0.999).

Inputs are made with numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plip_tpu.ops.attention as A
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


BF16 = torch.bfloat16
DIFFER, CORE_ULPS, BWD_ULPS = 0.005, 1, 2  # the bf16 core bars (PERF.md section 2)
TILE = 64  # query rows a block and keys a tile of the one-block core
HEADS = 4
TINY_HEAD_DIMS = (16, 8)  # CLIPConfig.tiny: vision 64 / 4 heads, text 32 / 4


# ---------------------------------------------------------------------------
# core_route
# ---------------------------------------------------------------------------

ROUTES = (
    # (S, head_dim, dtype, backward, route)
    [(S, 64, BF16, bwd, "wgmma") for S in (1, 50, 77, 128) for bwd in (False, True)]
    + [(S, 64, BF16, bwd, "tiled") for S in (129, 197, 257, 577, 1056) for bwd in (False, True)]
    + [(S, D, BF16, False, "one_block") for S in (1, 5, 16, 50, 77, 128, 129, 197, 256)
       for D in (8, 16, 32, 128)]
    + [(S, D, BF16, True, "one_block") for S in (5, 16, 77, 128) for D in (8, 16, 32)]
    + [(S, D, torch.float32, False, "one_block") for S in (5, 50, 77, 197, 256)
       for D in (8, 16, 64, 128)]
    + [(S, D, torch.float32, True, "one_block") for S in (5, 50, 77, 128) for D in (6, 16, 64)]
    + [(S, 64, torch.float32, bwd, "tiled") for S, bwd in ((257, False), (577, False),
                                                          (129, True), (197, True))]
)


@pytest.mark.parametrize("S,D,dtype,backward,route", ROUTES)
def test_core_route(S, D, dtype, backward, route):
    assert T.core_route(S, D, dtype, backward) == route


@pytest.mark.parametrize("S,D,dtype,backward,route", [
    (257, 129, BF16, False, "tiled"),  # past the one-block kernels' widest head
    (577, 160, torch.float32, False, "tiled"),
    (129, 136, BF16, True, "tiled"),
    (129, 256, torch.float32, True, "tiled"),
    (50, 132, torch.float32, False, "tiled"),  # at a one-block length too
    (50, 192, BF16, False, "tiled"),
])
def test_core_route_raises_naming_head_dim(S, D, dtype, backward, route):
    """A head wider than ONE_BLOCK_MAX_HEAD_DIM raised here, naming its
    head_dim; it now takes the key-tiled kernels at every length."""
    assert D > T.ONE_BLOCK_MAX_HEAD_DIM
    assert T.core_route(S, D, dtype, backward) == route


def test_backward_geometry_check_reports_the_route():
    assert TB._check_bwd_geometry(2 * 16, 16, 32, 4, None, BF16) == "one_block"
    assert TB._check_bwd_geometry(2 * 77, 77, 512, 8, 70, BF16) == "wgmma"
    assert TB._check_bwd_geometry(2 * 197, 197, 768, 12, None, BF16) == "tiled"


@pytest.mark.parametrize("S,D", [(5, 16), (16, 8), (77, 64), (197, 64), (256, 64), (128, 128),
                                 (256, 32), (192, 96), (256, 76)])
def test_one_block_core_fits_shared_memory(S, D):
    """The one-block forward holds the q tile, k, v, P and the row sums in
    fp32 with v beside k: every tower of the config and tiny's fit, 128-wide
    heads up to 128 tokens, 96-wide up to 192, 76-wide up to 256; those
    never put v over k."""
    assert T._core_smem_bytes(S, D) <= T.MAX_SMEM
    assert not T.core_v_over_k(S, D)


def test_one_block_core_refuses_what_does_not_fit():
    """Where k and v side by side pass the card's shared memory (the widest
    heads past 128 tokens), that layout is refused and v goes over k, which
    fits every head_dim the core takes at every length up to ROW_MAX_SEQ."""
    for S, D in ((256, 128), (129, 128), (193, 96), (256, 104)):
        assert T._core_smem_bytes(S, D) > T.MAX_SMEM
        assert T.core_v_over_k(S, D)
    for S in range(1, T.ROW_MAX_SEQ + 1):
        for D in range(4, T.ONE_BLOCK_MAX_HEAD_DIM + 1, 4):
            assert T._core_smem_bytes(S, D, T.core_v_over_k(S, D)) <= T.MAX_SMEM, (S, D)


# ---------------------------------------------------------------------------
# simt_gemm_plan
# ---------------------------------------------------------------------------

# (M, N): ViT-B/32 vision qkv and out-projection at batch 32 and 256, text at
# 8 and 256 prompts, and the MLP's fc1 and fc2 at those rows
SERVING = [(M, N) for M, W in ((1600, 768), (12800, 768), (616, 512), (19712, 512))
           for N in (3 * W, W, 4 * W)]
PLANS = {(1600, 2304): 0, (1600, 768): 1, (12800, 2304): 0, (12800, 768): 0,
         (616, 1536): 2, (616, 512): 3, (19712, 1536): 0, (19712, 512): 0}


def _blocks(M, N, tile):
    bm, bn = T.SIMT_GEMM_TILES[tile]
    return -(-M // bm), -(-N // bn)


@pytest.mark.parametrize("M,N", SERVING + [(37, 24), (200, 136), (777, 1000)])
def test_simt_gemm_plan_covers_c_exactly(M, N):
    """Every element of C lies in exactly one block of the planned grid."""
    tile = T.simt_gemm_plan(M, N)
    bm, bn = T.SIMT_GEMM_TILES[tile]
    gm, gn = _blocks(M, N, tile)
    rows, cols = np.zeros(M, np.int64), np.zeros(N, np.int64)  # blocks a row / column is in
    for by in range(gm):
        rows[by * bm:(by + 1) * bm] += 1
    for bx in range(gn):
        cols[bx * bn:(bx + 1) * bn] += 1
    assert (np.outer(rows, cols) == 1).all()
    assert (gm - 1) * bm < M <= gm * bm and (gn - 1) * bn < N <= gn * bn  # no empty block


@pytest.mark.parametrize("M,N", SERVING)
def test_simt_gemm_plan_fills_the_card(M, N):
    """At the serving shapes the grid has a block for each of the 132 SMs,
    on the largest tile that does."""
    tile = T.simt_gemm_plan(M, N, T.H100_SMS)
    gm, gn = _blocks(M, N, tile)
    assert gm * gn >= T.H100_SMS
    for larger in range(tile):
        bm, bn = _blocks(M, N, larger)
        assert bm * bn < T.H100_SMS
    if (M, N) in PLANS:
        assert tile == PLANS[M, N]


def test_simt_gemm_plan_takes_the_smallest_tile_when_none_fills():
    assert T.simt_gemm_plan(40, 64) == len(T.SIMT_GEMM_TILES) - 1
    assert T.gemm_tile(torch.zeros(1, dtype=BF16), 616, 512) == 0  # bf16: wgmma's tile


# ---------------------------------------------------------------------------
# bf16 at tiny's head dims against the JAX package's K1 / K2
# ---------------------------------------------------------------------------

def _ulp_stats(got, want):
    """(share of the elements that differ, the worst |got - want| in bf16 ulps
    of the largest |want| of its row)."""
    got, want = torch.as_tensor(np.asarray(got, np.float32)), torch.as_tensor(
        np.asarray(want, np.float32))
    d = (got - want).abs()
    _, e = torch.frexp(want.abs().amax(-1, keepdim=True))
    return (d != 0).float().mean().item(), (d / torch.ldexp(torch.ones_like(d), e - 8)).max().item()


def _assert_bar(got, want, ulps_bar, what):
    differ, ulps = _ulp_stats(got, want)
    assert differ <= DIFFER and ulps <= ulps_bar, (what, differ, ulps)


def _qkv(B, S, D, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B * S, 3 * HEADS * D), dtype=np.float32)


def one_block_core(qkv2, S, D, causal, s_valid, defer):
    """The one-block CUDA-core forward's schedule (csrc/attention_sublayer.cu,
    attn_core_simt_kernel): 64 query rows a block against its live keys, the
    exact row max, the fp32 row sum, P rounded to qkv's dtype, P . v in fp32,
    the deferred divide after it; ``[B*S, 3W]`` -> ``[B*S, W]``."""
    B, dt = qkv2.shape[0] // S, qkv2.dtype
    q, k, v = qkv2.view(B, S, 3, HEADS, D).permute(2, 0, 3, 1, 4).float().unbind(0)
    keep = T.keep_mask(S, causal, s_valid, "cpu")
    n_valid = S if s_valid is None else s_valid
    ctx = torch.zeros_like(q)
    for q0 in range(0, S, TILE):
        rows = slice(q0, min(q0 + TILE, S))
        n_keys = min(n_valid, q0 + TILE) if causal else n_valid
        keys = slice(0, n_keys)
        logits = (q[..., rows, :] @ k[..., keys, :].transpose(-1, -2)) * D ** -0.5
        logits = logits.masked_fill(~keep[rows, keys], float("-inf"))
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
        rs = e.sum(-1, keepdim=True)
        p = (e if defer else e / rs).to(dt).float()
        acc = p @ v[..., keys, :]
        ctx[..., rows, :] = acc / rs if defer else acc
    return ctx.to(dt).transpose(1, 2).reshape(B * S, HEADS * D)


def _k2_core(qkv_np, dctx_np, S, D, causal, s_valid, pipeline):
    """The JAX package's K2 core (``_core_fwd_bwd_block``) over the flat
    block of every sequence: (ctx, dqkv) as float32 numpy."""
    M = qkv_np.shape[0]
    ctx, dqkv = A._core_fwd_bwd_block(
        jnp.asarray(qkv_np, jnp.bfloat16), jnp.asarray(dctx_np, jnp.bfloat16),
        A._blockdiag_mask(M, S, causal, s_valid), heads=HEADS, D=D, W=HEADS * D,
        dtype=jnp.bfloat16, pipeline=pipeline)
    return np.asarray(ctx, np.float32), np.asarray(dqkv, np.float32)


CORE_CASES = [pytest.param(S, D, causal, s_valid, defer,
                           id=f"S{S}-D{D}{'c' if causal else ''}-sv{s_valid}-"
                              f"{'defer' if defer else 'norm'}")
              for S in (5, 16) for D in TINY_HEAD_DIMS
              for causal, s_valid in ((False, None), (True, None), (True, S - 2))
              for defer in (False, True)]


@pytest.mark.parametrize("S,D,causal,s_valid,defer", CORE_CASES)
def test_bf16_core_at_tiny_head_dims_matches_k1(S, D, causal, s_valid, defer):
    """attn_core's plain version and the one-block kernel's schedule against
    K1's context (the JAX core in the same schedule) at the core bar."""
    qkv_np = _qkv(2, S, D, seed=S + D + causal)
    qkv = torch.from_numpy(qkv_np).to(BF16)
    want, _ = _k2_core(qkv.float().numpy(), np.zeros((2 * S, HEADS * D), np.float32), S, D,
                       causal, s_valid, pipeline=defer)
    assert T.core_route(S, D, BF16) == "one_block"
    _assert_bar(T.attn_core(qkv, S, HEADS, causal, s_valid, defer).float(), want, CORE_ULPS,
                "attn_core")
    _assert_bar(one_block_core(qkv, S, D, causal, s_valid, defer).float(), want, CORE_ULPS,
                "one-block schedule")


@pytest.mark.parametrize("S,D,causal,s_valid",
                         [(S, D, c, sv) for S in (5, 16) for D in TINY_HEAD_DIMS
                          for c, sv in ((False, None), (True, None), (True, S - 2))])
def test_bf16_core_bwd_at_tiny_head_dims_matches_k2(S, D, causal, s_valid):
    """attn_core_bwd's plain version (the schedule of its CUDA-core kernel,
    which bf16 takes at head_dim != 64) against K2's core: ctx at the core
    bar, dqkv at the backward bar."""
    qkv_np = _qkv(2, S, D, seed=S * D + causal)
    g_np = np.random.default_rng(S + 1).standard_normal((2 * S, HEADS * D), dtype=np.float32)
    qkv, g = torch.from_numpy(qkv_np).to(BF16), torch.from_numpy(g_np).to(BF16)
    want_ctx, want_dqkv = _k2_core(qkv.float().numpy(), g.float().numpy(), S, D, causal,
                                   s_valid, pipeline=True)
    assert T.core_route(S, D, BF16, backward=True) == "one_block"
    ctx, dqkv = TB.attn_core_bwd(qkv, g, S, HEADS, causal, s_valid)
    _assert_bar(ctx.float(), want_ctx, CORE_ULPS, "ctx")
    _assert_bar(dqkv.float(), want_dqkv, BWD_ULPS, "dqkv")


def _sublayer_inputs(S, W, seed):
    rng = np.random.default_rng(seed)
    r = lambda *shape, std=1.0: (rng.standard_normal(shape) * std).astype(np.float32)
    x, g = r(2 * S, W, std=0.5), r(2 * S, W)
    ln = {"scale": 1 + r(W, std=0.1), "bias": r(W, std=0.05)}
    attn = {"qkv": {"kernel": r(W, 3 * W, std=0.2), "bias": r(3 * W, std=0.1)},
            "out": {"kernel": r(W, W, std=0.2), "bias": r(W, std=0.1)}}
    return x, g, ln, attn


def _tree(t):
    return {k: _tree(v) if isinstance(v, dict) else torch.from_numpy(v) for k, v in t.items()}


def _cos(a, b):
    a, b = np.asarray(a, np.float32).ravel(), np.asarray(b, np.float32).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("S,W,causal,s_valid", [(5, 64, False, None), (16, 32, True, None),
                                                (16, 32, True, 13)])
def test_bf16_tiny_sublayer_matches_k1_k2_interpret(S, W, causal, s_valid):
    """The bf16 sublayer at tiny's towers (vision S=5, W=64; text S=16, W=32,
    4 heads) forward and backward against K1 and K2 in Pallas interpret mode:
    the output and every grad leaf at cosine >= 0.999."""
    x, g, ln, attn = _sublayer_inputs(S, W, seed=S + W)
    xt, gt = torch.from_numpy(x).to(BF16), torch.from_numpy(g).to(BF16)
    got = T.attention_sublayer(xt, _tree(ln), _tree(attn), HEADS, causal, s_valid, S=S)
    want = A._pallas_attn_sublayer_flat(jnp.asarray(x, jnp.bfloat16), ln, attn, S, HEADS,
                                        causal, 1e-5, block_b=1, interpret=True,
                                        s_valid=s_valid)
    assert _cos(got.float().numpy(), want) >= 0.999
    dx, dln, dattn = TB.attention_sublayer_bwd(xt, gt, _tree(ln), _tree(attn), S, HEADS,
                                               causal, s_valid, 1e-5)
    jx, jdln, jdattn = A._pallas_attn_sublayer_bwd_flat(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16), ln, attn, S, HEADS,
        causal, 1e-5, interpret=True, s_valid=s_valid)
    pairs = [(dx, jx), (dln["scale"], jdln["scale"]), (dln["bias"], jdln["bias"]),
             (dattn["qkv"]["kernel"], jdattn["qkv"]["kernel"]),
             (dattn["qkv"]["bias"], jdattn["qkv"]["bias"]),
             (dattn["out"]["kernel"], jdattn["out"]["kernel"]),
             (dattn["out"]["bias"], jdattn["out"]["bias"])]
    for i, (a, b) in enumerate(pairs):
        assert _cos(a.float().numpy(), b) >= 0.999, i
