"""K1's attention core at S <= 256 and K2's TN split, as the bf16 Hopper
kernels schedule them, emulated in plain PyTorch on the CPU.

Up to 128 tokens ``csrc/attention_sublayer.cu``'s bf16 core takes a 64-row q
tile of one (sequence, head) against every live key tile of the head at
once: one q . k^T, the exact fp32 row max and row sum from those logits, P
cast to bf16 per key tile (normalize-first ``cast(e / sum)`` or deferred
``cast(e)``), P . v summed in fp32 over the key tiles in order, the deferred
divide after it, one cast. Key tiles wholly above the diagonal (causal) or
at or past ``s_valid`` are neither loaded nor used. Past 128 tokens
``attn_core`` takes the key-tiled kernel of ``csrc/mha.cu``, whose two
passes ``tests/test_torch_core_schedule.py`` emulates. Either only reorders
fp32 sums, so it must meet the bf16 core bars of PERF.md section 2 against
``attn_core_reference`` in both schedules: at most ``DIFFER`` of the
elements not bit-equal, every element within one bf16 ulp of its row's
largest value. One small case also runs the emulated core inside K1's chain
against the TPU kernel itself in Pallas interpret mode.

``ops.attention_bwd.tn_slice_rows`` plans the slices of the bf16 TN products
(``dW = a^T . b`` over the token rows): they cover K exactly, each starts on
a K step of the wgmma kernel, fp32 keeps ``K_SLICE``, and the slices' fp32
sums added in order (``col_sum``) meet the bf16 bar against
``grad_gemm_tn_reference``.

Inputs are made with numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plip_tpu.ops.attention as A
import test_torch_core_schedule as CS
from plip_tpu_torch.ops import attention as T
from plip_tpu_torch.ops import attention_bwd as TB

TILE = 64  # query rows a block, keys a tile, as the kernel
HEADS, D = 2, 64
DIFFER, CORE_ULPS = 0.005, 1  # the bf16 core bars (PERF.md section 2)
BF16 = torch.bfloat16


def _qkv(B, S, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((B * S, 3 * HEADS * D),
                                                dtype=np.float32)).to(BF16)


def _ulp_stats(got, want):
    """(share of the elements that differ, the worst |got - want| in bf16 ulps
    of the largest |want| of its row)."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    _, e = torch.frexp(want.abs().amax(-1, keepdim=True))
    return (d != 0).float().mean().item(), (d / torch.ldexp(torch.ones_like(d), e - 8)).max().item()


def one_block_core(qkv2, S, causal, s_valid, defer, skip_dead=True):
    """The bf16 one-block kernel's schedule (S <= 128): ``[B*S, 3W]`` ->
    ``[B*S, W]``."""
    assert S <= T.BF16_ROW_MAX_SEQ
    B = qkv2.shape[0] // S
    q, k, v = qkv2.view(B, S, 3, HEADS, D).permute(2, 0, 3, 1, 4).float().unbind(0)
    keep = T.keep_mask(S, causal, s_valid, "cpu")
    n_valid = S if s_valid is None else s_valid
    ctx = torch.zeros_like(q)
    for q0 in range(0, S, TILE):
        rows = slice(q0, min(q0 + TILE, S))
        n_keys = min(n_valid, q0 + TILE) if causal else n_valid
        live = -(-n_keys // TILE) if skip_dead else -(-S // TILE)
        cols = slice(0, min(S, live * TILE))
        logits = (q[..., rows, :] @ k[..., cols, :].transpose(-1, -2)) * D ** -0.5
        logits = logits.masked_fill(~keep[rows, cols], float("-inf"))
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
        rs = e.sum(-1, keepdim=True)
        p = (e if defer else e / rs).to(BF16).float()
        acc = torch.zeros(*e.shape[:-1], D)
        for j0 in range(0, cols.stop, TILE):
            t = slice(j0, min(j0 + TILE, cols.stop))
            acc = acc + p[..., t] @ v[..., t, :]
        ctx[..., rows, :] = acc / rs if defer else acc
    return ctx.to(BF16).transpose(1, 2).reshape(B * S, HEADS * D)


def key_tiled_core(qkv2, S, causal, s_valid, defer):
    """The key-tiled kernel's two passes (K1's scale after the dot):
    ``[B*S, 3W]`` -> ``[B*S, W]``."""
    logits = CS._logits(qkv2, S, causal, s_valid, scale_after=True)
    return CS._merge(CS.two_pass_forward(logits, CS._heads(qkv2, S)[2], defer)).reshape(
        -1, HEADS * D)


def _cases(sizes):
    return [pytest.param(S, causal, s_valid, defer,
                         id=f"S{S}{'c' if causal else ''}-sv{s_valid}-"
                            f"{'defer' if defer else 'norm'}")
            for S in sizes for causal in (False, True) for s_valid in (None, S - 7)
            for defer in (False, True)]


def _meets_core_bar(got, qkv, S, causal, s_valid, defer):
    want = T.attn_core_reference(qkv, S, HEADS, causal, s_valid, defer)
    differ, ulps = _ulp_stats(got, want)
    assert differ <= DIFFER and ulps <= CORE_ULPS, (differ, ulps)


@pytest.mark.parametrize("S,causal,s_valid,defer", _cases((50, 77, 128)))
def test_one_block_schedule_meets_the_core_bar(S, causal, s_valid, defer):
    qkv = _qkv(2, S, seed=S + causal)
    _meets_core_bar(one_block_core(qkv, S, causal, s_valid, defer), qkv, S, causal, s_valid,
                    defer)


@pytest.mark.parametrize("S,causal,s_valid,defer", _cases((129, 197, 256)))
def test_key_tiled_route_meets_the_core_bar_past_128(S, causal, s_valid, defer):
    """bf16 attn_core past 128 tokens, in either schedule (the normalize-first
    one is K7's recompute at ViT-B/16's S=197)."""
    qkv = _qkv(2, S, seed=S + causal)
    _meets_core_bar(key_tiled_core(qkv, S, causal, s_valid, defer), qkv, S, causal, s_valid,
                    defer)


@pytest.mark.parametrize("S,s_valid", [(128, None), (128, 100), (77, 60)])
def test_skipping_dead_key_tiles_changes_nothing(S, s_valid):
    """A key tile wholly above the diagonal or past s_valid has P = 0 in every
    row of the q tile, so leaving it out is exact."""
    qkv = _qkv(1, S, seed=3)
    for defer in (False, True):
        skipped = one_block_core(qkv, S, True, s_valid, defer)
        full = one_block_core(qkv, S, True, s_valid, defer, skip_dead=False)
        assert torch.equal(skipped, full)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_block_chain_matches_tpu_kernel(dtype):
    """K1's chain with the emulated core against the TPU kernel in Pallas
    interpret mode (bars of tests/test_torch_attention.py)."""
    B, S, W, causal, s_valid = 2, 80, HEADS * D, True, 75
    rng = np.random.default_rng(7)
    r = lambda *shape, std=1.0: (rng.standard_normal(shape) * std).astype(np.float32)
    x = r(B * S, W, std=0.5)
    ln = {"scale": 1 + r(W, std=0.1), "bias": r(W, std=0.05)}
    attn = {"qkv": {"kernel": r(W, 3 * W, std=0.1), "bias": r(3 * W, std=0.1)},
            "out": {"kernel": r(W, W, std=0.1), "bias": r(W, std=0.1)}}
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (BF16, jnp.bfloat16)}[dtype]
    tree = lambda t: {k: tree(v) if isinstance(v, dict) else torch.from_numpy(v)
                      for k, v in t.items()}

    def core(qkv2, S_, heads, causal_, s_valid_):
        if qkv2.dtype == BF16:
            return one_block_core(qkv2, S_, causal_, s_valid_, S_ > T.DEFER_ABOVE)
        return T.attn_core_reference(qkv2, S_, heads, causal_, s_valid_)

    got = T._sublayer(torch.from_numpy(x).to(tdt), tree(ln), tree(attn), HEADS, causal,
                      s_valid, 1e-5, S, T.layer_norm_rows_reference,
                      T.gemm_bias_residual_reference, core)
    want = np.asarray(A._pallas_attn_sublayer_flat(
        jnp.asarray(x, jdt), ln, attn, S, HEADS, causal, 1e-5, block_b=1, interpret=True,
        s_valid=s_valid), np.float32)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    else:
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
        assert cos.min() >= 0.999, cos.min()


# (M, N, K): K2's TN products at ViT-B/32 B=32 (dWout, dWqkv), the text tower
# at 8 prompts, ViT-L/14 vision and text at batch 64, the MLP's dW at B=128,
# a sum shorter than one K step, a ragged K
SHAPES = [(768, 768, 1600), (768, 2304, 1600), (512, 1536, 616), (1024, 1024, 16448),
          (1024, 3072, 16448), (768, 2304, 4928), (768, 3072, 6400), (3072, 768, 6400),
          (40, 24, 37), (512, 512, 1000)]


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("M,N,K", SHAPES)
def test_tn_slices_cover_k(M, N, K, dtype):
    slices = TB.tn_slices(M, N, K, dtype)
    assert slices[0][0] == 0 and slices[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    rows = TB.tn_slice_rows(M, N, K, dtype)
    assert all(stop - start == rows for start, stop in slices[:-1])
    assert 0 < slices[-1][1] - slices[-1][0] <= rows
    if dtype == BF16:
        assert rows % TB.GEMM_K_STEP == 0
    else:
        assert rows == TB.K_SLICE


@pytest.mark.parametrize("M,N", [(1024, 1024), (1024, 3072)])
def test_l14_tn_products_take_few_slices(M, N):
    """At ViT-L/14 vision, batch 64 (16,448 token rows) fp32's 1024-row slices
    make 17; bf16's plan takes two: 64 tiles fill half the card, 192 leave
    their second wave under half full."""
    K = 64 * 257
    assert len(TB.tn_slices(M, N, K, torch.float32)) == 17
    assert len(TB.tn_slices(M, N, K, BF16)) == 2


def test_wide_products_fill_the_card_without_slices():
    """ViT-B/32's dWqkv (108 tiles, 82% of the SMs) at 1,600 and 4,928 token
    rows: one slice, no col_sum."""
    assert len(TB.tn_slices(768, 2304, 4928, BF16)) == 1
    assert len(TB.tn_slices(768, 2304, 1600, BF16)) == 1


@pytest.mark.parametrize("M,N,K", [(64, 48, 1000), (128, 256, 4160), (40, 24, 37)])
def test_planned_split_sum_meets_the_bf16_bar(M, N, K):
    """The slices' fp32 sums (exact bf16 products), added in order as col_sum
    adds them, against the plain TN product: the bf16 bar of a summed leaf
    (cosine >= 0.999, allclose atol 3e-2 of its RMS, rtol 1e-2)."""
    rng = np.random.default_rng(K)
    a = torch.from_numpy(rng.standard_normal((K, M), dtype=np.float32)).to(BF16)
    b = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32)).to(BF16)
    slices = TB.tn_slices(M, N, K, BF16)
    parts = torch.stack([a[s:e].float().t() @ b[s:e].float() for s, e in slices])
    got = TB.col_sum_reference(parts.view(len(slices), M * N)).view(M, N)
    want = TB.grad_gemm_tn_reference(a, b)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).min().item()
    rms = want.square().mean().sqrt().item()
    assert cos >= 0.999, cos
    torch.testing.assert_close(got, want, atol=3e-2 * rms, rtol=1e-2)
