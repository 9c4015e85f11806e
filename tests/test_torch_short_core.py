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

K2's core backward at S <= 128 in bf16 (``csrc/attention_sublayer_bwd.cu``'s
``attn_core_bwd_wgmma_kernel``) holds one (sequence, head) on chip: per
64-row q tile the logits and dp over the live key tiles, the exact row max,
fp32 ``denom`` and ``dsum_u``, ``e_c`` and ``ds_u`` cast once; ctx and dq
as a fresh accumulator a key tile, added in order; then per key tile dk and
dv over the q tiles that see it, again a fresh accumulator each. Emulated
here, it must meet the bf16 bars of the key-tiled backwards against
``attn_core_bwd_reference`` (dqkv within ``BWD_ULPS`` ulps of its row's
largest value, ctx within one, at most ``DIFFER`` of the elements not
bit-equal); with normalize-first P (K4's schedule) it must fail them. A
small case runs the emulated core inside K2's chain against the TPU kernel
in Pallas interpret mode.

``ops.attention_bwd.tn_slice_rows`` plans the slices of the TN products
(``dW = a^T . b`` over the token rows): they cover K exactly, each starts on
a K step of its kernel (64 rows of the bf16 wgmma kernel, 8 of the fp32
CUDA-core one), and the slices' fp32 sums added in order (``col_sum``) meet
the bf16 bar against ``grad_gemm_tn_reference``.

Inputs are made with numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plip_tpu.ops.attention as A
import test_torch_core_schedule as CS
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


TILE = 64  # query rows a block, keys a tile, as the kernel
HEADS, D = 2, 64
DIFFER, CORE_ULPS, BWD_ULPS = 0.005, 1, 2  # the bf16 core bars (PERF.md section 2)
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


def _tile_sum(parts):
    """Tile products added in order, each from a fresh accumulator."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def one_block_core_bwd(qkv2, dctx2, S, causal, s_valid, normalize_first=False,
                       skip_dead=True):
    """The bf16 one-block backward's schedule (S <= 128): ``(ctx [B*S, W],
    dqkv [B*S, 3W])``. ``normalize_first``: the control, P = cast(e / denom)
    in place of e_c and no divide after the products (K4's schedule).
    ``skip_dead=False``: every q tile against every key tile."""
    assert S <= T.BWD_ROW_MAX_SEQ
    B = qkv2.shape[0] // S
    q, k, v = qkv2.view(B, S, 3, HEADS, D).permute(2, 0, 3, 1, 4).float().unbind(0)
    g = dctx2.view(B, S, HEADS, D).transpose(1, 2).float()
    scale = D ** -0.5
    keep = T.keep_mask(S, causal, s_valid, "cpu")
    n_keys = S if s_valid is None else s_valid
    tiles = [slice(j0, min(j0 + TILE, S)) for j0 in range(0, S, TILE)]
    ctx, dq = torch.zeros_like(q), torch.zeros_like(q)
    qn, gn = torch.zeros_like(q), torch.zeros_like(g)
    e_c, ds_c = {}, {}  # (q tile, key tile) -> the cast tile
    for it, rows in enumerate(tiles):
        nk = min(n_keys, rows.start + TILE) if causal else n_keys
        live = tiles[:-(-nk // TILE)] if skip_dead else tiles  # the tiles its rows may see
        cols = slice(0, live[-1].stop)
        logits = (q[..., rows, :] @ k[..., cols, :].transpose(-1, -2)) * scale
        logits = logits.masked_fill(~keep[rows, cols], float("-inf"))
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
        den = e.sum(-1, keepdim=True)
        dp = g[..., rows, :] @ v[..., cols, :].transpose(-1, -2)
        if normalize_first:
            w = e / den
            ds = w * (dp - (dp * w).sum(-1, keepdim=True))
        else:
            w, ds = e, e * (dp - (dp * e).sum(-1, keepdim=True) / den)
        w, ds = w.to(BF16).float(), ds.to(BF16).float()
        d = 1.0 if normalize_first else den
        ctx[..., rows, :] = _tile_sum([w[..., t] @ v[..., t, :] for t in live]) / d
        dq[..., rows, :] = _tile_sum([ds[..., t] @ k[..., t, :] for t in live]) * scale / d
        for jt, t in enumerate(live):
            e_c[it, jt], ds_c[it, jt] = w[..., t], ds[..., t]
        qn[..., rows, :] = (q[..., rows, :] / d).to(BF16).float()
        gn[..., rows, :] = (g[..., rows, :] / d).to(BF16).float()
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for kt, keys in enumerate(tiles):
        seen = [it for it in range(kt if causal and skip_dead else 0, len(tiles))
                if (it, kt) in e_c]
        if keys.start < n_keys or not skip_dead:
            dv[..., keys, :] = _tile_sum([e_c[it, kt].transpose(-1, -2) @ gn[..., tiles[it], :]
                                          for it in seen])
            dk[..., keys, :] = _tile_sum([ds_c[it, kt].transpose(-1, -2) @ qn[..., tiles[it], :]
                                          for it in seen]) * scale
    dqkv = torch.stack([t.to(BF16) for t in (dq, dk, dv)], 2)  # [B, H, 3, S, D]
    return (ctx.to(BF16).transpose(1, 2).reshape(B * S, HEADS * D),
            dqkv.permute(0, 3, 2, 1, 4).reshape(qkv2.shape))


def _g(B, S, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((B * S, HEADS * D),
                                                dtype=np.float32)).to(BF16)


# (S, causal, s_valid): one token, ViT-B/32 vision, one and just over one
# tile, the text tower causal and with pad columns, the longest one-block S
BWD_CASES = [(1, False, None), (50, False, None), (64, False, None), (65, True, None),
             (77, True, None), (77, True, 70), (128, False, None), (128, True, 100)]


@pytest.mark.parametrize("S,causal,s_valid", BWD_CASES)
def test_one_block_backward_meets_the_bwd_bar(S, causal, s_valid):
    qkv, g = _qkv(3, S, seed=S + causal), _g(3, S, seed=S)
    ctx, dqkv = one_block_core_bwd(qkv, g, S, causal, s_valid)
    want_ctx, want = TB.attn_core_bwd_reference(qkv, g, S, HEADS, causal, s_valid)
    differ, ulps = _ulp_stats(ctx, want_ctx)
    assert differ <= DIFFER and ulps <= CORE_ULPS, ("ctx", differ, ulps)
    differ, ulps = _ulp_stats(dqkv, want)
    assert differ <= DIFFER and ulps <= BWD_ULPS, ("dqkv", differ, ulps)


@pytest.mark.parametrize("S,causal,s_valid", [(50, False, None), (77, True, None),
                                              (128, False, None)])
def test_normalize_first_control_fails_the_bwd_bar(S, causal, s_valid):
    """P cast after the divide (K4's schedule) rounds P and dS elsewhere: its
    dqkv fails the bar the deferred schedule meets."""
    qkv, g = _qkv(3, S, seed=S + causal), _g(3, S, seed=S)
    want = TB.attn_core_bwd_reference(qkv, g, S, HEADS, causal, s_valid)[1]
    bad = one_block_core_bwd(qkv, g, S, causal, s_valid, normalize_first=True)[1]
    differ, ulps = _ulp_stats(bad, want)
    assert differ > DIFFER or ulps > BWD_ULPS, (differ, ulps)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,causal,s_valid", [(50, False, None), (77, True, 70)])
def test_one_block_backward_chain_matches_tpu_kernel(S, causal, s_valid, dtype):
    """K2's chain with the emulated core (bf16; fp32 takes the plain core, as
    the card's fp32 check kernel computes it) against the TPU kernel in Pallas
    interpret mode, at ViT-B/32 vision and text lengths with two heads of 64:
    fp32 dx allclose atol 1e-5, rtol 1e-4, parameter grads atol 1e-4, rtol
    1e-4; bf16 leaf cosine >= 0.999 (the bars of
    tests/test_torch_attention_bwd.py)."""
    B, W = 2, HEADS * D
    rng = np.random.default_rng(S)
    r = lambda *shape, std=1.0: (rng.standard_normal(shape) * std).astype(np.float32)
    x, g = r(B * S, W, std=0.5), r(B * S, W)
    ln = {"scale": 1 + r(W, std=0.1), "bias": r(W, std=0.05)}
    attn = {"qkv": {"kernel": r(W, 3 * W, std=0.1), "bias": r(3 * W, std=0.1)},
            "out": {"kernel": r(W, W, std=0.1), "bias": r(W, std=0.1)}}
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (BF16, jnp.bfloat16)}[dtype]
    tree = lambda t: {k: tree(v) if isinstance(v, dict) else torch.from_numpy(v)
                      for k, v in t.items()}

    def core_bwd(qkv2, dctx2, S_, heads, causal_, s_valid_):
        if qkv2.dtype == BF16:
            return one_block_core_bwd(qkv2, dctx2, S_, causal_, s_valid_)
        return TB.attn_core_bwd_reference(qkv2, dctx2, S_, heads, causal_, s_valid_)

    fns = list(TB.REFERENCE_FNS)
    fns[2] = core_bwd
    dx, dln, dattn = TB._sublayer_bwd(torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt),
                                      tree(ln), tree(attn), S, HEADS, causal, s_valid, 1e-5,
                                      fns)
    got = [dx, dln["scale"], dln["bias"], dattn["qkv"]["kernel"], dattn["qkv"]["bias"],
           dattn["out"]["kernel"], dattn["out"]["bias"]]
    jx, jdln, jdattn = A._pallas_attn_sublayer_bwd_flat(
        jnp.asarray(x, jdt), jnp.asarray(g, jdt), ln, attn, S, HEADS, causal, 1e-5,
        interpret=True, s_valid=s_valid)
    want = [jx, jdln["scale"], jdln["bias"], jdattn["qkv"]["kernel"], jdattn["qkv"]["bias"],
            jdattn["out"]["kernel"], jdattn["out"]["bias"]]
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        assert a.shape == b.shape, i
        if dtype == "float32":
            tol = (1e-5, 1e-4) if i == 0 else (1e-4, 1e-4)
            np.testing.assert_allclose(a, b, atol=tol[0], rtol=tol[1], err_msg=str(i))
        else:
            cos = float(a.ravel() @ b.ravel() / (np.linalg.norm(a) * np.linalg.norm(b)))
            assert cos >= 0.999, (i, cos)


@pytest.mark.parametrize("S,causal,s_valid", [(128, True, None), (128, True, 60),
                                              (77, True, 50), (128, False, 60)])
def test_one_block_backward_skips_dead_tiles_exactly(S, causal, s_valid):
    """A key tile no row of a q tile may see (the causal triangle, or wholly
    past s_valid) has e = ds_u = 0 in every row: leaving its products out,
    and giving its keys dk = dv = 0 unread, changes no bit."""
    qkv, g = _qkv(2, S, seed=5), _g(2, S, seed=6)
    skipped = one_block_core_bwd(qkv, g, S, causal, s_valid)
    full = one_block_core_bwd(qkv, g, S, causal, s_valid, skip_dead=False)
    for a, b in zip(skipped, full):
        assert torch.equal(a, b)


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
        assert rows % TB.SIMT_K_STEP == 0 and (rows >= TB.SIMT_MIN_SLICE or len(slices) == 1)


@pytest.mark.parametrize("M,N", [(1024, 1024), (1024, 3072)])
def test_l14_tn_products_take_few_slices(M, N):
    """At ViT-L/14 vision, batch 64 (16,448 token rows) fp32's plan takes
    four slices (64 or 192 tiles of 128 x 128 at two blocks an SM: 256 and
    768 blocks over 264 slots); bf16's two: 64 tiles fill half the card, 192
    leave their second wave under half full."""
    K = 64 * 257
    assert len(TB.tn_slices(M, N, K, torch.float32)) == 4
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
