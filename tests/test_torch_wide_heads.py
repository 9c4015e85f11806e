"""Heads wider than 128 on the CPU: the key-tiled kernels' plan, and the
port's plain versions and towers against the JAX package.

- ``ops.attention.tiled_plan`` (the key-tiled TF32 kernels' query rows
  and windows of keys) fits ``MAX_SMEM`` in every kernel of the forward and
  backward at every S up to ``MAX_SEQ`` (and far past it, for K5 and K12,
  which take any S) and head_dims up to 512, and takes the plans measured
  best at the towers' shapes.
- The plain versions of every attention core at head_dim 160 and 256 (small
  S, causal and ``s_valid``) against the JAX package: ``mha_core`` and
  ``mha_core_bwd`` against ``_pallas_mha`` / ``_pallas_mha_bwd``,
  ``flash_core`` against ``_pallas_flash_mha``, ``headgrid_core`` against
  ``_pallas_mha_headgrid``, all in Pallas interpret mode; ``attn_core`` and
  ``attn_core_bwd`` against K2's core ``_core_fwd_bwd_block`` (the deferred
  schedule, and normalize-first for ``attn_core(defer=False)``); K7
  (``block_bwd``) against ``_pallas_block_bwd_flat`` in interpret mode. No
  JAX kernel refuses these shapes, so none falls back to ``_jnp_mha``.
- A tiny ``CLIPConfig`` with head_dim 160 in both towers: one encode of each
  tower and one step's loss and grads, port against JAX (its kernels in
  interpret mode).

Bars: fp32 allclose 5e-3 with cosine > 0.9999. Inputs are made with numpy
from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plip_tpu.ops.attention as A
import plip_tpu.ops.block_bwd as JB
from plip_tpu.models import clip as jclip
from plip_tpu.models import config as jconfig
from plip_tpu.train import contrastive as jc
from plip_tpu_torch.models import clip as tclip
from plip_tpu_torch.models import config as tconfig
from plip_tpu_torch.ops import attention as T
from plip_tpu_torch.ops import attention_bwd as TB
from plip_tpu_torch.ops import block_bwd as TBB
from plip_tpu_torch.ops import mha as M
from plip_tpu_torch.train import contrastive as tc
from plip_tpu_torch.utils.checkpoint import from_jax_params, to_jax_params


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The key-tiled kernels' plan
# ---------------------------------------------------------------------------

PLAN_DIMS = [1, 3, 16, 32, 63, 64, 65, 80, 104, 128, 129, 136, 160, 200, 256, 384, 511, 512]


@pytest.mark.parametrize("D", PLAN_DIMS)
def test_tiled_plan_fits_shared_memory(D):
    """Every S up to MAX_SEQ (and K5's and K12's longer ones): 64 rows (the
    backward's rows kernel 64 or 128), the window at least one key tile and
    at most every tile, the widest that fits at those rows, the forward's,
    rows kernel's and keys kernel's shared memory at most MAX_SMEM; where a
    window holds every key at 64 rows, the plan takes every key."""
    assert T.tiled_smem(1, D, 1, "keys") <= T.MAX_SMEM
    for S in [*range(1, T.MAX_SEQ + 1), 2000, 4096, 10000]:
        tiles = -(-S // T.TILED_KEYS)
        for backward in (False, True):
            if backward and S > T.MAX_SEQ:
                continue
            kernel = "rows" if backward else "fwd"
            rows, win = T.tiled_plan(S, D, backward)
            assert rows in ((64, 128) if backward else (64,)) and 1 <= win <= tiles, (S, rows)
            assert T.tiled_smem(S, D, win, kernel, rows) <= T.MAX_SMEM, (S, win, kernel)
            if win < tiles:  # one tile more would not fit
                assert T.tiled_smem(S, D, win + 1, kernel, rows) > T.MAX_SMEM, (S, win, kernel)
            if T.tiled_smem(S, D, tiles, kernel, 64) <= T.MAX_SMEM:
                assert (rows, win) == (64, tiles), (S, rows, win, kernel)
    T.tiled_plan.cache_clear()


@pytest.mark.parametrize("S,D,backward,plan", [
    (257, 64, False, (64, 5)), (577, 64, False, (64, 10)), (197, 64, False, (64, 4)),
    (257, 80, False, (64, 5)), (257, 104, False, (64, 5)), (257, 64, True, (64, 5)),
    (197, 64, True, (64, 4)), (577, 64, True, (128, 1))])
def test_tiled_plan_at_the_towers(S, D, backward, plan):
    """The plans the towers take (ViT-B/16 197 tokens, L/14 257, @336 577;
    ViT-H/14 and bigG/14 head_dims 80 and 104): every key in one window but
    in @336's backward, which takes windows of one tile at 128 rows (faster
    on an H100 than 64 rows in windows of four, PERF.md section 6)."""
    assert T.tiled_plan(S, D, backward) == plan


def test_plan_strip_rows_follow_the_sequence():
    """A strip row holds the window's keys, at most S rounded up to 32, plus
    4 floats (4 mod 32: the rows of an m16n8k8 fragment on other banks):
    the layout of FwdSmem in csrc/mha.cu, counted by hand (strip, q tile,
    the key spans' statistics, two stages)."""
    ld_t, ld_s, x = 64 + 4, 288 + 4, 2 * 2 * 64  # S = 257: 288 keys, not 5 tiles' 320
    assert T.tiled_smem(257, 64, 5) == 4 * (64 * ld_s + 64 * ld_t + x + 2 * 64 * ld_t)
    assert T.tiled_smem(257, 64, 5, rows=128) == 4 * (128 * ld_s + 128 * ld_t + x + 2 * 64 * ld_t)
    for S in (1, 50, 257, 577, 1056, 3000):
        for win in (1, 3, 17):
            keys = min(64 * win, -(-S // 32) * 32)
            assert (keys + 4) % 32 == 4


# ---------------------------------------------------------------------------
# The cores at head_dim 160 and 256 against the JAX package
# ---------------------------------------------------------------------------

def _assert_parity(got, want):
    """fp32 cosine > 0.9999 plus allclose 5e-3."""
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    cos = float(got.ravel() @ want.ravel() / (np.linalg.norm(got) * np.linalg.norm(want)))
    assert cos > 0.9999, cos
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=5e-3)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


HEADS = 2
WIDE = [pytest.param(D, S, causal, s_valid, id=f"D{D}-S{S}{'-causal' if causal else ''}-sv{s_valid}")
        for D in (160, 256) for S, causal, s_valid in ((40, False, None), (37, True, 30))]


@pytest.mark.parametrize("D,S,causal,s_valid", WIDE)
def test_mha_core_and_bwd_match_k3_k4(D, S, causal, s_valid):
    W = HEADS * D
    qkv, g = _rand((2, S, 3 * W), D + S), _rand((2, S, W), D + 7)
    assert T.core_route(S, D, torch.float32) == T.core_route(S, D, torch.bfloat16) == "tiled"
    want = A._pallas_mha(jnp.asarray(qkv), HEADS, causal, interpret=True, s_valid=s_valid)
    _assert_parity(M.mha_core(torch.from_numpy(qkv), S, HEADS, causal, s_valid), want)
    want = A._pallas_mha_bwd(jnp.asarray(qkv), jnp.asarray(g), HEADS, causal, interpret=True,
                             s_valid=s_valid)
    got = M.mha_core_bwd(torch.from_numpy(qkv), torch.from_numpy(g), S, HEADS, causal, s_valid)
    _assert_parity(got, want)


@pytest.mark.parametrize("D,S,causal,s_valid", WIDE)
def test_flash_and_headgrid_cores_match_k5_k12(D, S, causal, s_valid):
    """K5 and K12 take no pad columns: s_valid does not enter."""
    W = HEADS * D
    qkv = _rand((2, S, 3 * W), D + S + 1)
    want = A._pallas_flash_mha(jnp.asarray(qkv), HEADS, causal, interpret=True)
    _assert_parity(M.flash_core(torch.from_numpy(qkv), S, HEADS, causal), want)
    want = A._pallas_mha_headgrid(jnp.asarray(qkv), HEADS, causal, interpret=True)
    _assert_parity(M.headgrid_core(torch.from_numpy(qkv), S, HEADS, causal), want)


@pytest.mark.parametrize("D,S,causal,s_valid", WIDE)
def test_attn_core_and_bwd_match_k2_core(D, S, causal, s_valid):
    """K1's core in both schedules and K2's core backward against K2's core
    (its context is K1's: pipeline=True the deferred divide, False
    normalize-first)."""
    W = HEADS * D
    qkv, g = _rand((2 * S, 3 * W), D + S + 2), _rand((2 * S, W), D + S + 3)
    for dt in (torch.float32, torch.bfloat16):
        assert T.core_route(S, D, dt, backward=True) == "tiled"
    mask = A._blockdiag_mask(2 * S, S, causal, s_valid)
    for pipeline in (False, True):
        ctx, dqkv = A._core_fwd_bwd_block(jnp.asarray(qkv), jnp.asarray(g), mask, heads=HEADS,
                                          D=D, W=W, dtype=jnp.float32, pipeline=pipeline)
        got = T.attn_core(torch.from_numpy(qkv), S, HEADS, causal, s_valid, defer=pipeline)
        _assert_parity(got, ctx)
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


@pytest.mark.parametrize("causal", [False, True])
def test_block_bwd_matches_k7_at_head_dim_160(causal):
    S, D = 24, 160
    W = HEADS * D
    x, g = _rand((2 * S, W), 11 + causal), _rand((2 * S, W), 12 + causal)
    p = _block_params(W, seed=13)
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


# ---------------------------------------------------------------------------
# A tower of head_dim 160
# ---------------------------------------------------------------------------

def _wide(m):
    """Head_dim 160 in both towers (vision S=5, text S=16), one layer each."""
    return m.CLIPConfig(
        vision=m.VisionConfig(width=320, layers=1, heads=2, image_size=32, patch_size=16),
        text=m.TextConfig(width=320, layers=1, heads=2, vocab_size=128, context_length=16),
        embed_dim=16)


@pytest.fixture(scope="module")
def wide_pair():
    jcfg, tcfg = _wide(jconfig), _wide(tconfig)
    assert tcfg.vision.width // tcfg.vision.heads == tcfg.text.width // tcfg.text.heads == 160
    params = jax.device_get(jclip.init_params(jax.random.PRNGKey(3), jcfg))
    model = tclip.CLIP(tcfg)
    model.load_state_dict(from_jax_params(params, tcfg))
    return params, jcfg, model, tcfg


def _batch(cfg, B=4, seed=0):
    rng = np.random.default_rng(seed)
    px = rng.standard_normal((B, cfg.vision.image_size, cfg.vision.image_size, 3))
    ids = np.zeros((B, cfg.text.context_length), np.int32)
    ids[:, 0] = 1
    ids[:, 1:5] = rng.integers(2, 120, (B, 4))
    ids[:, 5] = cfg.text.eot
    return px.astype(np.float32), ids


def test_wide_head_tower_encodes_match_jax(wide_pair, monkeypatch):
    params, jcfg, model, tcfg = wide_pair
    monkeypatch.setenv("PLIP_TPU_INTERPRET", "1")
    px, ids = _batch(tcfg)
    with torch.no_grad():
        got_i = model.encode_image(torch.from_numpy(px), torch.float32)
        got_t = model.encode_text(torch.from_numpy(ids).long(), torch.float32)
    _assert_parity(got_i, jclip.encode_image(params, jnp.asarray(px), jcfg, jnp.float32))
    _assert_parity(got_t, jclip.encode_text(params, jnp.asarray(ids), jcfg, jnp.float32))


def test_wide_head_train_step_grads_match_jax(wide_pair, monkeypatch):
    params, jcfg, model, tcfg = wide_pair
    monkeypatch.setenv("PLIP_TPU_INTERPRET", "1")
    px, ids = _batch(tcfg, seed=1)

    def f(p):
        return jc.clip_loss(p, jnp.asarray(px), jnp.asarray(ids), jcfg, jnp.float32)[0]

    loss_j, grads_j = jax.value_and_grad(f)(params)
    model.zero_grad(set_to_none=True)
    loss, _ = tc.clip_loss(model, torch.from_numpy(px), torch.from_numpy(ids).long(),
                           torch.float32, "mlp")
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=5e-3)
    got = to_jax_params({k: p.grad for k, p in model.named_parameters()}, tcfg)
    for (path, want), leaf in zip(jax.tree_util.tree_leaves_with_path(jax.device_get(grads_j)),
                                  jax.tree.leaves(got)):
        if not np.any(want):
            np.testing.assert_array_equal(np.asarray(leaf), want)
            continue
        try:
            _assert_parity(leaf, want)
        except AssertionError as e:
            raise AssertionError(f"{jax.tree_util.keystr(path)}: {e}") from None
