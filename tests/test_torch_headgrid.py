"""The port's K12 core (``headgrid_core``) and the ``_jnp_mha`` core of the
padded composed paths (``jnp_mha_core``) against the JAX package's (CPU).

- ``headgrid_core_reference`` against ``_pallas_mha_headgrid`` in Pallas
  interpret mode at its default head groups on ``test_fused_attention.py``'s
  shapes, causal or not: fp32 allclose rtol/atol 2e-5 (the JAX test's bar);
  bf16 with at most ``DIFFER`` of the elements not bit-equal, each within one
  bf16 ulp of its row's largest |value|. Control: K3's deferred core at
  S = 257 (``flash_core_reference``) fails that bf16 bar.
- ``jnp_mha_core`` (forward ``headgrid_core``, backward the ``_jnp_mha``
  VJP) against ``jax.vjp`` of ``_jnp_mha`` at S = 520, fp32 allclose 1e-5.
- ``headgrid_core`` takes no head groups: every head is written (the
  reference's explicit ``hpp`` leaves trailing heads unwritten).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plip_tpu.ops.attention as A
from plip_tpu_torch.ops import mha as M


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
DIFFER = 0.005
SHAPES = [(2, 257, 16, 64), (1, 197, 12, 64), (2, 130, 4, 64)]


def _qkv(B, S, H, D, seed):
    return np.random.default_rng(seed).standard_normal((B, S, 3 * H * D)).astype(np.float32)


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def _bf16_bar(got, want):
    """(share of the elements that differ, the worst error in bf16 ulps of
    the row's largest |want|)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    differ = float((got != want).mean())
    worst = float((np.abs(got - want) / _bf16_ulp(np.abs(want).max(-1, keepdims=True))).max())
    return differ, worst


def _tpu(qkv, H, causal, jdt):
    return np.asarray(A._pallas_mha_headgrid(jnp.asarray(qkv, jdt), H, causal, interpret=True),
                      np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_headgrid_reference_matches_tpu_kernel(shape, causal, dtype):
    B, S, H, D = shape
    tdt, jdt = DTYPES[dtype]
    qkv = _qkv(B, S, H, D, seed=6)
    want = _tpu(qkv, H, causal, jdt)
    got = M.headgrid_core(torch.from_numpy(qkv).to(tdt), S, H, causal)
    assert got.dtype == tdt and got.shape == (B, S, H * D)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        differ, worst = _bf16_bar(got, want)
        assert differ <= DIFFER and worst <= 1, (differ, worst)


def test_bf16_bar_rejects_the_deferred_divide():
    """Control: K3's core past 128 tokens defers the divide past P.v; at
    S = 257 it is another bf16 function than K12's."""
    B, S, H, D = SHAPES[0]
    qkv = _qkv(B, S, H, D, seed=6)
    want = _tpu(qkv, H, False, jnp.bfloat16)
    got = M.flash_core_reference(torch.from_numpy(qkv).bfloat16(), S, H).float().numpy()
    differ, worst = _bf16_bar(got, want)
    assert differ > DIFFER or worst > 1, (differ, worst)


@pytest.mark.parametrize("causal", [False, True])
def test_jnp_mha_core_matches_jax_vjp(causal):
    """Above 512 tokens: the forward and the backward are ``_jnp_mha``'s."""
    B, S, H, D = 1, 520, 2, 16
    rng = np.random.default_rng(3)
    qkv = _qkv(B, S, H, D, seed=2)
    g = rng.standard_normal((B, S, H * D)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda a: A._jnp_mha(a, H, causal), jnp.asarray(qkv))
    (dqkv_j,) = vjp(jnp.asarray(g))
    leaf = torch.from_numpy(qkv).requires_grad_()
    out = M.jnp_mha_core(leaf, S, H, causal)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(dqkv_j), rtol=1e-5, atol=1e-5)


def test_every_head_is_written():
    """12 heads at D = 64: the reference with ``hpp=8`` writes 8 of them
    (ROADMAP Queue 3); the port has no head groups."""
    B, S, H, D = 1, 130, 12, 64
    qkv = _qkv(B, S, H, D, seed=4)
    got = M.headgrid_core(torch.from_numpy(qkv), S, H).numpy()
    want = _tpu(qkv, H, False, jnp.float32)  # the default head groups
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert (np.abs(got.reshape(B, S, H, D)).max(axis=(0, 1, 3)) > 0).all()
