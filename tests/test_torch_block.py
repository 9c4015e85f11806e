"""The port's whole-block forward (K10, ``ops.block``) against the JAX
package's (CPU).

- ``block_fwd_reference`` (the kernel path's plain version) against
  ``_pallas_block`` in Pallas interpret mode at ``test_fused_block.py``'s
  shapes, causal or not: fp32 allclose 3e-5 (the JAX test's bar), bf16 row
  cosine >= 0.999. In bf16 its activation is also held to the TPU kernel's
  expression (``block.py:98-102``) on the same fc1 inputs: at most ``DIFFER``
  of the elements not bit-equal, each within one bf16 ulp of its row's
  largest |value|. Control: K7-K9's activation of the cast h1 fails that bar.
- ``transformer_block`` past 128 tokens (the composed block) against the JAX
  package's with ``PLIP_TPU_INTERPRET=1`` (``_jnp_block`` over ``_pallas_mha``
  and its VJP over ``_pallas_mha_bwd``).
- ``transformer_block`` grads at S <= 128 against ``jax.vjp`` of
  ``plip_tpu.ops.block.transformer_block`` with ``PLIP_TPU_INTERPRET=1`` (its
  forward the interpret-mode kernel, its backward the composed block's):
  fp32 cosine > 0.9999 plus allclose 5e-3; bf16 cosine >= 0.999.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plip_tpu.ops.block as JBK
from plip_tpu_torch.ops import block as BK
from plip_tpu_torch.ops import mlp as TM


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
SHAPES = [(3, 10, 64, 4), (2, 16, 128, 2)]


def _params(W, seed):
    """A block's parameters (numpy fp32, the JAX package's tree)."""
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


def _torch_tree(tree, requires_grad=False):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(requires_grad),
                        tree)


def _x(B, S, W, seed=0):
    return np.random.default_rng(seed).standard_normal((B, S, W)).astype(np.float32)


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def _activation_bar(got, want):
    """(share of the elements that differ, the worst error in bf16 ulps of
    the row's largest |want|)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    differ = float((got != want).mean())
    worst = float((np.abs(got - want) / _bf16_ulp(np.abs(want).max(-1, keepdims=True))).max())
    return differ, worst


def _spied_block_fwd(x2, p, S, heads, causal, gelu=None):
    """``block_fwd_reference``, with the inputs and output of its activation
    GEMM recorded (and that GEMM replaced by ``gelu`` if given)."""
    seen = {}
    fns = list(BK.REFERENCE_FNS)
    real = gelu or fns[3]

    def spy(a, w, b):
        seen["gelu"] = (a, w, b, real(a, w, b))
        return seen["gelu"][3]

    fns[3] = spy
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BK, "REFERENCE_FNS", tuple(fns))
        out = BK.block_fwd_reference(x2, p, S, heads, causal)
    return out, seen["gelu"]


def _tpu_activation(a, w, b, jdt):
    """The TPU kernel's activation on the same fc1 inputs."""
    h1 = jnp.dot(jnp.asarray(a.float().numpy(), jdt), jnp.asarray(w.float().numpy(), jdt),
                 preferred_element_type=jnp.float32) + jnp.asarray(b.numpy())
    return np.asarray((h1 * jax.nn.sigmoid(1.702 * h1)).astype(jdt), np.float32)


def _check_kernel_path(shape, causal, dtype, gelu=None):
    B, S, W, H = shape
    tdt, jdt = DTYPES[dtype]
    p = _params(W, seed=1)
    x = _x(B, S, W)
    want = np.asarray(JBK._pallas_block(jnp.asarray(x, jdt), p, H, causal, 1e-5,
                                        interpret=True), np.float32)
    out, (a, w, b, act) = _spied_block_fwd(torch.from_numpy(x).to(tdt).view(B * S, W),
                                           _torch_tree(p), S, H, causal, gelu)
    assert out.dtype == tdt
    got = out.float().numpy().reshape(B, S, W)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)
        return
    cos = [_cos(g, w_) for g, w_ in zip(got.reshape(-1, W), want.reshape(-1, W))]
    assert min(cos) >= 0.999, min(cos)
    differ, worst = _activation_bar(act.float().numpy(), _tpu_activation(a, w, b, jdt))
    assert differ <= DIFFER and worst <= 1, ("activation", differ, worst)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_path_matches_tpu_kernel(shape, causal, dtype):
    _check_kernel_path(shape, causal, dtype)


def test_bf16_test_rejects_the_cast_h1_activation():
    """Control: K7-K9's epilogue (QuickGELU of the cast h1) is another
    rounding than K10's."""
    with pytest.raises(AssertionError, match="activation"):
        _check_kernel_path(SHAPES[1], False, "bfloat16",
                           gelu=lambda a, w, b: TM.gemm_bias_gelu_reference(a, w, b)[1])


def _jax_grads(x, p, H, causal, jdt, g):
    out, vjp = jax.vjp(lambda a, q: JBK.transformer_block(a, q, H, causal), jnp.asarray(x, jdt),
                       jax.tree.map(jnp.asarray, p))
    dx, dp = vjp(jnp.asarray(g, jdt))
    return {"out": out, "dx": dx, **{jax.tree_util.keystr(k): v
                                     for k, v in jax.tree_util.tree_leaves_with_path(dp)}}


def _port_grads(x, p, H, causal, tdt, g):
    pt = _torch_tree(p, requires_grad=True)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    out = BK.transformer_block(xt, pt, H, causal)
    out.backward(torch.from_numpy(g).to(tdt))
    return {"out": out, "dx": xt.grad, **{
        jax.tree_util.keystr(k): v.grad for k, v in jax.tree_util.tree_leaves_with_path(pt)}}


def _assert_grads(got, want, dtype):
    assert got.keys() == want.keys()
    for name in want:
        a, b = got[name].detach().float().numpy(), np.asarray(want[name], np.float32)
        assert a.shape == b.shape, name
        if dtype == "float32":
            assert _cos(a, b) > 0.9999, (name, _cos(a, b))
            np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-3, err_msg=name)
        else:
            assert _cos(a, b) >= 0.999, (name, _cos(a, b))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_jax(monkeypatch, causal, dtype):
    """S <= 128: the forward is the kernel path, the backward the composed
    block's, as the JAX package's custom VJP."""
    monkeypatch.setenv("PLIP_TPU_INTERPRET", "1")
    calls = []
    real = BK.block_fwd
    monkeypatch.setattr(BK, "block_fwd", lambda *a: (calls.append(1), real(*a))[1])
    B, S, W, H = SHAPES[0]
    tdt, jdt = DTYPES[dtype]
    p, x = _params(W, seed=2), _x(B, S, W, seed=3)
    g = _x(B, S, W, seed=4)
    _assert_grads(_port_grads(x, p, H, causal, tdt, g), _jax_grads(x, p, H, causal, jdt, g),
                  dtype)
    assert calls == [1]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_composed_block_past_128_matches_jax(monkeypatch, dtype):
    """S = 136: both packages run the composed block (its core K3 with the
    deferred divide, its backward K4), forward and grads."""
    monkeypatch.setenv("PLIP_TPU_INTERPRET", "1")
    calls = []
    monkeypatch.setattr(BK, "block_fwd", lambda *a: calls.append(1))
    B, S, W, H = 2, 136, 64, 4
    tdt, jdt = DTYPES[dtype]
    p, x = _params(W, seed=5), _x(B, S, W, seed=6)
    g = _x(B, S, W, seed=7)
    _assert_grads(_port_grads(x, p, H, False, tdt, g), _jax_grads(x, p, H, False, jdt, g),
                  dtype)
    assert not calls
