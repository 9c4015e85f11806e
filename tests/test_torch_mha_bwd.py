"""The port's attention-core backwards and the hybrid sublayer against the
JAX package's TPU kernels (CPU).

- K4: ``mha_core_bwd_reference`` against ``_pallas_mha_bwd`` in Pallas
  interpret mode at S = 16 and S = 136, causal or not, with and without pad
  columns (``s_valid`` = S - 5);
- that K4 recomputes P with the logits scaled after the dot, so in bf16 it
  is not autograd through K3's forward (which scales q before the dot);
- K2 past 128 tokens: ``attention_sublayer_bwd_reference`` at S = 136 with
  pad columns against ``_pallas_attn_sublayer_bwd_flat`` in interpret mode;
- the hybrid (``attention_sublayer(hybrid=True)``: the composed forward over
  K3, K2 backward) against ``plip_tpu.ops.attention.attention_sublayer_flat``
  with ``PLIP_TPU_INTERPRET=1`` and ``_TRAIN_FWD_COMPOSED_OVERRIDE=True``, so
  that a narrow width (W = 128) takes the JAX package's hybrid.

Inputs are made with numpy from a seed and handed to both. Bars: fp32
allclose atol 1e-5 (the sublayer grads: the bars of
``test_torch_attention_bwd.py``); bf16 cores within one bf16 ulp of their
row's largest value (the rounding points are the same, the fp32 sums run in
another order); the bf16 sublayer leaves cosine >= 0.999.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plip_tpu.ops.attention as A
from plip_tpu_torch.ops import attention as T
from plip_tpu_torch.ops import attention_bwd as TB
from plip_tpu_torch.ops import mha as M


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, HEADS, D = 2, 2, 16
W = HEADS * D
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _rand(shape, seed, std=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * std).astype(np.float32)


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def assert_core_close(got, want, dtype):
    """fp32 allclose 1e-5; bf16 every element within one ulp of its row's
    largest |value| (rows of dqkv: one token's q, k and v grads)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        return
    row_ulp = _bf16_ulp(np.abs(want).max(-1, keepdims=True))
    worst = (np.abs(got - want) / row_ulp).max()
    assert worst <= 1, f"{worst} ulps of the row's largest value apart"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S,causal,s_valid", [
    (S, causal, s_valid) for S in (16, 136) for causal in (False, True)
    for s_valid in (None, S - 5)])
def test_mha_core_bwd_matches_tpu_kernel(S, causal, s_valid, dtype):
    tdt, jdt = DTYPES[dtype]
    qkv, g = _rand((B, S, 3 * W), S + causal), _rand((B, S, W), S + 7)
    want = A._pallas_mha_bwd(jnp.asarray(qkv, jdt), jnp.asarray(g, jdt), HEADS, causal,
                             interpret=True, s_valid=s_valid)
    got = M.mha_core_bwd_reference(torch.from_numpy(qkv).to(tdt),
                                   torch.from_numpy(g).to(tdt), S, HEADS, causal, s_valid)
    assert got.dtype == tdt and got.shape == (B, S, 3 * W)
    assert_core_close(got.float().numpy().reshape(B * S, -1),
                      np.asarray(want, np.float32).reshape(B * S, -1), dtype)


def test_k4_scales_the_logits_after_the_dot():
    """K4 recomputes P from ``(q . k) * D**-0.5``; K3's forward rounds ``q *
    D**-0.5`` to bf16 first. At a head width whose scale is not a power of
    two they differ in bf16, so K4 is not the exact autograd of K3 there; in
    fp32 they agree."""
    S, heads, d = 16, 1, 24
    qkv, g = _rand((1, S, 3 * d), 0), _rand((1, S, d), 1)

    def autograd_k3(dtype):
        leaf = torch.from_numpy(qkv).to(dtype).requires_grad_()
        M.mha_core_reference(leaf, S, heads).backward(torch.from_numpy(g).to(dtype))
        return leaf.grad

    def k4(dtype):
        return M.mha_core_bwd_reference(torch.from_numpy(qkv).to(dtype),
                                        torch.from_numpy(g).to(dtype), S, heads)

    torch.testing.assert_close(k4(torch.float32), autograd_k3(torch.float32), atol=1e-5,
                               rtol=1e-5)
    assert not torch.equal(k4(torch.bfloat16), autograd_k3(torch.bfloat16))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
def test_k2_past_128_matches_tpu_kernel(causal, dtype):
    """K2 at S = 136 with pad columns: the plain backward the key-tiled
    kernel is held to on the card, against the TPU kernel."""
    from test_torch_attention_bwd import _assert_leaves, _inputs, _leaves, _np, _torch_tree

    S, s_valid = 136, 131
    x, g, ln, attn = _inputs(S, seed=11 + causal)
    tdt, jdt = DTYPES[dtype]
    want = A._pallas_attn_sublayer_bwd_flat(jnp.asarray(x, jdt), jnp.asarray(g, jdt), ln,
                                            attn, S, 2, causal, 1e-5, interpret=True,
                                            s_valid=s_valid)
    got = TB.attention_sublayer_bwd_reference(
        torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt), _torch_tree(ln),
        _torch_tree(attn), S, 2, causal, s_valid)
    _assert_leaves(_leaves(*got), {k: _np(v) for k, v in _leaves(*want).items()}, dtype)


HYBRID_W, HYBRID_HEADS, HYBRID_S = 128, 2, 136


def _hybrid_inputs(seed):
    rng = np.random.default_rng(seed)

    def r(*shape, std=1.0):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    Wd = HYBRID_W
    x, g = r(B * HYBRID_S, Wd, std=0.5), r(B * HYBRID_S, Wd)
    ln = {"scale": 1 + r(Wd, std=0.1), "bias": r(Wd, std=0.05)}
    attn = {"qkv": {"kernel": r(Wd, 3 * Wd, std=Wd ** -0.5), "bias": r(3 * Wd, std=0.1)},
            "out": {"kernel": r(Wd, Wd, std=Wd ** -0.5), "bias": r(Wd, std=0.1)}}
    return x, g, ln, attn


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal,s_valid", [(False, None), (True, 131)])
def test_hybrid_matches_jax_hybrid(monkeypatch, causal, s_valid, dtype):
    """The output and every grad of the hybrid sublayer against the JAX
    package's, which takes its hybrid here (K3 in interpret mode forward, K2
    backward: counted below)."""
    from test_torch_attention_bwd import _leaves, _np, _torch_tree

    monkeypatch.setenv("PLIP_TPU_INTERPRET", "1")
    monkeypatch.setattr(A, "_TRAIN_FWD_COMPOSED_OVERRIDE", True)
    calls = []
    for name in ("_pallas_mha", "_pallas_attn_sublayer_flat", "_pallas_attn_sublayer_bwd_flat"):
        real = getattr(A, name)
        monkeypatch.setattr(A, name, lambda *a, _n=name, _f=real, **k: (
            calls.append(_n), _f(*a, **k))[1])
    S, heads = HYBRID_S, HYBRID_HEADS
    x, g, ln, attn = _hybrid_inputs(seed=5 + causal)
    tdt, jdt = DTYPES[dtype]

    def jax_fn(x2, ln_p, attn_p):
        return A.attention_sublayer_flat(x2, ln_p, attn_p, S, heads, causal, 1e-5, s_valid)

    out_j, vjp = jax.vjp(jax_fn, jnp.asarray(x, jdt), ln, attn)
    dx_j, dln_j, dattn_j = vjp(jnp.asarray(g, jdt))
    assert sorted(set(calls)) == ["_pallas_attn_sublayer_bwd_flat", "_pallas_mha"]

    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    lnt, attnt = _torch_tree(ln), _torch_tree(attn)
    for t in [*lnt.values(), *attnt["qkv"].values(), *attnt["out"].values()]:
        t.requires_grad_()
    out_t = T.attention_sublayer(xt, lnt, attnt, heads, causal, s_valid, S=S, hybrid=True)
    out_t.backward(torch.from_numpy(g).to(tdt))
    got = _leaves(xt.grad, {k: v.grad for k, v in lnt.items()},
                  {k: {n: t.grad for n, t in v.items()} for k, v in attnt.items()})
    want = {k: _np(v) for k, v in _leaves(dx_j, dln_j, dattn_j).items()}
    out_t, out_j = _np(out_t), _np(out_j)
    if dtype == "float32":
        np.testing.assert_allclose(out_t, out_j, atol=1e-5, rtol=1e-4)
    else:
        cos = (out_t * out_j).sum(-1) / (np.linalg.norm(out_t, axis=-1)
                                         * np.linalg.norm(out_j, axis=-1))
        assert cos.min() >= 0.999, cos.min()
    for name in want:
        a, b = _np(got[name]), want[name]
        if dtype == "float32":
            tol = (1e-5, 1e-4) if name == "dx" else (1e-4, 1e-4)
            np.testing.assert_allclose(a, b, atol=tol[0], rtol=tol[1], err_msg=name)
        else:
            cos = float(a.ravel() @ b.ravel() / (np.linalg.norm(a) * np.linalg.norm(b)))
            assert cos >= 0.999, (name, cos)


def test_hybrid_runs_k3_forward_and_k2_backward(monkeypatch):
    """The hybrid's forward is the composed sublayer over ``mha_core``, its
    backward ``attention_bwd.attention_sublayer_bwd``; it saves only x and
    the parameters."""
    from test_torch_attention_bwd import _torch_tree

    S, heads = HYBRID_S, HYBRID_HEADS
    x, g, ln, attn = _hybrid_inputs(seed=9)
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(M, "mha_core", spy("mha_core", M.mha_core))
    monkeypatch.setattr(TB, "attention_sublayer_bwd", spy("bwd", TB.attention_sublayer_bwd))
    monkeypatch.setattr(T, "attn_core", spy("attn_core", T.attn_core))
    xt = torch.from_numpy(x).requires_grad_()
    out = T.attention_sublayer(xt, _torch_tree(ln), _torch_tree(attn), heads, S=S,
                               hybrid=True)
    assert calls == ["mha_core"]
    saved = out.grad_fn.next_functions[0][0].saved_tensors  # under the reshape
    assert len(saved) == 6 and saved[0].shape == xt.shape
    out.backward(torch.from_numpy(g))
    assert calls == ["mha_core", "bwd"] and xt.grad is not None
    want = T.attention_sublayer_reference(xt.detach(), _torch_tree(ln), _torch_tree(attn),
                                          heads, S=S, hybrid=True)
    torch.testing.assert_close(out.detach(), want, rtol=0, atol=0)
