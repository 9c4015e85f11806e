"""The port's dW-split sublayer backward (K6) and ``BWD_MODE`` against the
JAX package's (CPU).

- ``attention_sublayer_bwd_split_reference`` against
  ``_pallas_attn_sublayer_bwd_split`` in Pallas interpret mode at
  ``test_bwd_modes.py``'s cases (B=4, S=24, W=128, 2 heads, causal or not):
  fp32 with the JAX test's tolerances (dx 2e-5; the parameter grads rtol 2e-5,
  atol 2e-4); bf16 leaf cosine >= 0.999;
- the save-qkv round trip: K1's forward with its qkv kept gives the same
  output, a qkv equal to the JAX package's ``emit_qkv=True``, and the split
  backward fed it equals the one that recomputes it;
- the split backward against the port's K2 (tol 2e-5, as the JAX test);
- a two-layer ``Transformer`` under each ``BWD_MODE`` against
  ``plip_tpu.models.layers.transformer`` with ``_BWD_MODE`` set the same way
  under ``PLIP_TPU_INTERPRET=1``: fp32 leaf cosine > 0.9999 plus allclose
  5e-3, bf16 cosine >= 0.999; the backward each mode names ran once a layer;
- under ``"dwsplit_saveqkv"`` the forward is K1's even where the hybrid
  would run, as in the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plip_tpu.ops.attention as A
from plip_tpu.models import layers as jlayers
from plip_tpu_torch.models import layers as tlayers
from plip_tpu_torch.ops import attention as T
from plip_tpu_torch.ops import attention_bwd as TAB


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
B, S, W, HEADS = 4, 24, 128, 2


def _mk(seed, B=B, S=S, W=W):
    """x, g (numpy fp32) and the sublayer's parameters (numpy fp32 trees)."""
    rng = np.random.default_rng(seed)
    r = lambda *shape, std=1.0: (rng.standard_normal(shape) * std).astype(np.float32)
    ln = {"scale": 1.1 + r(W, std=0.05), "bias": 0.05 + r(W, std=0.02)}
    attn = {"qkv": {"kernel": r(W, 3 * W, std=0.02), "bias": r(3 * W, std=0.01)},
            "out": {"kernel": r(W, W, std=0.02), "bias": r(W, std=0.01)}}
    return r(B * S, W, std=0.5), r(B * S, W, std=0.3), ln, attn


def _t(tree, dtype=torch.float32):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)).to(dtype), tree)


def _flat(out):
    """{name: numpy fp32} of a (dx, dln, dattn) tree."""
    dx, dln, dattn = out
    return {"dx": np.asarray(dx.float() if isinstance(dx, torch.Tensor) else dx, np.float32),
            **{jax.tree_util.keystr(k): np.asarray(
                v.float() if isinstance(v, torch.Tensor) else v, np.float32)
               for k, v in jax.tree_util.tree_leaves_with_path({"ln": dln, "attn": dattn})}}


def _cos(a, b):
    a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _assert_grads_close(got, want, dtype="float32", tol=2e-5):
    """``test_bwd_modes.py``'s bars in fp32; leaf cosine >= 0.999 in bf16."""
    assert got.keys() == want.keys()
    for name in want:
        a, b = got[name], want[name]
        assert a.shape == b.shape, name
        if dtype == "bfloat16":
            assert _cos(a, b) >= 0.999, (name, _cos(a, b))
        else:
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol if name == "dx" else 2e-4,
                                       err_msg=name)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
def test_split_reference_matches_tpu_kernel(causal, dtype):
    tdt, jdt = DTYPES[dtype]
    x, g, ln, attn = _mk(seed=0)
    want = A._pallas_attn_sublayer_bwd_split(jnp.asarray(x, jdt), jnp.asarray(g, jdt), ln,
                                             attn, S, HEADS, causal, 1e-5, block_b=2,
                                             interpret=True)
    got = TAB.attention_sublayer_bwd_split_reference(
        torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt), _t(ln), _t(attn), S, HEADS,
        causal)
    assert got[0].dtype == tdt
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(got[1:]))
    _assert_grads_close(_flat(got), _flat(want), dtype)


def test_saveqkv_roundtrip():
    x, g, ln, attn = _mk(seed=5)
    xt, gt, lnt, attnt = torch.from_numpy(x), torch.from_numpy(g), _t(ln), _t(attn)
    plain = T.attention_sublayer_reference(xt, lnt, attnt, HEADS, True, S=S)
    out, qkv = T._sublayer(xt, lnt, attnt, HEADS, True, None, 1e-5, S,
                           T.layer_norm_rows_reference, T.gemm_bias_residual_reference,
                           T.attn_core_reference, emit_qkv=True)
    assert torch.equal(out, plain)
    _, qkv_j = A._pallas_attn_sublayer_flat(jnp.asarray(x), ln, attn, S, HEADS, True, 1e-5,
                                            block_b=2, interpret=True, emit_qkv=True)
    np.testing.assert_allclose(qkv.numpy(), np.asarray(qkv_j), rtol=1e-5, atol=1e-5)
    rec = TAB.attention_sublayer_bwd_split_reference(xt, gt, lnt, attnt, S, HEADS, True)
    sav = TAB.attention_sublayer_bwd_split_reference(xt, gt, lnt, attnt, S, HEADS, True,
                                                     qkv2=qkv)
    _assert_grads_close(_flat(sav), _flat(rec), tol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_split_matches_k2(causal):
    """The two backwards are one function."""
    x, g, ln, attn = _mk(seed=3)
    args = (torch.from_numpy(x), torch.from_numpy(g), _t(ln), _t(attn), S, HEADS, causal)
    _assert_grads_close(_flat(TAB.attention_sublayer_bwd_split(*args)),
                        _flat(TAB.attention_sublayer_bwd(*args)))


L, B_T, S_T, W_T, HEADS_T = 2, 4, 16, 64, 4


def _stacked(seed):
    rng = np.random.default_rng(seed)

    def r(*shape, std=1.0, mean=0.0):
        return (mean + rng.standard_normal((L,) + shape) * std).astype(np.float32)

    return {"ln1": {"scale": r(W_T, std=0.1, mean=1.0), "bias": r(W_T, std=0.05)},
            "attn": {"qkv": {"kernel": r(W_T, 3 * W_T, std=W_T ** -0.5),
                             "bias": r(3 * W_T, std=0.1)},
                     "out": {"kernel": r(W_T, W_T, std=W_T ** -0.5), "bias": r(W_T, std=0.1)}},
            "ln2": {"scale": r(W_T, std=0.1, mean=1.0), "bias": r(W_T, std=0.05)},
            "mlp": {"fc1": {"kernel": r(W_T, 4 * W_T, std=W_T ** -0.5),
                            "bias": r(4 * W_T, std=0.1)},
                    "fc2": {"kernel": r(4 * W_T, W_T, std=(4 * W_T) ** -0.5),
                            "bias": r(W_T, std=0.1)}}}


def _transformer(stacked, causal):
    tr = tlayers.Transformer(W_T, L, HEADS_T, causal)
    state = {}
    for i in range(L):
        for path, leaf in jax.tree_util.tree_leaves_with_path(stacked):
            state[f"{i}.{'.'.join(k.key for k in path)}"] = torch.from_numpy(
                np.ascontiguousarray(leaf[i]))
    tr.load_state_dict(state)
    return tr


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", T.BWD_MODES)
def test_transformer_under_each_mode_matches_jax(monkeypatch, mode, dtype):
    monkeypatch.setenv("PLIP_TPU_INTERPRET", "1")
    monkeypatch.setattr(A, "_BWD_MODE", mode)  # trace-time: set before jax.vjp
    monkeypatch.setattr(T, "BWD_MODE", mode)
    calls = {"attention_sublayer_bwd": 0, "attention_sublayer_bwd_split": 0}
    for name in calls:
        real = getattr(TAB, name)
        monkeypatch.setattr(TAB, name, lambda *a, _n=name, _f=real, **k: (
            calls.__setitem__(_n, calls[_n] + 1), _f(*a, **k))[1])
    tdt, jdt = DTYPES[dtype]
    stacked = _stacked(seed=2)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B_T, S_T, W_T)).astype(np.float32)
    g = rng.standard_normal((B_T, S_T, W_T)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda a, p: jlayers.transformer(a, p, HEADS_T, True, 1e-5,
                                                          remat="mlp"),
                         jnp.asarray(x, jdt), stacked)
    dx_j, dp_j = vjp(jnp.asarray(g, jdt))

    tr = _transformer(stacked, True)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    out_t = tr(xt, "mlp")
    out_t.backward(torch.from_numpy(g).to(tdt))
    want = {"out": np.asarray(out_j, np.float32), "dx": np.asarray(dx_j, np.float32)}
    got = {"out": out_t.detach().float().numpy(), "dx": xt.grad.float().numpy()}
    for path, leaf in jax.tree_util.tree_leaves_with_path(dp_j):
        name = ".".join(k.key for k in path)
        want[name] = np.asarray(leaf, np.float32)
        got[name] = np.stack([tr.get_parameter(f"{i}.{name}").grad.float().numpy()
                              for i in range(L)])
    for name in want:
        cos = _cos(got[name], want[name])
        if dtype == "float32":
            assert cos > 0.9999, (name, cos)
            np.testing.assert_allclose(got[name], want[name], atol=5e-3, rtol=5e-3,
                                       err_msg=name)
        else:
            assert cos >= 0.999, (name, cos)
    split = mode != "fused"
    assert calls == {"attention_sublayer_bwd": 0 if split else L,
                     "attention_sublayer_bwd_split": L if split else 0}


def test_saveqkv_wins_over_the_hybrid(monkeypatch):
    """``"dwsplit_saveqkv"``: the forward is K1's, with its qkv saved, where
    ``hybrid=True`` would take the composed one (the JAX package's saveqkv
    branch comes before its hybrid, ``_sub_flat_fwd``)."""
    monkeypatch.setenv("PLIP_TPU_INTERPRET", "1")
    monkeypatch.setattr(A, "_TRAIN_FWD_COMPOSED_OVERRIDE", True)
    x, g, ln, attn = _mk(seed=7)
    results = {}
    for mode in ("fused", "dwsplit_saveqkv"):
        monkeypatch.setattr(A, "_BWD_MODE", mode)
        monkeypatch.setattr(T, "BWD_MODE", mode)
        out_j, vjp = jax.vjp(lambda a, lp, ap: A.attention_sublayer_flat(a, lp, ap, S, HEADS,
                                                                         True),
                             jnp.asarray(x), ln, attn)
        leaves = [torch.from_numpy(a).requires_grad_() for a in (
            x, ln["scale"], ln["bias"], attn["qkv"]["kernel"], attn["qkv"]["bias"],
            attn["out"]["kernel"], attn["out"]["bias"])]
        out = T.AttentionSublayerFn.apply(*leaves, S, HEADS, True, None, 1e-5, True)
        saved = out.grad_fn.saved_tensors
        out.backward(torch.from_numpy(g))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=1e-5,
                                   atol=1e-5)
        dx_j, dln_j, dattn_j = vjp(jnp.asarray(g))
        np.testing.assert_allclose(leaves[0].grad.numpy(), np.asarray(dx_j), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(leaves[3].grad.numpy(), np.asarray(dattn_j["qkv"]["kernel"]),
                                   rtol=1e-4, atol=1e-4)
        results[mode] = (out.detach(), len(saved))
    kept = T._sublayer(torch.from_numpy(x), _t(ln), _t(attn), HEADS, True, None, 1e-5, S,
                       T.layer_norm_rows_reference, T.gemm_bias_residual_reference,
                       T.attn_core_reference)
    assert torch.equal(results["dwsplit_saveqkv"][0], kept)
    assert results["fused"][1] == 6 and results["dwsplit_saveqkv"][1] == 7
