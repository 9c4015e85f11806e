"""The port's whole-block backward (K7) and ``remat="block"`` / ``"mlp_h1"``
against the JAX package's (CPU).

- ``block_bwd_reference`` against ``_pallas_block_bwd_flat`` in Pallas
  interpret mode at ``test_block_bwd.py``'s three geometries (one causal),
  and unpadded at S = 13 against the JAX package padded to 16 with
  ``s_valid=13`` (the real rows of dx and every weight grad);
- the gate (``sublayer_block_b``, ``block_vmem_bytes``, ``block_kernel_ok``)
  against the JAX package's functions without their platform term, on the
  towers' shapes and edge batches, and the sequence length the JAX package
  runs each tower at;
- ``Transformer(remat="block")`` and ``(remat="mlp_h1")`` grads at tiny
  widths against ``plip_tpu.models.layers.transformer`` with
  ``PLIP_TPU_INTERPRET=1`` (K1, K2 and K7 in interpret mode there);
- the fallback (the composed block under ``torch.utils.checkpoint``)
  against ``jax.vjp`` of ``_jnp_block_flat``, at S = 12 and, above 512
  tokens, unpadded at S = 520 against the JAX package padded to 528 with
  ``s_valid=520`` (its core ``_jnp_mha``, normalize-first); control: K5's
  deferred core there fails the bf16 bar at the core's context.

Bars: fp32 ``allclose(rtol=1e-4, atol=1e-4)`` on dx and every leaf; bf16
leaf cosine >= 0.999, and the rounding points the chain passes through held
to the TPU kernel's: the core backward it runs against K4 (whose math K7's
core is, ``block_bwd.py:221-249``) on the same qkv and dctx, and the
activation against the TPU kernel's expression (``block_bwd.py:163-165``) on
the same h1, each with at most ``DIFFER`` of the elements not bit-equal and
every element within one bf16 ulp of its row's largest value. In bf16 the
whole chain's outputs carry about 4e-3 relative L2 of rounding noise
between the two frameworks (a flip anywhere propagates), more than either
schedule fault adds, so the faults are caught where they happen: the
controls (the core backward in K2's deferred schedule; the composed
forward's bf16 QuickGELU) each fail the bf16 test. The transformer bars:
fp32 leaf cosine > 0.9999 plus allclose 5e-3, bf16 cosine >= 0.999.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plip_tpu.ops.attention as A
import plip_tpu.ops.block_bwd as JB
from plip_tpu.models import layers as jlayers
from plip_tpu_torch.models import layers as tlayers
from plip_tpu_torch.ops import attention as T
from plip_tpu_torch.ops import attention_bwd as TAB
from plip_tpu_torch.ops import block_bwd as TB
from plip_tpu_torch.ops import mha as M
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
GEOMETRIES = [((120, 64), 10, 4, False), ((200, 96), 50, 6, False), ((160, 64), 80, 2, True)]


def _params(W, seed, layers=None):
    """A block's parameters (numpy fp32, the JAX package's tree), with a
    leading layer axis when ``layers`` is given."""
    rng = np.random.default_rng(seed)
    lead = () if layers is None else (layers,)

    def r(*shape, std=1.0, mean=0.0):
        return (mean + rng.standard_normal(lead + shape) * std).astype(np.float32)

    return {"ln1": {"scale": r(W, std=0.1, mean=1.0), "bias": r(W, std=0.05)},
            "attn": {"qkv": {"kernel": r(W, 3 * W, std=W ** -0.5), "bias": r(3 * W, std=0.1)},
                     "out": {"kernel": r(W, W, std=W ** -0.5), "bias": r(W, std=0.1)}},
            "ln2": {"scale": r(W, std=0.1, mean=1.0), "bias": r(W, std=0.05)},
            "mlp": {"fc1": {"kernel": r(W, 4 * W, std=W ** -0.5), "bias": r(4 * W, std=0.1)},
                    "fc2": {"kernel": r(4 * W, W, std=(4 * W) ** -0.5),
                            "bias": r(W, std=0.1)}}}


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def _leaves(dx, dp):
    return {"dx": _np(dx), **{jax.tree_util.keystr(k): _np(v)
                              for k, v in jax.tree_util.tree_leaves_with_path(dp)}}


def _cos(a, b):
    return float(a.ravel() @ b.ravel() / (np.linalg.norm(a) * np.linalg.norm(b)))


def _assert_leaves(got, want, dtype):
    assert got.keys() == want.keys()
    for name in want:
        a, b = got[name], want[name]
        assert a.shape == b.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=name)
        else:
            assert _cos(a, b) >= 0.999, (name, _cos(a, b))


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def _assert_rounding_point(name, got, want):
    """At most DIFFER of the elements not bit-equal, each within one bf16 ulp
    of its row's largest |value|."""
    got, want = _np(got), _np(want)
    differ = float((got != want).mean())
    worst = float((np.abs(got - want) / _bf16_ulp(np.abs(want).max(-1, keepdims=True))).max())
    assert differ <= DIFFER and worst <= 1, (name, differ, worst)


_MEMO = {}


def _once(key, fn):
    """``fn()`` once a module for ``key``: the controls rerun the cases'
    JAX references on the same inputs. A key holds every input, by value
    (``_digest``) where the port's run made it."""
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def _digest(*arrays):
    return tuple((a.shape, str(a.dtype), hashlib.sha1(np.ascontiguousarray(a).tobytes())
                  .hexdigest()) for a in map(np.asarray, arrays))


def _inputs(N, W, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, W)).astype(np.float32),
            rng.standard_normal((N, W)).astype(np.float32))


def _spied_block_bwd(x, g, p, S, heads, causal):
    """``block_bwd_reference`` with the inputs and outputs of its core
    backward and its activation recorded."""
    seen = {}
    attn_fns, mlp_fns = list(TB._ATTN_REFERENCES), list(TB.REFERENCE_FNS)
    core_bwd, gelu = attn_fns[3], mlp_fns[1]

    def core_spy(qkv, dctx, *a):
        seen["core"] = (qkv, dctx, core_bwd(qkv, dctx, *a))
        return seen["core"][2]

    def gelu_spy(h, w, b):
        out = gelu(h, w, b)
        seen["gelu"] = out
        return out

    attn_fns[3], mlp_fns[1] = core_spy, gelu_spy
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TB, "_ATTN_REFERENCES", tuple(attn_fns))
        mp.setattr(TB, "REFERENCE_FNS", tuple(mlp_fns))
        out = TB.block_bwd_reference(x, g, p, S, heads, causal)
    return out, seen


def _check_block_bwd(geometry, dtype):
    """The port's K7 against the TPU kernel (the module's bars)."""
    (N, W), S, heads, causal = geometry
    tdt, jdt = DTYPES[dtype]
    x, g = _inputs(N, W)
    p = _params(W, seed=3)
    want = _once(("K7", geometry, dtype), lambda: _leaves(*JB._pallas_block_bwd_flat(
        jnp.asarray(x, jdt), jnp.asarray(g, jdt), p, S, heads, causal, 1e-5, interpret=True)))
    (dx, dp), seen = _spied_block_bwd(torch.from_numpy(x).to(tdt),
                                      torch.from_numpy(g).to(tdt), _torch_tree(p), S,
                                      heads, causal)
    assert dx.dtype == tdt and all(t.dtype == torch.float32 for t in jax.tree.leaves(dp))
    _assert_leaves(_leaves(dx, dp), want, dtype)
    if dtype == "bfloat16":
        qkv, dctx, dqkv = seen["core"]
        qkv, dctx = _np(qkv), _np(dctx)
        k4 = _once(("K4", geometry, dtype) + _digest(qkv, dctx), lambda: np.asarray(
            A._pallas_mha_bwd(jnp.asarray(qkv, jdt).reshape(N // S, S, 3 * W),
                              jnp.asarray(dctx, jdt).reshape(N // S, S, W), heads, causal,
                              interpret=True), np.float32))
        _assert_rounding_point("core backward (K4)", dqkv, k4.reshape(N, 3 * W))
        h1, act = seen["gelu"]
        h32 = jnp.asarray(_np(h1))
        _assert_rounding_point("activation", act,
                               (h32 * jax.nn.sigmoid(1.702 * h32)).astype(jdt))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_block_bwd_reference_matches_tpu_kernel(geometry, dtype):
    _check_block_bwd(geometry, dtype)


def _deferred_core(qkv, dctx, S, heads, causal=False, s_valid=None):
    return TAB.attn_core_bwd_reference(qkv, dctx, S, heads, causal, s_valid)[1]


def _bf16_gelu(a, w, bias):
    h1 = T.gemm_bias_residual_reference(a, w, bias)
    return h1, TM.quick_gelu(h1)


@pytest.mark.parametrize("control", ["deferred core", "bf16 QuickGELU"])
def test_bf16_test_rejects_the_controls(monkeypatch, control):
    """The bf16 test fails the plain version with K2's deferred core backward,
    and with the composed forward's bf16 QuickGELU."""
    if control == "deferred core":
        fns = list(TB._ATTN_REFERENCES)
        fns[3] = _deferred_core
        monkeypatch.setattr(TB, "_ATTN_REFERENCES", tuple(fns))
    else:
        fns = list(TB.REFERENCE_FNS)
        fns[1] = _bf16_gelu
        monkeypatch.setattr(TB, "REFERENCE_FNS", tuple(fns))
    with pytest.raises(AssertionError):
        _check_block_bwd(GEOMETRIES[1], "bfloat16")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
def test_unpadded_block_bwd_matches_padded_tpu_kernel(causal, dtype):
    """The port runs S = 13 unpadded; the JAX package pads to 16, masks the
    pad columns (``s_valid``) and gives the pad rows a zero grad. The real
    rows of dx and every weight grad agree."""
    B, S, S_pad, W, heads = 4, 13, 16, 64, 4
    tdt, jdt = DTYPES[dtype]
    x, g = _inputs(B * S, W, seed=11 + causal)
    p = _params(W, seed=5)

    def pad(a):
        return np.pad(a.reshape(B, S, W), ((0, 0), (0, S_pad - S), (0, 0))).reshape(-1, W)

    dx_j, dp_j = JB._pallas_block_bwd_flat(jnp.asarray(pad(x), jdt), jnp.asarray(pad(g), jdt),
                                           p, S_pad, heads, causal, 1e-5, interpret=True,
                                           s_valid=S)
    want = _leaves(np.asarray(dx_j, np.float32).reshape(B, S_pad, W)[:, :S].reshape(-1, W),
                   dp_j)
    dx, dp = TB.block_bwd_reference(torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt),
                                    _torch_tree(p), S, heads, causal)
    _assert_leaves(_leaves(dx, dp), want, dtype)


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------

# (B, S as the JAX package runs it, W): the towers' shapes (ViT-B/32 vision
# and text, ViT-B/16 vision, ViT-L/14 vision and text, @336 vision), with
# whether the JAX package takes its kernel, and edge batches
TOWERS = [(128, 50, 768, True), (32, 50, 768, True), (128, 80, 512, True),
          (128, 77, 512, True), (32, 200, 768, True), (8, 200, 768, True),
          (64, 264, 1024, False), (64, 80, 768, False), (8, 80, 768, False),
          (64, 77, 768, False), (32, 584, 1024, False)]
EDGES = [(7, 50, 768), (13, 80, 512), (1, 197, 768), (5, 197, 768), (6, 197, 768),
         (3, 257, 768), (9, 120, 512), (2, 528, 768), (1, 1056, 768), (1, 1064, 768)]


@pytest.mark.parametrize("B,S,W", [t[:3] for t in TOWERS] + EDGES)
def test_gate_matches_jax(monkeypatch, B, S, W):
    monkeypatch.setattr(JB, "_use_pallas", lambda: True)
    W4, heads = 4 * W, W // 64
    for want in (1, 4, 8):
        assert T.sublayer_block_b(B, S, want) == A._sublayer_block_b(B, S, want)
    for bb in (1, 4, 8):
        assert TB.block_vmem_bytes(S, W, W4, heads, bb) == JB._block_vmem_bytes(
            S, W, W4, heads, bb)
    p = {"attn": {"qkv": {"kernel": jax.ShapeDtypeStruct((W, 3 * W), jnp.float32)}},
         "mlp": {"fc1": {"kernel": jax.ShapeDtypeStruct((W, W4), jnp.float32)}}}
    got = TB.block_kernel_ok(B * S, S, W, W4, heads)
    assert got == JB._block_pallas_ok(B * S, S, p, "quick_gelu")
    if (B, S, W) in [t[:3] for t in TOWERS]:
        assert got == dict(((t[:3]), t[3]) for t in TOWERS)[B, S, W]


# (B, real S, causal, S as the JAX package runs the tower's blocks)
SEQS = [(128, 50, False, 50), (128, 77, True, 80), (8, 77, True, 80), (32, 197, False, 200),
        (8, 197, False, 200), (4, 197, False, 197), (64, 257, False, 264),
        (32, 577, False, 584), (4, 13, True, 16), (4, 10, False, 10)]


@pytest.mark.parametrize("B,S,causal,want", SEQS)
def test_jax_seq_len(monkeypatch, B, S, causal, want):
    """The text tower pads to a multiple of 8 (``plip_tpu.models.clip``); the
    transformer pads where its flat gate fails unpadded and passes padded."""
    monkeypatch.setattr(A, "_use_pallas", lambda: True)
    assert TB.jax_seq_len(B, S, causal) == want
    S_text = -(-S // 8) * 8 if causal else S
    attn_p = {"qkv": {"kernel": None}}
    flat_ok = A._flat_pallas_ok(B * S_text, S_text, attn_p)
    assert (want == S_text) == (flat_ok or not A._flat_pallas_ok(B * want, want, attn_p))


@pytest.mark.parametrize("arch,batch,vision,text", [
    ("ViT-B/32", 128, True, True), ("ViT-B/32", 32, True, True),
    ("ViT-B/16", 32, True, True), ("ViT-B/16", 8, True, True),
    ("ViT-L/14", 64, False, False), ("ViT-L/14", 8, False, False),
    ("ViT-L/14@336px", 32, False, False)])
def test_towers_that_take_the_kernel(arch, batch, vision, text):
    from plip_tpu_torch.models.config import ARCHITECTURES

    cfg = ARCHITECTURES[arch]()
    v, t = cfg.vision, cfg.text
    assert TB.uses_kernel(batch, v.seq_len, v.width, 4 * v.width, v.heads, False) == vision
    assert TB.uses_kernel(batch, t.context_length, t.width, 4 * t.width, t.heads,
                          True) == text


# ---------------------------------------------------------------------------
# The towers
# ---------------------------------------------------------------------------

L, W_T, HEADS_T = 2, 64, 4


def _transformer(stacked, causal):
    tr = tlayers.Transformer(W_T, L, HEADS_T, causal)
    state = {}
    for i in range(L):
        for path, leaf in jax.tree_util.tree_leaves_with_path(stacked):
            name = ".".join(k.key for k in path)
            state[f"{i}.{name}"] = torch.from_numpy(np.ascontiguousarray(leaf[i]))
    tr.load_state_dict(state)
    return tr


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("remat", ["block", "mlp_h1"])
@pytest.mark.parametrize("B,S,causal", [(4, 10, False), (2, 16, True)])
def test_transformer_grads_match_jax(monkeypatch, remat, B, S, causal, dtype):
    monkeypatch.setenv("PLIP_TPU_INTERPRET", "1")
    calls = []
    real = JB._pallas_block_bwd_flat
    monkeypatch.setattr(JB, "_pallas_block_bwd_flat",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    tdt, jdt = DTYPES[dtype]
    stacked = _params(W_T, seed=2, layers=L)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, W_T)).astype(np.float32)
    g = rng.standard_normal((B, S, W_T)).astype(np.float32)

    def jax_fn(a, p):
        return jlayers.transformer(a, p, HEADS_T, causal, 1e-5, remat=remat)

    out_j, vjp = jax.vjp(jax_fn, jnp.asarray(x, jdt), stacked)
    dx_j, dp_j = vjp(jnp.asarray(g, jdt))
    assert bool(calls) == (remat == "block")  # the JAX package took K7

    tr = _transformer(stacked, causal)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    out_t = tr(xt, remat)
    out_t.backward(torch.from_numpy(g).to(tdt))
    got = {"out": _np(out_t), "dx": _np(xt.grad)}
    want = {"out": np.asarray(out_j, np.float32), "dx": np.asarray(dx_j, np.float32)}
    for path, leaf in jax.tree_util.tree_leaves_with_path(dp_j):
        name = ".".join(k.key for k in path)
        want[name] = np.asarray(leaf, np.float32)
        got[name] = np.stack([_np(tr.get_parameter(f"{i}.{name}").grad) for i in range(L)])
    for name in want:
        a, b = got[name], want[name]
        cos = _cos(a, b)
        if dtype == "float32":
            assert cos > 0.9999, (name, cos)
            np.testing.assert_allclose(a, b, atol=5e-3, rtol=5e-3, err_msg=name)
        else:
            assert cos >= 0.999, (name, cos)


def test_block_takes_blockfn_and_saves_only_x(monkeypatch):
    """Under "block" a ViT-B/32-shaped block (text, S=77, causal) goes
    through ``BlockFn``, whose forward saves x and the parameters only, and
    whose backward is ``block_bwd``."""
    calls = []
    monkeypatch.setattr(TB, "block_bwd", lambda *a: (calls.append(1),
                                                      TB.block_bwd_reference(*a))[1])
    blk = tlayers.Block(64, 1, causal=True)
    x = torch.randn(2, 77, 64, requires_grad=True)
    assert TB.uses_kernel(2, 77, 64, 256, 1, True)
    out = blk(x, "block")
    fn = out.grad_fn.next_functions[0][0]  # under the reshape
    assert type(fn).__name__ == "BlockFnBackward"
    saved = fn.saved_tensors
    assert len(saved) == 13 and saved[0].shape == (2 * 77, 64)
    assert sum(t.numel() for t in saved[1:]) == sum(p.numel() for p in blk.parameters())
    out.sum().backward()
    assert calls == [1] and x.grad is not None


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fallback_matches_jax_composed_vjp(monkeypatch, dtype):
    """Where the gate fails, the composed block under ``torch.utils.checkpoint``
    (its core ``mha_core``) against ``jax.vjp`` of ``_jnp_block_flat``."""
    B, S, W, heads = 2, 12, 64, 4
    tdt, jdt = DTYPES[dtype]
    monkeypatch.setattr(TB, "uses_kernel", lambda *a: False)
    cores = []
    real = M.mha_core
    monkeypatch.setattr(TB, "mha_core", lambda *a: (cores.append(1), real(*a))[1])
    p = _params(W, seed=8)
    x, g = _inputs(B * S, W, seed=9)
    out_j, vjp = jax.vjp(lambda a, q: JB._jnp_block_flat(a, q, S, heads, False, 1e-5,
                                                          "quick_gelu"),
                         jnp.asarray(x, jdt), p)
    want = _leaves(*vjp(jnp.asarray(g, jdt)))
    pt = _torch_tree(p)
    for leaf in jax.tree.leaves(pt):
        leaf.requires_grad_()
    xt = torch.from_numpy(x).to(tdt).view(B, S, W).requires_grad_()
    out = TB.block_flat(xt, pt, heads)
    out.backward(torch.from_numpy(g).to(tdt).view(B, S, W))
    assert len(cores) == 2  # the forward, and its recompute in the backward
    got = _leaves(xt.grad.reshape(-1, W), jax.tree.map(lambda t: t.grad, pt))
    _assert_leaves(got, want, dtype)


def _check_fallback_above_512(monkeypatch, dtype, long_core=None):
    """The composed block at S = 520 (its core ``jnp_mha_core``, or
    ``long_core``) against ``jax.vjp`` of ``_jnp_block_flat`` padded to 528
    with ``s_valid=520``: the real rows of dx and every weight grad with the
    module's bars; in bf16 the core's context also against ``_jnp_mha`` on
    the same qkv, with the rounding-point bar."""
    B, S, S_pad, W, heads = 2, 520, 528, 64, 4
    tdt, jdt = DTYPES[dtype]
    monkeypatch.setattr(TB, "uses_kernel", lambda *a: False)
    seen = []
    core = long_core or M.jnp_mha_core
    monkeypatch.setattr(TB, "jnp_mha_core", lambda *a: (seen.append((a[0], core(*a))),
                                                        seen[-1][1])[1])
    p = _params(W, seed=12)
    x, g = _inputs(B * S, W, seed=13)

    def pad(a):
        return np.pad(a.reshape(B, S, W), ((0, 0), (0, S_pad - S), (0, 0))).reshape(-1, W)

    def jax_grads():
        _, vjp = jax.vjp(lambda a, q: JB._jnp_block_flat(a, q, S_pad, heads, False, 1e-5,
                                                         "quick_gelu", s_valid=S),
                         jnp.asarray(pad(x), jdt), p)
        dx_j, dp_j = vjp(jnp.asarray(pad(g), jdt))
        return _leaves(np.asarray(dx_j, np.float32).reshape(B, S_pad, W)[:, :S]
                       .reshape(-1, W), dp_j)

    want = _once(("above 512", dtype), jax_grads)
    pt = _torch_tree(p)
    for leaf in jax.tree.leaves(pt):
        leaf.requires_grad_()
    xt = torch.from_numpy(x).to(tdt).view(B, S, W).requires_grad_()
    TB.block_flat(xt, pt, heads).backward(torch.from_numpy(g).to(tdt).view(B, S, W))
    assert len(seen) == 2  # the forward, and its recompute in the backward
    _assert_leaves(_leaves(xt.grad.reshape(-1, W), jax.tree.map(lambda t: t.grad, pt)), want,
                   dtype)
    if dtype == "bfloat16":
        qkv, ctx = seen[0]
        qkv = _np(qkv)
        ref = _once(("_jnp_mha", dtype) + _digest(qkv), lambda: np.asarray(
            A._jnp_mha(jnp.asarray(qkv, jdt).reshape(B, S, 3 * W), heads, False), np.float32))
        _assert_rounding_point("core context", ctx, ref)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fallback_above_512_matches_padded_jax(monkeypatch, dtype):
    """ViT-L/14@336px's "block" fallback: the JAX package pads the tower and
    its ``fused_attention`` takes ``_jnp_mha`` (normalize-first) above 512
    tokens with ``s_valid`` set; the port runs unpadded over
    ``jnp_mha_core``."""
    _check_fallback_above_512(monkeypatch, dtype)


def test_fallback_bar_rejects_the_flash_core(monkeypatch):
    """Control: ``flash_core`` (K5's deferred divide) there fails the bf16
    core bar."""
    with pytest.raises(AssertionError, match="core context"):
        _check_fallback_above_512(monkeypatch, "bfloat16", long_core=M.flash_core)
