"""The port's MLP-half kernels (K8, K9) and ``remat="mlp_h1"`` against the
JAX package's (CPU).

- ``mlp_bwd_reference`` and ``mlp_fwd_reference`` against
  ``_pallas_mlp_bwd_flat`` and ``_pallas_mlp_fwd_flat`` in Pallas interpret
  mode on ``test_fused_mlp.py``'s shapes;
- ``mlp_sublayer_flat``'s output and grads against the JAX package's (K8 in
  interpret mode there, ``PLIP_TPU_INTERPRET=1``), its forward the composed
  half, its gate against ``_mlp_pallas_ok``;
- the activation of the kernels (fp32 QuickGELU of the cast h1, one cast)
  against the TPU kernels' expression, and that it is not the composed
  forward's bf16 QuickGELU;
- ``mlp_half_h1`` (``remat="mlp_h1"``): autograd's grads of the composed
  half, saving only x and h1.

Bars: fp32 ``allclose(rtol=1e-4, atol=1e-4)`` on every output and leaf; bf16
leaf cosine >= 0.999, and in bf16 the outputs the TPU kernels cast (dx, the
forward's output) with at most 0.5% of their elements not bit-equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plip_tpu.ops.mlp as JM
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
SHAPES = [((120, 64), 10), ((200, 96), 50), ((64, 32), 8)]


def _params(W, seed):
    rng = np.random.default_rng(seed)

    def r(*shape, std=1.0, mean=0.0):
        return (mean + rng.standard_normal(shape) * std).astype(np.float32)

    return ({"scale": r(W, std=0.1, mean=1.0), "bias": r(W, std=0.05)},
            {"fc1": {"kernel": r(W, 4 * W, std=W ** -0.5), "bias": r(4 * W, std=0.1)},
             "fc2": {"kernel": r(4 * W, W, std=(4 * W) ** -0.5), "bias": r(W, std=0.1)}})


def _torch_tree(tree, requires_grad=False):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(requires_grad),
                        tree)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def _flat(*trees):
    return [_np(t) for t in jax.tree.leaves(trees)]


def _assert_close(got, want, dtype, cast=()):
    """The module's bars on lists of leaves; ``cast``: the indices of the
    outputs the TPU kernels cast, held in bf16 to at most 0.5% differing."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        if dtype == "float32":
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=str(i))
        else:
            cos = float(a.ravel() @ b.ravel() / (np.linalg.norm(a) * np.linalg.norm(b)))
            assert cos >= 0.999, (i, cos)
            if i in cast:
                assert (a != b).mean() <= 0.005, (i, (a != b).mean())


def _inputs(N, W, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, W)).astype(np.float32),
            rng.standard_normal((N, W)).astype(np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,S", SHAPES)
def test_mlp_bwd_reference_matches_tpu_kernel(shape, S, dtype):
    (N, W), (tdt, jdt) = shape, DTYPES[dtype]
    x, g = _inputs(N, W, seed=5)
    ln, p = _params(W, seed=2)
    want = JM._pallas_mlp_bwd_flat(jnp.asarray(x, jdt), jnp.asarray(g, jdt), ln, p, 1e-5, S=S,
                                   interpret=True)
    got = TM.mlp_bwd_reference(torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt),
                               _torch_tree(ln), _torch_tree(p))
    assert got[0].dtype == tdt
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(got[1:]))
    _assert_close(_flat(*got), _flat(*want), dtype, cast=(0,))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,S", SHAPES)
def test_mlp_fwd_reference_matches_tpu_kernel(shape, S, dtype):
    (N, W), (tdt, jdt) = shape, DTYPES[dtype]
    x, _ = _inputs(N, W, seed=9)
    ln, p = _params(W, seed=4)
    want = JM._pallas_mlp_fwd_flat(jnp.asarray(x, jdt), ln, p, 1e-5, S=S, interpret=True)
    got = TM.mlp_fwd_reference(torch.from_numpy(x).to(tdt), _torch_tree(ln), _torch_tree(p))
    assert got.dtype == tdt
    _assert_close([_np(got)], [_np(want)], dtype, cast=(0,))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlp_sublayer_flat_grads_match_jax(monkeypatch, dtype):
    """Output and grads of ``mlp_sublayer_flat`` against the JAX package's
    custom VJP with its kernel (interpret mode) as the backward."""
    monkeypatch.setenv("PLIP_TPU_INTERPRET", "1")
    calls = []
    monkeypatch.setattr(JM, "_pallas_mlp_bwd_flat", functools.partial(
        lambda *a, _f=JM._pallas_mlp_bwd_flat, **k: (calls.append(1), _f(*a, **k))[1]))
    (tdt, jdt), N, W, S = DTYPES[dtype], 40, 64, 10
    x, g = _inputs(N, W, seed=7)
    ln, p = _params(W, seed=9)
    out_j, vjp = jax.vjp(lambda a, b, c: JM.mlp_sublayer_flat(a, b, c, S), jnp.asarray(x, jdt),
                         ln, p)
    want = [_np(out_j)] + _flat(*vjp(jnp.asarray(g, jdt)))
    assert calls, "the JAX package did not take its kernel"
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    lnt, pt = _torch_tree(ln, True), _torch_tree(p, True)
    out = TM.mlp_sublayer_flat(xt, lnt, pt, S)
    out.backward(torch.from_numpy(g).to(tdt))
    got = [_np(out), _np(xt.grad)] + [_np(t.grad) for t in jax.tree.leaves((lnt, pt))]
    _assert_close(got, want, dtype, cast=(1,))


def test_mlp_sublayer_flat_forward_is_composed_and_saves_only_x():
    x, _ = _inputs(40, 32, seed=1)
    ln, p = _torch_tree(_params(32, seed=2)[0]), _torch_tree(_params(32, seed=2)[1])
    for t in jax.tree.leaves((ln, p)):
        t.requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    out = TM.mlp_sublayer_flat(xt, ln, p, 10)
    torch.testing.assert_close(out.detach(), TM.mlp_half(xt, ln, p).detach(), rtol=0, atol=0)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 7 and saved[0].shape == xt.shape


@pytest.mark.parametrize("N,S", [(40, 10), (6400, 50), (1576, 197), (7 * 197, 197), (6, 3)])
def test_mlp_gate_matches_jax(monkeypatch, N, S):
    monkeypatch.setattr(JM, "_use_pallas", lambda: True)
    assert TM.mlp_kernel_ok(N, S) == JM._mlp_pallas_ok(N, S, {"fc1": {"kernel": None}})


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_activation_is_fp32_quick_gelu_of_the_cast_h1(dtype):
    """``gemm_bias_gelu`` rounds where the TPU kernels do
    (``plip_tpu/ops/mlp.py:85-91``); in bf16 that is not the composed
    forward's QuickGELU on bf16 tensors."""
    (tdt, jdt), W = DTYPES[dtype], 64
    a, _ = _inputs(96, W, seed=3)
    _, p = _params(W, seed=6)
    h1, act = TM.gemm_bias_gelu_reference(torch.from_numpy(a).to(tdt),
                                          torch.from_numpy(p["fc1"]["kernel"]).to(tdt),
                                          torch.from_numpy(p["fc1"]["bias"]))
    h32 = jnp.asarray(_np(h1))
    want = np.asarray((h32 * jax.nn.sigmoid(1.702 * h32)).astype(jdt), np.float32)
    assert (_np(act) != want).mean() <= 0.005
    composed = _np(TM.quick_gelu(h1))
    if dtype == "float32":
        np.testing.assert_allclose(composed, want, rtol=1e-6, atol=1e-6)
    else:
        assert (composed != want).mean() > 0.05


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gelu_bwd_reference_is_quick_gelu_vjp(dtype):
    """``gemm_nt_gelu_bwd_reference`` is QuickGELU's VJP at the cast h1
    through fc2 (fp32 here: the one cast at the end is all that rounds)."""
    W, tdt = 32, DTYPES[dtype][0]
    g, _ = _inputs(48, W, seed=4)
    _, p = _params(W, seed=8)
    h = torch.from_numpy(np.random.default_rng(1).standard_normal((48, 4 * W))
                         .astype(np.float32)).to(tdt)
    w2 = torch.from_numpy(p["fc2"]["kernel"]).to(tdt)
    gt = torch.from_numpy(g).to(tdt)
    got = TM.gemm_nt_gelu_bwd_reference(gt, w2, h)
    hl = h.float().requires_grad_()
    (want,) = torch.autograd.grad(TM.quick_gelu(hl), hl, gt.float() @ w2.float().t())
    assert got.dtype == tdt
    torch.testing.assert_close(got.float(), want.to(tdt).float(), rtol=1e-2 if
                               dtype == "bfloat16" else 1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlp_half_h1_gives_the_composed_grads_saving_h1(dtype):
    """``remat="mlp_h1"``'s half: the composed half's output and autograd's
    grads (bf16 exactly; fp32 to the order of sums), having saved x and h1."""
    tdt = DTYPES[dtype][0]
    B, S, W = 2, 9, 32
    x, g = _inputs(B * S, W, seed=12)
    ln, p = _params(W, seed=13)

    def run(fn):
        lnt, pt = _torch_tree(ln, True), _torch_tree(p, True)
        xt = torch.from_numpy(x).to(tdt).view(B, S, W).requires_grad_()
        out = fn(xt, lnt, pt)
        saved = [tuple(t.shape) for t in getattr(out.grad_fn, "saved_tensors", ())
                 if t.dtype == tdt]
        out.backward(torch.from_numpy(g).to(tdt).view(B, S, W))
        return saved, [_np(out), _np(xt.grad)] + [_np(t.grad)
                                                   for t in jax.tree.leaves((lnt, pt))]

    saved, got = run(TM.mlp_half_h1)
    _, want = run(TM.mlp_half)
    if dtype == "bfloat16":  # in fp32 x and h1 are found among the fp32 parameters
        assert saved == [(B, S, W), (B, S, 4 * W)]
    for a, b in zip(got, want):
        if dtype == "bfloat16":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
