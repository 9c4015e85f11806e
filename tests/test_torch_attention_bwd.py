"""The port's attention-sublayer backward (K2) against the JAX package's (CPU).

The TPU kernel itself (``_pallas_attn_sublayer_bwd_flat`` in Pallas
interpret mode) is the oracle of the port's plain backward
(``attention_sublayer_bwd_reference``) and of the autograd function's CPU
backward; in fp32 ``torch.autograd`` through the plain forward is a second
one. Inputs are made with numpy from a seed. Bars: fp32 dx allclose atol
1e-5, rtol 1e-4, parameter grads atol 1e-4, rtol 1e-4; bf16 cosine >= 0.999
for every leaf.

On the CPU every wrapper takes its plain version, so no launch may be
counted; the CUDA kernels are held against these plain versions in
``test_torch_cuda.py`` on the card."""

import functools

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


B, W, HEADS = 4, 32, 2
CASES = [(S, causal, s_valid) for S in (10, 16) for causal in (False, True)
         for s_valid in (None, S - 3)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
LEAVES = ("dx", "ln.scale", "ln.bias", "qkv.kernel", "qkv.bias", "out.kernel", "out.bias")


def _inputs(S, seed):
    rng = np.random.default_rng(seed)

    def r(*shape, std=1.0):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    x, g = r(B * S, W, std=0.5), r(B * S, W)
    ln = {"scale": 1 + r(W, std=0.1), "bias": r(W, std=0.05)}
    attn = {"qkv": {"kernel": r(W, 3 * W, std=0.2), "bias": r(3 * W, std=0.1)},
            "out": {"kernel": r(W, W, std=0.2), "bias": r(W, std=0.1)}}
    return x, g, ln, attn


def _torch_tree(tree, requires_grad=False):
    return {k: _torch_tree(v, requires_grad) if isinstance(v, dict)
            else torch.from_numpy(v).requires_grad_(requires_grad)
            for k, v in tree.items()}


def _leaves(dx, dln, dattn):
    return dict(zip(LEAVES, (dx, dln["scale"], dln["bias"], dattn["qkv"]["kernel"],
                             dattn["qkv"]["bias"], dattn["out"]["kernel"],
                             dattn["out"]["bias"])))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


@functools.lru_cache(maxsize=None)
def _tpu_kernel(S, causal, s_valid, dtype):
    """K2 in Pallas interpret mode: the leaves as fp32 numpy."""
    x, g, ln, attn = _inputs(S, seed=S + 2 * causal)
    jdt = DTYPES[dtype][1]
    out = A._pallas_attn_sublayer_bwd_flat(jnp.asarray(x, jdt), jnp.asarray(g, jdt), ln,
                                           attn, S, HEADS, causal, 1e-5, interpret=True,
                                           s_valid=s_valid)
    return {k: _np(v) for k, v in _leaves(*out).items()}


def _assert_leaves(got, want, dtype):
    for name in LEAVES:
        a, b = _np(got[name]), want[name]
        assert a.shape == b.shape, name
        if dtype == "float32":
            tol = (1e-5, 1e-4) if name == "dx" else (1e-4, 1e-4)
            np.testing.assert_allclose(a, b, atol=tol[0], rtol=tol[1], err_msg=name)
        else:
            cos = float(a.ravel() @ b.ravel() / (np.linalg.norm(a) * np.linalg.norm(b)))
            assert cos >= 0.999, (name, cos)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S,causal,s_valid", CASES)
def test_bwd_reference_matches_tpu_kernel(S, causal, s_valid, dtype):
    x, g, ln, attn = _inputs(S, seed=S + 2 * causal)
    tdt = DTYPES[dtype][0]
    got = TB.attention_sublayer_bwd_reference(
        torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt), _torch_tree(ln),
        _torch_tree(attn), S, HEADS, causal, s_valid)
    _assert_leaves(_leaves(*got), _tpu_kernel(S, causal, s_valid, dtype), dtype)


def _autograd_grads(fn, x, g, ln, attn, tdt, S, causal, s_valid):
    """Grads of ``fn``'s output against ``g`` by loss.backward(): x's and the
    fp32 parameters'."""
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    lnt, attnt = _torch_tree(ln, True), _torch_tree(attn, True)
    out = fn(xt, lnt, attnt, HEADS, causal, s_valid, S=S)
    out.backward(torch.from_numpy(g).to(tdt))
    return {"dx": xt.grad, "ln.scale": lnt["scale"].grad, "ln.bias": lnt["bias"].grad,
            "qkv.kernel": attnt["qkv"]["kernel"].grad, "qkv.bias": attnt["qkv"]["bias"].grad,
            "out.kernel": attnt["out"]["kernel"].grad, "out.bias": attnt["out"]["bias"].grad}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S,causal,s_valid", CASES)
def test_autograd_backward_matches_tpu_kernel(S, causal, s_valid, dtype):
    """``attention_sublayer`` is differentiable: its autograd function's
    backward (on the CPU, the plain K2) gives the TPU kernel's grads, with
    fp32 parameter grads."""
    x, g, ln, attn = _inputs(S, seed=S + 2 * causal)
    tdt = DTYPES[dtype][0]
    got = _autograd_grads(T.attention_sublayer, x, g, ln, attn, tdt, S, causal, s_valid)
    assert got["dx"].dtype == tdt
    assert all(got[k].dtype == torch.float32 for k in LEAVES[1:])
    _assert_leaves(got, _tpu_kernel(S, causal, s_valid, dtype), dtype)


@pytest.mark.parametrize("S,causal,s_valid", CASES)
def test_autograd_backward_matches_plain_forward(S, causal, s_valid):
    """fp32: the K2 backward against torch.autograd through the plain
    (K1-rounded) forward."""
    x, g, ln, attn = _inputs(S, seed=S + 2 * causal + 1)
    got = _autograd_grads(T.attention_sublayer, x, g, ln, attn, torch.float32, S,
                          causal, s_valid)
    want = _autograd_grads(T.attention_sublayer_reference, x, g, ln, attn,
                           torch.float32, S, causal, s_valid)
    _assert_leaves(got, {k: _np(v) for k, v in want.items()}, "float32")


@pytest.mark.parametrize("S,causal,s_valid", [(10, False, None), (16, True, 13)])
def test_attn_core_bwd_reference_matches_autograd(S, causal, s_valid):
    """fp32: the core's pipelined backward against autograd through the
    forward core (normalize-first), and its recomputed context against that
    forward."""
    rng = np.random.default_rng(S)
    qkv = torch.from_numpy(rng.standard_normal((B * S, 3 * W)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((B * S, W)).astype(np.float32))
    ctx, dqkv = TB.attn_core_bwd_reference(qkv, g, S, HEADS, causal, s_valid)
    q = qkv.clone().requires_grad_()
    want = T.attn_core_reference(q, S, HEADS, causal, s_valid)
    want.backward(g)
    torch.testing.assert_close(ctx, want.detach(), atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(dqkv, q.grad, atol=1e-5, rtol=1e-4)


def test_ln_bwd_rows_reference_matches_autograd():
    """fp32: dx = g + LN backward, and the per-block partials of dgamma and
    dbeta (one a block of ``ln_bwd_split``'s rows), against autograd."""
    rng = np.random.default_rng(0)
    N = 21
    x = torch.from_numpy(rng.standard_normal((N, W)).astype(np.float32)).requires_grad_()
    scale = torch.from_numpy(1 + 0.1 * rng.standard_normal(W).astype(np.float32))
    bias = torch.zeros(W, requires_grad=True)
    scale.requires_grad_()
    dln = torch.from_numpy(rng.standard_normal((N, W)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((N, W)).astype(np.float32))
    T.layer_norm_rows_reference(x, scale, bias).backward(dln)
    dx, partial = TB.ln_bwd_rows_reference(x.detach(), dln, g, scale.detach())
    assert partial.shape == (-(-N // TB.ln_bwd_split(N, W)), 2 * W)
    torch.testing.assert_close(dx, g + x.grad, atol=1e-5, rtol=1e-4)
    sums = TB.col_sum_reference(partial)
    torch.testing.assert_close(sums[:W], scale.grad, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(sums[W:], bias.grad, atol=1e-5, rtol=1e-4)


def test_cpu_backward_launches_nothing():
    S, causal, s_valid = 16, True, 13
    x, g, ln, attn = _inputs(S, seed=9)
    T.reset_launch_counts()
    TB.reset_launch_counts()
    _autograd_grads(T.attention_sublayer, x, g, ln, attn, torch.bfloat16, S, causal,
                    s_valid)
    assert set(T.LAUNCHES.values()) == {0}
    assert TB.LAUNCHES == {"grad_gemm": 0, "attn_core_bwd": 0, "ln_bwd_rows": 0,
                           "col_sum": 0, "attention_sublayer_bwd": 0,
                           "attention_sublayer_bwd_split": 0}


def test_core_bwd_shared_memory_bound():
    """What the core's block keeps on chip (fp32 in either dtype: k and v
    resident, one query tile's q, g, e_c and ds_u): every head_dim up to 128
    fits at every length up to 128 tokens, and the ViT-B/32 shapes leave
    room for two blocks an SM."""
    smem = TB._core_bwd_smem_bytes
    for S in range(1, T.BWD_ROW_MAX_SEQ + 1):
        for D in range(1, T.ONE_BLOCK_MAX_HEAD_DIM + 1):
            assert smem(S, D) <= TB.MAX_SMEM, (S, D)
    assert 2 * (smem(50, 64) + 1024) <= 233472 and 2 * (smem(77, 64) + 1024) <= 233472
    assert smem(128, 128) > smem(128, 64) > smem(77, 64)
