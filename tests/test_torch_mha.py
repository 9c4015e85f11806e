"""The port's attention cores against the JAX package's TPU kernels (CPU).

- K3: ``mha_core_reference`` against ``_pallas_mha`` in Pallas interpret
  mode at S = 16 (normalize-first) and S = 136 (deferred divide), causal or
  not, with and without pad columns (``s_valid`` = S - 5);
- K5: ``flash_core_reference`` against ``_pallas_flash_mha`` in interpret
  mode at S = 520, causal or not;
- K1's widened core: ``attention_sublayer_reference`` at S = 136 with
  ``s_valid`` against ``_pallas_attn_sublayer_flat`` in interpret mode, whose
  row core takes ``_pipe_fwd``'s deferred divide there.

Inputs are made with numpy from a seed and handed to both. Bars: fp32
allclose atol 1e-5. bf16 cores: at most one ulp apart, an ulp of the JAX
value (the rounding points are the same; the fp32 sums run in another order,
which can move a rounding by one step). The bf16 sublayer adds LN and two
projections whose fp32 sums also run in another order, so a cast of qkv may
round the other way and carry a step downstream: at least 90% of its values
are bit-equal and the rest one ulp of their row's largest value apart (with
a normalize-first core at S = 136 about 30% differ, by up to two). On the
CPU the wrappers take their plain versions, so no launch is counted here;
the kernels are tested on the card in ``test_torch_cuda.py``.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plip_tpu.ops.attention as A
from plip_tpu_torch.ops import attention as T
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


def _qkv(S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, 3 * W)).astype(np.float32)


def assert_close(got, want, dtype):
    """The module's bars: fp32 allclose 1e-5; bf16 within one ulp of want."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        return
    worst = (np.abs(got - want) / _bf16_ulp(want)).max()
    assert worst <= 1, f"{worst} bf16 ulps apart"


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def assert_same_rounding(got, want):
    """The bf16 sublayer's bar (module docstring)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    equal = (got == want).mean()
    assert equal >= 0.9, f"only {equal:.3f} of the values are bit-equal"
    row_ulp = _bf16_ulp(np.abs(want).max(-1, keepdims=True))
    worst = (np.abs(got - want) / row_ulp).max()
    assert worst <= 1, f"{worst} ulps of the row's largest value apart"


def _port(fn, qkv, dtype, *args):
    return fn(torch.from_numpy(qkv).to(DTYPES[dtype][0]), *args).float().numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S,causal,s_valid", [
    (S, causal, s_valid) for S in (16, 136) for causal in (False, True)
    for s_valid in (None, S - 5)])
def test_mha_core_matches_tpu_kernel(S, causal, s_valid, dtype):
    qkv = _qkv(S, seed=S + 2 * causal)
    want = A._pallas_mha(jnp.asarray(qkv, DTYPES[dtype][1]), HEADS, causal,
                         interpret=True, s_valid=s_valid)
    got = _port(M.mha_core_reference, qkv, dtype, S, HEADS, causal, s_valid)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
def test_flash_core_matches_tpu_kernel(causal, dtype):
    S = 520
    qkv = _qkv(S, seed=7 + causal)
    want = A._pallas_flash_mha(jnp.asarray(qkv, DTYPES[dtype][1]), HEADS, causal,
                               interpret=True)
    got = _port(M.flash_core_reference, qkv, dtype, S, HEADS, causal)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
def test_widened_attn_core_matches_tpu_kernel(causal, dtype):
    """K1 past S = 128: the flat sublayer with pad columns, deferred divide."""
    from test_torch_attention import _inputs, _torch_tree

    S, s_valid = 136, 131
    x, ln, attn = _inputs(S, seed=3 + causal)
    x = x[:B * S]
    tdt, jdt = DTYPES[dtype]
    want = A._pallas_attn_sublayer_flat(jnp.asarray(x, jdt), ln, attn, S, HEADS, causal,
                                        1e-5, interpret=True, s_valid=s_valid)
    got = T.attention_sublayer_reference(torch.from_numpy(x).to(tdt), _torch_tree(ln),
                                         _torch_tree(attn), HEADS, causal, s_valid, S=S)
    if dtype == "float32":
        assert_close(got.numpy(), want, dtype)
    else:
        assert_same_rounding(got.float().numpy(), want)


def test_k3_scales_q_before_the_dot_and_k1_after():
    """The two formulations differ where the scaled q rounds: in bf16 at a
    head_dim whose scale is not a power of two, K3 rounds ``q * D**-0.5`` to
    bf16 before the dot, K1 scales the fp32 logits after it."""
    S, heads, d = 16, 1, 24
    qkv = np.random.default_rng(0).standard_normal((1, S, 3 * d)).astype(np.float32)
    t = torch.from_numpy(qkv).bfloat16()
    q, k, v = t.float()[0].reshape(S, 3, d).unbind(1)

    def core(logits):
        return (torch.softmax(logits, -1).bfloat16().float() @ v).bfloat16()

    want3 = core((q * d ** -0.5).bfloat16().float() @ k.T)
    want1 = core(q @ k.T * d ** -0.5)
    k3 = M.mha_core_reference(t, S, heads)[0]
    k1 = T.attn_core_reference(t[0], S, heads)
    assert_close(k3.float().numpy(), want3.float().numpy(), "bfloat16")
    assert_close(k1.float().numpy(), want1.float().numpy(), "bfloat16")
    assert not torch.equal(k1, k3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_path(dtype):
    """On the CPU each wrapper is its plain version, differentiable, and
    launches nothing; flat and [B, S, 3W] inputs agree."""
    S = 20
    qkv = torch.from_numpy(_qkv(S, seed=1)).to(dtype)
    M.reset_launch_counts()
    for fn, ref, args in ((M.mha_core, M.mha_core_reference, (True, 17)),
                          (M.flash_core, M.flash_core_reference, (True,)),
                          (M.jnp_mha_core, M.jnp_mha_reference, (True,)),
                          (M.headgrid_core, M.headgrid_core_reference, (True,))):
        got = fn(qkv, S, HEADS, *args)
        assert got.shape == (B, S, W)
        torch.testing.assert_close(got, ref(qkv, S, HEADS, *args), rtol=0, atol=0)
        flat = fn(qkv.reshape(B * S, 3 * W), S, HEADS, *args)
        torch.testing.assert_close(flat, got.reshape(B * S, W), rtol=0, atol=0)
        leaf = qkv.float().requires_grad_()
        fn(leaf, S, HEADS, *args).sum().backward()
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all()
    assert M.LAUNCHES == {"mha_core": 0, "flash_core": 0, "mha_core_bwd": 0,
                          "headgrid_core": 0}


@pytest.mark.parametrize("core,S,match", [("mha_core", 140, "K4"),
                                          ("flash_core", 520, "flash backward")])
def test_card_backward_raises(core, S, match):
    """On a CUDA tensor a core runs under ``AttentionCoreFn``, whose backward
    (``match`` names it) is now the reference's: K4 (``mha_core_bwd``) for
    ``mha_core``; for ``flash_core``, which has no flash backward kernel in
    the JAX package either, the VJP of ``_jnp_mha``'s port. Neither leaves
    the grad empty, and a geometry K4 does not take raises on the card
    before a launch instead of falling back. The device check and the
    launches are mocked so that the CPU drives that path."""
    qkv = torch.from_numpy(_qkv(S, seed=2)).requires_grad_()
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((B, S, W)).astype(
        np.float32))
    ref = {"mha_core": M.mha_core_reference, "flash_core": M.flash_core_reference}[core]
    k4 = []

    def launch(name, t, S, heads, causal, s_valid):
        assert name == core
        return ref(t.detach(), S, heads, causal)

    def mha_core_bwd(*args):
        k4.append(match)
        return M.mha_core_bwd_reference(*args)

    with mock.patch.object(M, "_on_cpu", lambda t, name: False), \
            mock.patch.object(M, "_launch_core", launch), \
            mock.patch.object(M, "mha_core_bwd", mha_core_bwd):
        out = getattr(M, core)(qkv, S, HEADS)
        assert out.grad_fn is not None
        out.backward(g)
    if core == "mha_core":
        assert k4 == ["K4"]
        want = M.mha_core_bwd_reference(qkv.detach(), g, S, HEADS)
    else:
        assert k4 == []
        leaf = qkv.detach().requires_grad_()
        M.jnp_mha_reference(leaf, S, HEADS).backward(g)
        want = leaf.grad
    torch.testing.assert_close(qkv.grad, want, rtol=0, atol=0)
    # head_dim 136, which K4 refused before, passes its checks; 513 tokens do not
    assert M._check_core("mha_core_bwd", torch.zeros(B, 140, 3 * HEADS * 136), 140, HEADS,
                         None) == B * 140
    long = torch.zeros(B, 513, 3 * W)
    with mock.patch.object(M, "_on_cpu", lambda t, name: False), \
            pytest.raises(ValueError, match="S <= 512"):
        M.mha_core_bwd(long, torch.zeros(B, 513, W), 513, HEADS)


def test_core_geometry_is_checked():
    """What the wrappers refuse before a launch (checked with the device
    test mocked away: the CPU has no kernel to launch)."""
    cases = [(torch.zeros(2, 600, 3 * W), "mha_core", 600, "S <= 512"),
             (torch.zeros(2, 20, 3 * W), "flash_core", 21, "is not"),
             (torch.zeros(2, 20, 3 * W).half(), "mha_core", 20, "dtype")]
    for qkv, name, S, match in cases:
        with pytest.raises(ValueError, match=match):
            M._launch_core(name, qkv, S, HEADS, False, None)
    # head_dim 136 (and 256), which raised before: the key-tiled kernels take it
    for D in (136, 256):
        assert M._check_core("flash_core", torch.zeros(2, 20, 3 * HEADS * D), 20, HEADS,
                             None) == 40
