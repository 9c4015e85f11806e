"""The port's attention sublayer against the JAX package's (CPU).

The port's plain ``attention_sublayer_reference`` is held against the TPU
kernel itself (``_pallas_attn_sublayer_flat`` in Pallas interpret mode) and
against the composed JAX path the CPU towers take (``_jnp_attn_sublayer``).
Inputs are made with numpy from a seed and handed to both. Bars: fp32
allclose atol 1e-5, rtol 1e-4; bf16 per-row cosine >= 0.999.

On the CPU the wrappers take their plain versions, so no kernel launch may
be counted here; the CUDA kernels themselves are tested in
``test_torch_cuda.py`` on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plip_tpu.ops.attention as A
from plip_tpu_torch.ops import attention as T

B, W, HEADS = 4, 32, 2
CASES = [(S, causal, s_valid) for S in (10, 16) for causal in (False, True)
         for s_valid in (None, S - 3)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(S, seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape, std=1.0):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    x = r(B * S, W, std=0.5)
    ln = {"scale": 1 + r(W, std=0.1), "bias": r(W, std=0.05)}
    attn = {"qkv": {"kernel": r(W, 3 * W, std=0.2), "bias": r(3 * W, std=0.1)},
            "out": {"kernel": r(W, W, std=0.2), "bias": r(W, std=0.1)}}
    return x, ln, attn


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _port(x, ln, attn, S, causal, s_valid, dtype):
    out = T.attention_sublayer_reference(
        torch.from_numpy(x).to(dtype), _torch_tree(ln), _torch_tree(attn),
        HEADS, causal, s_valid, S=S)
    return out.float().numpy()


def _assert_close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    else:
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                      * np.linalg.norm(want, axis=-1))
        assert cos.min() >= 0.999, cos.min()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S,causal,s_valid", CASES)
def test_reference_matches_tpu_kernel(S, causal, s_valid, dtype):
    x, ln, attn = _inputs(S, seed=S + 2 * causal)
    tdt, jdt = DTYPES[dtype]
    want = A._pallas_attn_sublayer_flat(
        jnp.asarray(x, jdt), ln, attn, S, HEADS, causal, 1e-5,
        block_b=4 if S == 10 else 2, interpret=True, s_valid=s_valid)
    got = _port(x, ln, attn, S, causal, s_valid, tdt)
    _assert_close(got, np.asarray(want, np.float32), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S,causal,s_valid", CASES)
def test_reference_matches_composed_jax(S, causal, s_valid, dtype):
    x, ln, attn = _inputs(S, seed=S + 2 * causal + 1)
    tdt, jdt = DTYPES[dtype]
    want = A._jnp_attn_sublayer(jnp.asarray(x, jdt).reshape(B, S, W), ln, attn,
                                HEADS, causal, 1e-5, s_valid)
    got = _port(x, ln, attn, S, causal, s_valid, tdt)
    _assert_close(got, np.asarray(want, np.float32).reshape(B * S, W), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_path(dtype):
    """On the CPU every wrapper is its plain version and launches nothing."""
    S, causal, s_valid = 16, True, 13
    x, ln, attn = _inputs(S, seed=5)
    x = torch.from_numpy(x).to(dtype)
    ln, attn = _torch_tree(ln), _torch_tree(attn)
    T.reset_launch_counts()
    got = T.attention_sublayer(x.reshape(B, S, W), ln, attn, HEADS, causal, s_valid)
    flat = T.attention_sublayer(x, ln, attn, HEADS, causal, s_valid, S=S)
    want = T.attention_sublayer_reference(x, ln, attn, HEADS, causal, s_valid, S=S)
    torch.testing.assert_close(got.reshape(B * S, W), want, rtol=0, atol=0)
    torch.testing.assert_close(flat, want, rtol=0, atol=0)
    h = T.ln_rows(x, ln["scale"], ln["bias"])
    qkv = T.gemm_bias_residual(h, attn["qkv"]["kernel"].to(dtype), attn["qkv"]["bias"])
    T.attn_core(qkv, S, HEADS, causal, s_valid)
    assert T.LAUNCHES == {"ln_rows": 0, "gemm_bias_residual": 0, "attn_core": 0}


def test_flat_input_needs_sequence_length():
    x, ln, attn = _inputs(10)
    with pytest.raises(ValueError, match="sequence length"):
        T.attention_sublayer(torch.from_numpy(x), _torch_tree(ln), _torch_tree(attn),
                             HEADS)


def test_other_devices_raise():
    """A tensor that is neither on the CPU nor on a CUDA card has no path."""
    x = torch.empty(8, W, device="meta")
    scale = torch.empty(W, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        T.ln_rows(x, scale, scale)


@pytest.mark.parametrize("N,S,Wd,heads,s_valid,match", [
    (20, 6, 32, 2, None, "do not split"),
    (258, 129, 32, 2, None, "S <= 128"),
    (20, 10, 32, 3, None, "head_dim"),
    (20, 10, 512, 2, None, "head_dim"),
    (20, 10, 32, 2, 0, "s_valid"),
    (20, 10, 32, 2, 11, "s_valid"),
])
def test_kernel_geometry_is_checked(N, S, Wd, heads, s_valid, match):
    with pytest.raises(ValueError, match=match):
        T._check_geometry(N, S, Wd, heads, s_valid)
