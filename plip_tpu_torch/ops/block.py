"""A whole pre-LN transformer block forward: ``transformer_block``.

The port of ``plip_tpu.ops.block``, whose TPU kernel ``_block_kernel`` (K10)
runs LN1, QKV, attention, out-projection and residual, then LN2, fc1,
QuickGELU, fc2 and residual, for a block of batch rows with every weight in
VMEM. Here the kernel path (``block_fwd``) is a chain of hand-written CUDA
kernels on flat ``[B*S, W]`` tokens:

  ``ln_rows`` (LN1), ``gemm_bias_residual`` (qkv), ``attn_core`` (K1's core
  at S <= 128: the fp32 logits scaled after the dot, normalize-first),
  ``gemm_bias_residual`` (``a = x + cast(ctx . Wout + bout)``), ``ln_rows``
  (LN2), ``ops.mlp.gemm_bias_gelu_f32`` (QuickGELU on the fp32 ``h1 = ln2 .
  W1 + b1``, one cast), ``gemm_bias_residual`` (``a + cast(act . W2 + b2)``).

The rounding points are the TPU kernel's (``block.py:61-107``): qkv, ctx,
the out-projection, the activation and fc2 are each cast once, with their
fp32 biases added before the cast. The activation is taken on the fp32 h1:
neither K7-K9's cast h1 nor the composed forward's bf16 tensors.

``transformer_block`` takes the kernel path where the JAX package takes its
kernel (S <= ``MAX_SEQ``, ``block.py:185``; the port has no quantized
weights), else the composed block: ``ops.block_bwd.composed_block`` over
``mha_core``, or ``flash_core`` above 512 tokens (``_jnp_block`` calls
``fused_attention`` without ``s_valid``, which takes K5 there). Under
autograd (``TransformerBlockFn``) it saves x and the parameters, and its
backward is the autograd of the composed block, recomputed, as the JAX
package's VJP (``block.py:194-197``): in bf16 not the exact derivative of
the kernel path, on the TPU as here. As in the JAX package, no tower runs it.

``block_fwd`` takes its plain version (``block_fwd_reference``) only for a
tensor on the CPU; for a CUDA tensor it launches its kernels or raises.
``LAUNCHES["block_fwd"]`` counts its runs on the card.
"""

from __future__ import annotations

from typing import Mapping

import torch

from .attention import (_on_cpu, attn_core, attn_core_reference, gemm_bias_residual,
                        gemm_bias_residual_reference, layer_norm_rows_reference, ln_rows)
from .block_bwd import _LEAVES, _get, _tree, composed_block
from .mha import flash_core
from .mlp import gemm_bias_gelu_f32, gemm_bias_gelu_f32_reference
from .tp import row_parallel, tp_epilogue, tp_epilogue_reference

# The JAX package's gate: the kernel takes sequences up to this length.
MAX_SEQ = 128

LAUNCHES = {"block_fwd": 0}

# (ln, gemm, core, activation GEMM, tp epilogue): the kernels and their plain versions
KERNEL_FNS = (ln_rows, gemm_bias_residual, attn_core, gemm_bias_gelu_f32, tp_epilogue)
REFERENCE_FNS = (layer_norm_rows_reference, gemm_bias_residual_reference, attn_core_reference,
                 gemm_bias_gelu_f32_reference, tp_epilogue_reference)


def reset_launch_counts() -> None:
    LAUNCHES["block_fwd"] = 0


def _block_fwd(x2, p, S, heads, causal, eps, fns, tp=None):
    """K10's chain; under ``tp`` (``p`` this rank's shares, ``heads`` its
    heads) the out-projection and fc2 are ``row_parallel``: two sums over
    the group, each through the epilogue kernel."""
    ln_fn, gemm_fn, core_fn, gelu_fn, epi_fn = fns
    dt = x2.dtype
    ln1, attn, ln2, mlp = p["ln1"], p["attn"], p["ln2"], p["mlp"]

    def out_proj(x, w, b, residual):
        if tp is None:
            return gemm_fn(x, w, b, residual)
        return row_parallel(x, w, b, residual, tp, gemm_fn, epi_fn)

    h = ln_fn(x2, ln1["scale"], ln1["bias"], eps)
    qkv = gemm_fn(h, attn["qkv"]["kernel"].to(dt), attn["qkv"]["bias"])
    ctx = core_fn(qkv, S, heads, causal, None, False)  # normalize-first
    a = out_proj(ctx, attn["out"]["kernel"].to(dt), attn["out"]["bias"], x2)
    act = gelu_fn(ln_fn(a, ln2["scale"], ln2["bias"], eps), mlp["fc1"]["kernel"].to(dt),
                  mlp["fc1"]["bias"])
    return out_proj(act, mlp["fc2"]["kernel"].to(dt), mlp["fc2"]["bias"], a)


def block_fwd_reference(x2: torch.Tensor, p: Mapping, S: int, heads: int,
                        causal: bool = False, eps: float = 1e-5, tp=None) -> torch.Tensor:
    """The plain PyTorch version of ``block_fwd``, on any device."""
    return _block_fwd(x2, p, S, heads, causal, eps, REFERENCE_FNS, tp)


def block_fwd(x2: torch.Tensor, p: Mapping, S: int, heads: int, causal: bool = False,
              eps: float = 1e-5, tp=None) -> torch.Tensor:
    """K10's kernel path: the block's output for flat tokens ``x2 [B*S, W]``
    (fp32 or bf16) with the TPU kernel's rounding; ``p`` fp32 (``{"ln1",
    "attn", "ln2", "mlp"}``, the JAX package's tree; weights cast here).
    ``tp``: a ``parallel.distributed.TPGroup`` (``_block_fwd``)."""
    if _on_cpu(x2, "block_fwd"):
        return block_fwd_reference(x2, p, S, heads, causal, eps, tp)
    out = _block_fwd(x2, p, S, heads, causal, eps, KERNEL_FNS, tp)
    LAUNCHES["block_fwd"] += 1
    return out


def _composed(x, p, heads, causal, eps, tp=None):
    """``_jnp_block``: the composed block, K5 above 512 tokens (no ``s_valid``)."""
    return composed_block(x, p, heads, causal, eps, long_core=flash_core, tp=tp)


class TransformerBlockFn(torch.autograd.Function):
    """``transformer_block`` under autograd (the module doc)."""

    @staticmethod
    def forward(ctx, x, heads, causal, eps, tp, *leaves):
        ctx.save_for_backward(x, *leaves)
        ctx.geometry = (heads, causal, eps, tp)
        p = _tree(leaves)
        B, S, W = x.shape
        if S <= MAX_SEQ:
            return block_fwd(x.reshape(B * S, W), p, S, heads, causal, eps,
                             tp).reshape(x.shape)
        return _composed(x, p, heads, causal, eps, tp)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            xs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            grads = torch.autograd.grad(_composed(xs[0], _tree(xs[1:]), *ctx.geometry), xs, g)
        return (grads[0], None, None, None, None, *grads[1:])


def transformer_block(x: torch.Tensor, p: Mapping, heads: int, causal: bool = False,
                      eps: float = 1e-5, tp=None) -> torch.Tensor:
    """One pre-LN transformer block (QuickGELU MLP) on ``x [B, S, W]``:
    ``block_fwd`` (K10) for S <= ``MAX_SEQ``, else the composed block;
    differentiable, the backward the composed block's (the module doc).
    ``p``: ``{"ln1", "attn", "ln2", "mlp"}`` with fp32 parameters; ``tp``:
    this rank's shares of them and its heads (``parallel.mesh``)."""
    return TransformerBlockFn.apply(x, heads, causal, eps, tp,
                                    *(_get(p, path) for path in _LEAVES))
