"""Backward of a whole pre-LN block, ``remat="block"``.

The port of ``plip_tpu.ops.block_bwd``: the TPU kernel ``_block_bwd_kernel``
(K7) differentiates a whole block, attention sublayer and MLP half, from its
input x and the grad of its output, recomputing everything else. Here
``block_bwd`` runs the same chain through hand-written CUDA kernels, all of
which but the two GEMMs of ``csrc/mlp.cu`` the port already had:

  recompute  ``ln_rows`` (LN1), ``gemm_bias_residual`` (qkv), ``attn_core``
             normalize-first at every S (``defer=False``), ``gemm_bias_residual``
             (``y = x + ctx . Wout + bout``);
  MLP half   K8's chain on y (``ops.mlp.mlp_bwd_chain``: ``ln_rows``,
             ``gemm_bias_gelu``, ``grad_gemm``, ``gemm_nt_gelu_bwd``,
             ``ln_bwd_rows``, ``col_sum``) -> ``gy = gz + cast(dy_ln)``;
  attention  ``dWout = ctx^T . gy`` and ``dctx = cast(gy . Wout^T)``
             (``grad_gemm``), the core backward in K4's schedule
             (``ops.mha.mha_core_bwd``: fp32 P normalized first, logits
             scaled after the dot), ``dWqkv``, ``dln1`` and ``dx = gy +
             cast(dx_ln)`` (``grad_gemm``, ``ln_bwd_rows``, ``col_sum``).

The context is recomputed normalize-first even where the forward (K1 past
128 tokens) defers the divide: that is the reference's function, so in bf16
the backward's ctx is not bit-equal to the forward's. The TPU kernel sums the
weight grads per batch block in fp32 VMEM; here each sums all N token rows
(in the slices of ``attention_bwd.tn_slices``, ``col_sum`` adding them): only
the order of the fp32 sums differs. The grads come out fp32, the parameters' dtype.

``block_flat`` takes the kernel where the JAX package does
(``block_kernel_ok``: its TPU block picker and working-set budget, copied,
on the sequence length it runs the tower at, ``jax_seq_len``), through
``BlockFn``: the forward is K1's sublayer forward plus the composed MLP
half, as the JAX ``block_flat``'s (``plip_tpu/ops/block_bwd.py:475-480``),
and it saves only x and the parameters. Elsewhere the JAX package runs its composed block under a
recompute VJP; here that is ``torch.utils.checkpoint`` of the composed
block, the sublayer over ``mha_core`` (K3, backward K4) up to 512 tokens and
over ``jnp_mha_core`` (K12 forward, the ``_jnp_mha`` VJP) above, then the
composed MLP half. Above 512 the JAX package runs the tower padded with
``s_valid`` set, where ``fused_attention`` takes ``_jnp_mha``: normalize-first,
not K5's deferred divide (ViT-L/14@336px vision). The port also
needs ``S <= ops.mha.MAX_SEQ`` for the kernel, which K4's backward takes;
every tower the gate admits has it.

``block_bwd`` takes the plain PyTorch version (``block_bwd_reference``) only
for a tensor on the CPU; for a CUDA tensor it launches its kernels or raises.
``LAUNCHES["block_bwd"]`` counts its runs on the card.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch.utils.checkpoint import checkpoint

from .attention import (MAX_SEQ as MAX_FLAT_M, _check_geometry, _on_cpu, _sublayer,
                        attn_core, attn_core_reference, composed_sublayer,
                        gemm_bias_residual, gemm_bias_residual_reference,
                        layer_norm_rows_reference, ln_rows, sublayer_block_b)
from .attention_bwd import (col_sum, col_sum_reference, grad_gemm_nt,
                            grad_gemm_nt_reference, grad_gemm_tn, grad_gemm_tn_reference,
                            ln_bwd_rows, ln_bwd_rows_reference)
from .mha import MAX_SEQ as MHA_MAX_SEQ
from .mha import jnp_mha_core, mha_core, mha_core_bwd, mha_core_bwd_reference
from .mlp import KERNEL_FNS, REFERENCE_FNS, mlp_bwd_chain, mlp_half
from .tp import row_parallel, tp_epilogue, tp_epilogue_reference

# The JAX package's working-set budget for the TPU kernel (_block_pallas_ok).
VMEM_BUDGET = 100 * 1024 * 1024

LAUNCHES = {"block_bwd": 0}


def reset_launch_counts() -> None:
    LAUNCHES["block_bwd"] = 0


# ---------------------------------------------------------------------------
# The gate: the JAX package's, copied
# ---------------------------------------------------------------------------


def block_bwd_want(S: int) -> int:
    """``plip_tpu.ops.block_bwd._block_bwd_want``: 8 batch rows a TPU program
    up to 128 tokens, else 1."""
    return 8 if S <= 128 else 1


def block_vmem_bytes(S: int, W: int, W4: int, heads: int, bb: int) -> int:
    """``plip_tpu.ops.block_bwd._block_vmem_bytes``: the TPU kernel's working
    set (bf16 weights, fp32 grad accumulators, the p scratch, six [M, max(3W,
    W4)] fp32 temporaries)."""
    M = bb * S
    weights = 2 * (W * 3 * W + W * W + 2 * W * W4)
    grads = 4 * (W * 3 * W + W * W + 2 * W * W4)
    p_scr = 4 * heads * M * M
    temps = 6 * M * max(3 * W, W4) * 4
    return weights + grads + p_scr + temps


def block_kernel_ok(N: int, S: int, W: int, W4: int, heads: int,
                    act: str = "quick_gelu") -> bool:
    """``plip_tpu.ops.block_bwd._block_pallas_ok`` without its platform term:
    N token rows in sequences of S (the JAX package's S, ``jax_seq_len``),
    width W, MLP width W4. The JAX package sizes the budget with ``W // 64``
    heads; every tower of the config has head_dim 64, so its heads."""
    if not (S <= MAX_FLAT_M and act == "quick_gelu"):
        return False
    bb = sublayer_block_b(N // S, S, block_bwd_want(S))
    if bb is None:
        return False
    return block_vmem_bytes(S, W, W4, heads, bb) <= VMEM_BUDGET


def jax_seq_len(B: int, S: int, causal: bool) -> int:
    """The sequence length the JAX package runs a tower's blocks at under
    ``remat="block"``: the text tower (causal) padded to a multiple of 8
    (``plip_tpu.models.clip``), then padded to a multiple of 8 where no flat
    block of the batch exists unpadded (``plip_tpu.models.layers.transformer``;
    4 batch rows wanted, ``_flat_want``). The port runs the real S; pad rows
    and columns change nothing of the real tokens' function."""
    pad8 = -(-S // 8) * 8
    if causal:
        S = pad8
    if S <= MAX_FLAT_M and sublayer_block_b(B, S, 4) is None:
        if pad8 <= MAX_FLAT_M and sublayer_block_b(B, pad8, 4) is not None:
            return pad8
    return S


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

_ATTN_KERNELS = (ln_rows, gemm_bias_residual, attn_core, mha_core_bwd, grad_gemm_nt,
                 grad_gemm_tn, ln_bwd_rows, col_sum, tp_epilogue)
_ATTN_REFERENCES = (layer_norm_rows_reference, gemm_bias_residual_reference,
                    attn_core_reference, mha_core_bwd_reference, grad_gemm_nt_reference,
                    grad_gemm_tn_reference, ln_bwd_rows_reference, col_sum_reference,
                    tp_epilogue_reference)


def _block_bwd(x2, g2, p, S, heads, causal, eps, fns, mlp_fns, tp=None):
    """K7's chain. Under ``tp`` (``p`` this rank's shares, ``heads`` its
    heads) three sums over the group: the recompute's out-projection
    (``row_parallel``, before y and LN2), LN2's incoming grad (inside
    ``mlp_bwd_chain``) and ``dln1`` before LN1's backward."""
    ln_fn, gemm_fn, core_fn, core_bwd_fn, nt_fn, tn_fn, ln_bwd_fn, sum_fn, epi_fn = fns
    W, dt = x2.shape[1], x2.dtype
    ln1, attn = p["ln1"], p["attn"]
    wqkv, wout = attn["qkv"]["kernel"].to(dt), attn["out"]["kernel"].to(dt)
    h = ln_fn(x2, ln1["scale"], ln1["bias"], eps)
    qkv = gemm_fn(h, wqkv, attn["qkv"]["bias"])
    ctx = core_fn(qkv, S, heads, causal, None, False)  # normalize-first
    if tp is None:
        y = gemm_fn(ctx, wout, attn["out"]["bias"], x2)
    else:
        y = row_parallel(ctx, wout, attn["out"]["bias"], x2, tp, gemm_fn, epi_fn)
    gy, dln2, dmlp = mlp_bwd_chain(y, g2, p["ln2"], p["mlp"], eps, mlp_fns, tp)
    del y
    dwout, dbout = tn_fn(ctx, gy), sum_fn(gy)
    del ctx
    dqkv = core_bwd_fn(qkv, nt_fn(gy, wout, dt), S, heads, causal)
    del qkv
    dwqkv, dbqkv = tn_fn(h, dqkv), sum_fn(dqkv)
    dln1 = nt_fn(dqkv, wqkv, torch.float32)
    del dqkv
    if tp is not None:
        tp.all_reduce_(dln1)
    dx, partial = ln_bwd_fn(x2, dln1, gy, ln1["scale"], eps)
    dgb = sum_fn(partial)
    return dx, {"ln1": {"scale": dgb[:W], "bias": dgb[W:]},
                "attn": {"qkv": {"kernel": dwqkv, "bias": dbqkv},
                         "out": {"kernel": dwout, "bias": dbout}},
                "ln2": dln2, "mlp": dmlp}


def block_bwd_reference(x2: torch.Tensor, g2: torch.Tensor, p: Mapping, S: int, heads: int,
                        causal: bool = False, eps: float = 1e-5, tp=None):
    """The plain PyTorch version of ``block_bwd``, on any device."""
    return _block_bwd(x2, g2, p, S, heads, causal, eps, _ATTN_REFERENCES, REFERENCE_FNS, tp)


def block_bwd(x2: torch.Tensor, g2: torch.Tensor, p: Mapping, S: int, heads: int,
              causal: bool = False, eps: float = 1e-5, tp=None):
    """K7: from a block's flat input ``x2 [B*S, W]`` and its output's grad
    ``g2`` (the compute dtype) and the fp32 parameters ``p`` (``{"ln1",
    "attn", "ln2", "mlp"}``, the JAX package's tree; weights cast here),
    ``(dx2, dp)``: dx2 in the compute dtype, dp fp32 in p's tree. On the
    card S <= ``ops.mha.MAX_SEQ`` (K4's core backward), any head_dim. ``tp``: a
    ``parallel.distributed.TPGroup`` (``_block_bwd``)."""
    if _on_cpu(x2, "block_bwd"):
        return block_bwd_reference(x2, g2, p, S, heads, causal, eps, tp)
    _check_geometry(x2.shape[0], S, p["attn"]["out"]["kernel"].shape[0], heads, None,
                    MHA_MAX_SEQ, "block_bwd")
    out = _block_bwd(x2, g2, p, S, heads, causal, eps, _ATTN_KERNELS, KERNEL_FNS, tp)
    LAUNCHES["block_bwd"] += 1
    return out


_LEAVES = (("ln1", "scale"), ("ln1", "bias"), ("attn", "qkv", "kernel"),
           ("attn", "qkv", "bias"), ("attn", "out", "kernel"), ("attn", "out", "bias"),
           ("ln2", "scale"), ("ln2", "bias"), ("mlp", "fc1", "kernel"), ("mlp", "fc1", "bias"),
           ("mlp", "fc2", "kernel"), ("mlp", "fc2", "bias"))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _tree(leaves):
    out: dict = {}
    for path, t in zip(_LEAVES, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


class BlockFn(torch.autograd.Function):
    """A block on flat ``[B*S, W]`` tokens under autograd, as the JAX
    package's ``block_flat`` custom VJP: the forward is K1's sublayer
    (``ops.attention`` kernels) plus the composed MLP half, and it saves only
    x and the parameters; the backward is K7 (``block_bwd``). ``tp``: the
    parameters are this rank's shares (``_block_bwd``)."""

    @staticmethod
    def forward(ctx, x2, S, heads, causal, eps, tp, *leaves):
        ctx.save_for_backward(x2, *leaves)
        ctx.geometry = (S, heads, causal, eps, tp)
        p = _tree(leaves)
        h = _sublayer(x2, p["ln1"], p["attn"], heads, causal, None, eps, S, ln_rows,
                      gemm_bias_residual, attn_core, tp=tp)
        return mlp_half(h, p["ln2"], p["mlp"], eps, tp=tp)

    @staticmethod
    def backward(ctx, g2):
        x2, *leaves = ctx.saved_tensors
        dx, dp = block_bwd(x2, g2.contiguous(), _tree(leaves), *ctx.geometry)
        return (dx, None, None, None, None, None, *(_get(dp, path) for path in _LEAVES))


def composed_block(x: torch.Tensor, p: Mapping, heads: int, causal: bool = False,
                   eps: float = 1e-5, long_core=None, act: str = "quick_gelu",
                   tp=None) -> torch.Tensor:
    """The JAX package's ``_jnp_block_flat`` on ``[B, S, W]``: the composed
    sublayer over ``mha_core`` (S <= 512) or ``long_core`` (default
    ``jnp_mha_core``, the padded towers' core), then the composed MLP half
    with the activation ``act``; under ``tp`` both halves split
    (``composed_sublayer``, ``mlp_half``)."""
    S = x.shape[1]
    core = mha_core if S <= MHA_MAX_SEQ else (long_core or jnp_mha_core)
    h = composed_sublayer(x, p["ln1"], p["attn"], heads, causal, None, eps, S, core, tp=tp)
    return mlp_half(h, p["ln2"], p["mlp"], eps, act, tp)


def uses_kernel(B: int, S: int, W: int, W4: int, heads: int, causal: bool,
                act: str = "quick_gelu") -> bool:
    """Whether ``block_flat`` takes K7 for ``[B, S, W]`` tokens (the module
    doc): never with another activation than QuickGELU, the JAX gate."""
    S_jax = jax_seq_len(B, S, causal)
    return S <= MHA_MAX_SEQ and block_kernel_ok(B * S_jax, S_jax, W, W4, heads, act)


def block_flat(x: torch.Tensor, p: Mapping, heads: int, causal: bool = False,
               eps: float = 1e-5, act: str = "quick_gelu", tp=None) -> torch.Tensor:
    """A whole pre-LN block on ``x [B, S, W]`` under ``remat="block"``:
    ``BlockFn`` (backward K7) where ``uses_kernel``, else the composed block
    (with the activation ``act``) under ``torch.utils.checkpoint``. ``p``:
    ``{"ln1", "attn", "ln2", "mlp"}`` with fp32 parameters. ``tp``: ``p``
    holds this rank's shares and ``heads`` its heads; the gate is decided on
    the full geometry, so the path is the meshless one's."""
    B, S, W = x.shape
    n = 1 if tp is None else tp.size
    if uses_kernel(B, S, W, p["mlp"]["fc1"]["kernel"].shape[1] * n, heads * n, causal, act):
        out = BlockFn.apply(x.reshape(B * S, W), S, heads, causal, eps, tp,
                            *(_get(p, path) for path in _LEAVES))
        return out.reshape(x.shape)
    return checkpoint(composed_block, x, p, heads, causal, eps, None, act, tp,
                      use_reentrant=False)
