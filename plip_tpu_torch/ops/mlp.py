"""MLP half of the CLIP blocks: ``x + fc2(QuickGELU(fc1(LN2 x)))``.

The port of ``plip_tpu.ops.mlp``: the TPU kernels ``_mlp_fwd_kernel`` (K9)
and ``_mlp_bwd_kernel`` (K8). As in the JAX package neither is wired into
the towers, whose MLP half is the composed ``mlp_half`` (plain PyTorch); the
whole-block backward (``ops.block_bwd``, K7) runs K8's chain inside it. On a
CUDA tensor the functions here run hand-written kernels: two GEMMs with the
activation in their epilogue (``csrc/mlp.cu``),

- ``gemm_bias_gelu``: ``h1 = cast(a . w + bias)`` and ``act = cast(h *
  sigmoid(1.702 h))`` with ``h`` the cast ``h1`` in fp32;
- ``gemm_nt_gelu_bwd``: ``dh1 = cast(fp32(g . w^T) * (s + 1.702 h s (1 -
  s)))``, ``s = sigmoid(1.702 h)``;
- ``gemm_bias_gelu_f32``: ``act = cast(h * sigmoid(1.702 h))`` with ``h = a .
  w + bias`` the fp32 sum, never cast: the whole-block forward's rounding
  (K10, ``ops.block``);

and K1's and K2's kernels (``ops.attention``, ``ops.attention_bwd``) around
them:

- ``mlp_fwd_flat`` (K9): ``ln_rows``, ``gemm_bias_gelu``,
  ``gemm_bias_residual`` (fc2, its fp32 bias and the residual);
- ``mlp_bwd_flat`` (K8): from x and the output's grad g, ``dx = g +
  cast(dx_ln)`` and the fp32 grads of LN2, fc1 and fc2, recomputing LN2, h1
  and the activation;
- ``mlp_sublayer_flat``: the half as an autograd function, as the JAX
  package's custom VJP: the forward is the composed ``mlp_half``, it saves
  only x and the parameters, and its backward is K8 where
  ``mlp_kernel_ok`` says the JAX package takes its kernel.

Each has its plain PyTorch version (``*_reference``), which a wrapper takes
only for a tensor on the CPU; for a CUDA tensor it launches its kernels or
raises. ``LAUNCHES`` counts the launches.

The rounding points are the TPU kernels', which are not the composed
forward's: there QuickGELU runs on compute-dtype tensors, here in fp32 on the
cast h1, with one cast; fc2 adds its fp32 bias before its cast.

``mlp_half_h1`` is the MLP half of ``remat="mlp_h1"``: the composed forward,
saving only x and the fc1 output h1; its backward recomputes LN2 and the
activation, not the fc1 product.

The composed halves (``mlp_half``, ``mlp_half_h1``) take the activation
``act`` of the JAX package's ``ACTIVATIONS``: ``"quick_gelu"`` (the CLIP
towers'), ``"gelu"`` (erf-exact, the torchvision ViT classifier's) or
``"relu"``. The kernels above are QuickGELU's only, as the JAX package's.
"""

from __future__ import annotations

import ctypes
from typing import Mapping

import torch

from . import _build
from ..parallel.distributed import copy_to_tp
from .attention import (_check, _dtype_code, _on_cpu, _stream, gemm_bias_residual,
                        gemm_bias_residual_reference, gemm_tile, layer_norm_rows,
                        layer_norm_rows_reference, linear, ln_rows, sublayer_block_b)
from .attention_bwd import (col_sum, col_sum_reference, grad_gemm_nt,
                            grad_gemm_nt_reference, grad_gemm_tn, grad_gemm_tn_reference,
                            ln_bwd_rows, ln_bwd_rows_reference)
from .tp import row_linear, row_parallel

LAUNCHES = {"gemm_bias_gelu": 0, "gemm_nt_gelu_bwd": 0, "mlp_fwd": 0, "mlp_bwd": 0,
            "gemm_bias_gelu_f32": 0}

_vp, _int = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # a, w, bias, h (may be null), act, M, N, K, tile, dtype, device, stream
    "plip_gemm_bias_gelu": (_vp, _vp, _vp, _vp, _vp, _int, _int, _int, _int, _int, _int,
                            _vp),
    # a, w, bias, act, M, N, K, tile, dtype, device, stream
    "plip_gemm_bias_gelu_f32": (_vp, _vp, _vp, _vp, _int, _int, _int, _int, _int, _int,
                                _vp),
    # g, w, h, dh, M, N, K, tile, dtype, device, stream
    "plip_gemm_nt_gelu_bwd": (_vp, _vp, _vp, _vp, _int, _int, _int, _int, _int, _int, _vp),
}
_kernels = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _kernels
    if _kernels is None:
        _kernels = _build.bind(_SIGNATURES)
    return _kernels


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error {rc}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# The composed half (the towers' forward)
# ---------------------------------------------------------------------------


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """QuickGELU: x * sigmoid(1.702 x), the CLIP activation, in x's dtype."""
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The erf-exact GELU (``torch.nn.GELU``'s default, which the torchvision
    ViTs use), in x's dtype."""
    return torch.nn.functional.gelu(x)


# the MLP activations of plip_tpu.models.layers.ACTIVATIONS
ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": gelu, "relu": torch.relu}


def mlp(x: torch.Tensor, p: Mapping, act: str = "quick_gelu") -> torch.Tensor:
    return linear(ACTIVATIONS[act](linear(x, p["fc1"])), p["fc2"])


def mlp_half(x: torch.Tensor, ln: Mapping, p: Mapping, eps: float = 1e-5,
             act: str = "quick_gelu", tp=None) -> torch.Tensor:
    """``x + mlp(LN2 x)``: the JAX package's composed MLP half (the
    projections and the activation ``act`` in the compute dtype; LN2
    ``layer_norm_rows``, K1's and K2's LayerNorm kernels on the card).
    ``tp`` (a ``parallel.distributed.TPGroup``; ``p`` this rank's shares):
    ``copy_to_tp`` on LN2's output, fc1 on this rank's columns, the
    activation, fc2 on its rows to an fp32 partial, the sum over the group
    and the bias and residual in K1's epilogue (``row_linear``)."""
    h = layer_norm_rows(x, ln["scale"], ln["bias"], eps)
    if tp is None:
        return x + mlp(h, p, act)
    return row_linear(ACTIVATIONS[act](linear(copy_to_tp(h, tp), p["fc1"])), p["fc2"], x, tp)


# ---------------------------------------------------------------------------
# gemm_bias_gelu, gemm_bias_gelu_f32, gemm_nt_gelu_bwd
# ---------------------------------------------------------------------------


def _gelu_fp32(h: torch.Tensor):
    """(fp32 h, sigmoid(1.702 h)) of the cast h1."""
    h32 = h.float()
    return h32, torch.sigmoid(1.702 * h32)


def _check_gemm(name: str, a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    """Check ``a [M, K]``, ``w [K, N]`` (a's dtype) and the fp32 ``bias [N]``
    of a forward GEMM; return (M, N, K)."""
    M, K = a.shape
    N = w.shape[-1]
    bf = a.dtype == torch.bfloat16
    if bf and (K % 8 or N % 8):
        raise ValueError(f"{name}: bf16 needs K % 8 == 0 and N % 8 == 0, got K={K}, N={N}")
    _check(f"{name} a", a, a.device, a.dtype, (M, K), align16=bf)
    _check(f"{name} w", w, a.device, a.dtype, (K, N), align16=bf)
    _check(f"{name} bias", bias, a.device, torch.float32, (N,), align16=bf)
    return M, N, K


def gemm_bias_gelu_reference(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                             keep_h: bool = True):
    """(``h1 = cast(a . w + bias)`` or None unless ``keep_h``, ``act = cast(h *
    sigmoid(1.702 h))``), h the cast h1 in fp32; exact products of the
    operands, fp32 sum."""
    h1 = torch.addmm(bias.float(), a.float(), w.float()).to(a.dtype)
    h32, s = _gelu_fp32(h1)
    return (h1 if keep_h else None), (h32 * s).to(a.dtype)


def gemm_bias_gelu(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   keep_h: bool = True):
    """``a [M, K] . w [K, N] + bias [N]`` through QuickGELU -> (``h1`` or None
    unless ``keep_h``, ``act``), both ``[M, N]`` in a's dtype. ``w`` has a's
    dtype, ``bias`` is fp32. In bf16, K and N must be multiples of 8 and
    every tensor 16-byte aligned."""
    if _on_cpu(a, "gemm_bias_gelu"):
        return gemm_bias_gelu_reference(a, w, bias, keep_h)
    code = _dtype_code("gemm_bias_gelu", a)
    M, N, K = _check_gemm("gemm_bias_gelu", a, w, bias)
    act = torch.empty((M, N), dtype=a.dtype, device=a.device)
    h1 = torch.empty_like(act) if keep_h else None
    _launch("gemm_bias_gelu", _lib().plip_gemm_bias_gelu, a.data_ptr(), w.data_ptr(),
            bias.data_ptr(), None if h1 is None else h1.data_ptr(), act.data_ptr(), M, N, K,
            gemm_tile(a, M, N), code, a.device.index, _stream(a.device))
    return h1, act


def gemm_bias_gelu_f32_reference(a: torch.Tensor, w: torch.Tensor,
                                 bias: torch.Tensor) -> torch.Tensor:
    """``cast(h * sigmoid(1.702 h))``, ``h = a . w + bias`` in fp32 (exact
    products of the operands, fp32 sum, no cast before the activation)."""
    h32 = torch.addmm(bias.float(), a.float(), w.float())
    return (h32 * torch.sigmoid(1.702 * h32)).to(a.dtype)


def gemm_bias_gelu_f32(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``a [M, K] . w [K, N] + bias [N]`` through QuickGELU on the fp32 sum ->
    ``act [M, N]`` in a's dtype. ``w`` has a's dtype, ``bias`` is fp32. In
    bf16, K and N must be multiples of 8 and every tensor 16-byte aligned."""
    if _on_cpu(a, "gemm_bias_gelu_f32"):
        return gemm_bias_gelu_f32_reference(a, w, bias)
    code = _dtype_code("gemm_bias_gelu_f32", a)
    M, N, K = _check_gemm("gemm_bias_gelu_f32", a, w, bias)
    act = torch.empty((M, N), dtype=a.dtype, device=a.device)
    _launch("gemm_bias_gelu_f32", _lib().plip_gemm_bias_gelu_f32, a.data_ptr(), w.data_ptr(),
            bias.data_ptr(), act.data_ptr(), M, N, K, gemm_tile(a, M, N), code, a.device.index,
            _stream(a.device))
    return act


def gemm_nt_gelu_bwd_reference(g: torch.Tensor, w: torch.Tensor,
                               h: torch.Tensor) -> torch.Tensor:
    """``cast(fp32(g . w^T) * (s + 1.702 h s (1 - s)))``, s = sigmoid(1.702 h)."""
    da = torch.matmul(g.float(), w.float().t())
    h32, s = _gelu_fp32(h)
    return (da * (s + 1.702 * h32 * s * (1.0 - s))).to(g.dtype)


def gemm_nt_gelu_bwd(g: torch.Tensor, w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """QuickGELU's VJP through fc2: ``g [M, K]``, fc2's weight ``w [N, K]``
    (``[in, out]``, in = N) and the cast fc1 output ``h [M, N]`` -> ``dh1 [M,
    N]``, all in g's dtype. In bf16, K and N must be multiples of 8 and
    every tensor 16-byte aligned (16-byte chunks, as ``gemm_bias_gelu``)."""
    if _on_cpu(g, "gemm_nt_gelu_bwd"):
        return gemm_nt_gelu_bwd_reference(g, w, h)
    code = _dtype_code("gemm_nt_gelu_bwd", g)
    M, K = g.shape
    N = w.shape[0]
    bf = g.dtype == torch.bfloat16
    if bf and (K % 8 or N % 8):
        raise ValueError(f"gemm_nt_gelu_bwd: bf16 needs K % 8 == 0 and N % 8 == 0, "
                         f"got K={K}, N={N}")
    _check("gemm_nt_gelu_bwd g", g, g.device, g.dtype, (M, K), align16=bf)
    _check("gemm_nt_gelu_bwd w", w, g.device, g.dtype, (N, K), align16=bf)
    _check("gemm_nt_gelu_bwd h", h, g.device, g.dtype, (M, N), align16=bf)
    dh = torch.empty((M, N), dtype=g.dtype, device=g.device)
    _launch("gemm_nt_gelu_bwd", _lib().plip_gemm_nt_gelu_bwd, g.data_ptr(), w.data_ptr(),
            h.data_ptr(), dh.data_ptr(), M, N, K, gemm_tile(g, M, N), code, g.device.index,
            _stream(g.device))
    return dh


# ---------------------------------------------------------------------------
# K9, K8
# ---------------------------------------------------------------------------

# (ln, gelu, gelu_bwd, nt, tn, ln_bwd, col_sum, residual gemm): the kernels
# and their plain versions
KERNEL_FNS = (ln_rows, gemm_bias_gelu, gemm_nt_gelu_bwd, grad_gemm_nt, grad_gemm_tn,
              ln_bwd_rows, col_sum, gemm_bias_residual)
REFERENCE_FNS = (layer_norm_rows_reference, gemm_bias_gelu_reference,
                 gemm_nt_gelu_bwd_reference, grad_gemm_nt_reference,
                 grad_gemm_tn_reference, ln_bwd_rows_reference, col_sum_reference,
                 gemm_bias_residual_reference)


def _mlp_fwd(x2, ln, p, eps, fns):
    ln_fn, gelu_fn, gemm_fn = fns[0], fns[1], fns[7]
    dt = x2.dtype
    h = ln_fn(x2, ln["scale"], ln["bias"], eps)
    act = gelu_fn(h, p["fc1"]["kernel"].to(dt), p["fc1"]["bias"], False)[1]
    return gemm_fn(act, p["fc2"]["kernel"].to(dt), p["fc2"]["bias"], x2)


def mlp_bwd_chain(x2, g2, ln, p, eps, fns, tp=None):
    """K8's chain: ``(dx2, dln, dmlp)``; K7 runs it on its recomputed y.
    Under ``tp`` (``p`` this rank's shares) LN2's incoming grad is the fp32
    sum over the group of the ranks' ``dh1 . W1^T``."""
    ln_fn, gelu_fn, gelu_bwd_fn, nt_fn, tn_fn, ln_bwd_fn, sum_fn, _ = fns
    W, dt = x2.shape[1], x2.dtype
    w1, w2 = p["fc1"]["kernel"].to(dt), p["fc2"]["kernel"].to(dt)
    h = ln_fn(x2, ln["scale"], ln["bias"], eps)
    h1, act = gelu_fn(h, w1, p["fc1"]["bias"])
    dw2 = tn_fn(act, g2)
    del act  # the [N, 4W] buffers live one at a time where they can
    dh1 = gelu_bwd_fn(g2, w2, h1)
    del h1
    dw1, db1 = tn_fn(h, dh1), sum_fn(dh1)
    dln = nt_fn(dh1, w1, torch.float32)
    del dh1
    if tp is not None:
        tp.all_reduce_(dln)
    dx, partial = ln_bwd_fn(x2, dln, g2, ln["scale"], eps)
    dgb = sum_fn(partial)
    return dx, {"scale": dgb[:W], "bias": dgb[W:]}, {
        "fc1": {"kernel": dw1, "bias": db1}, "fc2": {"kernel": dw2, "bias": sum_fn(g2)}}


def mlp_fwd_reference(x2: torch.Tensor, ln: Mapping, p: Mapping,
                      eps: float = 1e-5) -> torch.Tensor:
    """The plain PyTorch version of ``mlp_fwd_flat``, on any device."""
    return _mlp_fwd(x2, ln, p, eps, REFERENCE_FNS)


def mlp_fwd_flat(x2: torch.Tensor, ln: Mapping, p: Mapping,
                 eps: float = 1e-5) -> torch.Tensor:
    """K9: ``x + fc2(QuickGELU(fc1(LN2 x)))`` of flat tokens ``x2 [N, W]`` (fp32
    or bf16) with the TPU kernel's rounding; ``ln``/``p`` fp32 (the weights
    are cast to x's dtype here)."""
    if _on_cpu(x2, "mlp_fwd"):
        return mlp_fwd_reference(x2, ln, p, eps)
    out = _mlp_fwd(x2, ln, p, eps, KERNEL_FNS)
    LAUNCHES["mlp_fwd"] += 1
    return out


def mlp_bwd_reference(x2: torch.Tensor, g2: torch.Tensor, ln: Mapping, p: Mapping,
                      eps: float = 1e-5):
    """The plain PyTorch version of ``mlp_bwd_flat``, on any device."""
    return mlp_bwd_chain(x2, g2, ln, p, eps, REFERENCE_FNS)


def mlp_bwd_flat(x2: torch.Tensor, g2: torch.Tensor, ln: Mapping, p: Mapping,
                 eps: float = 1e-5):
    """K8: from the flat input ``x2 [N, W]`` and the output's grad ``g2`` (the
    compute dtype) and the fp32 parameters, ``(dx2, dln, dmlp)``: dx2 in the
    compute dtype, the parameter grads fp32 in ``ln``/``p``'s tree."""
    if _on_cpu(x2, "mlp_bwd"):
        return mlp_bwd_reference(x2, g2, ln, p, eps)
    out = mlp_bwd_chain(x2, g2, ln, p, eps, KERNEL_FNS)
    LAUNCHES["mlp_bwd"] += 1
    return out


def mlp_kernel_ok(N: int, S: int) -> bool:
    """Where the JAX package's MLP backward takes its kernel
    (``plip_tpu.ops.mlp._mlp_pallas_ok`` without its platform term): a flat
    block of the batch exists."""
    return sublayer_block_b(N // S, S, 4) is not None


def _leaves(ln, p):
    return (ln["scale"], ln["bias"], p["fc1"]["kernel"], p["fc1"]["bias"], p["fc2"]["kernel"],
            p["fc2"]["bias"])


def _tree(leaves):
    ln_s, ln_b, w1, b1, w2, b2 = leaves
    return ({"scale": ln_s, "bias": ln_b},
            {"fc1": {"kernel": w1, "bias": b1}, "fc2": {"kernel": w2, "bias": b2}})


class MlpSublayerFn(torch.autograd.Function):
    """``mlp_sublayer_flat`` under autograd (the module doc)."""

    @staticmethod
    def forward(ctx, x2, S, eps, *leaves):
        ctx.save_for_backward(x2, *leaves)
        ctx.geometry = (S, eps)
        return mlp_half(x2, *_tree(leaves), eps)

    @staticmethod
    def backward(ctx, g2):
        x2, *leaves = ctx.saved_tensors
        S, eps = ctx.geometry
        ln, p = _tree(leaves)
        if mlp_kernel_ok(x2.shape[0], S):
            dx, dln, dp = mlp_bwd_flat(x2, g2.contiguous(), ln, p, eps)
            grads = [dln["scale"], dln["bias"], dp["fc1"]["kernel"], dp["fc1"]["bias"],
                     dp["fc2"]["kernel"], dp["fc2"]["bias"]]
        else:  # the JAX package's fallback: the VJP of the composed half
            with torch.enable_grad():
                xs = [t.detach().requires_grad_() for t in (x2, *leaves)]
                dx, *grads = torch.autograd.grad(mlp_half(xs[0], *_tree(xs[1:]), eps), xs,
                                                 g2)
        return (dx, None, None, *grads)


def mlp_sublayer_flat(x2: torch.Tensor, ln: Mapping, p: Mapping, S: int,
                      eps: float = 1e-5) -> torch.Tensor:
    """``x + fc2(QuickGELU(fc1(LN2 x)))`` on flat ``[N, W]`` tokens (N = B*S):
    forward the composed ``mlp_half``, backward K8 (``MlpSublayerFn``).
    ``S`` only feeds the gate, as in the JAX package."""
    return MlpSublayerFn.apply(x2, S, eps, *_leaves(ln, p))


# ---------------------------------------------------------------------------
# remat="mlp_h1"
# ---------------------------------------------------------------------------


class MlpH1Fn(torch.autograd.Function):
    """The composed MLP half saving only x and ``h1 = linear(LN2 x, fc1)``.
    Its backward is autograd's for the same ops, with LN2 (``layer_norm_rows``)
    and the activation recomputed and the fc1 product not. Under ``tp``
    (this rank's shares) fc2 is ``row_parallel`` forward, and LN2's incoming
    grad the fp32 sum over the group backward."""

    @staticmethod
    def forward(ctx, x, eps, act, tp, ln_s, ln_b, w1, b1, w2, b2):
        ln, p = _tree((ln_s, ln_b, w1, b1, w2, b2))
        h1 = linear(layer_norm_rows(x, ln_s, ln_b, eps), p["fc1"])
        ctx.save_for_backward(x, h1, ln_s, ln_b, w1, w2)
        ctx.eps, ctx.act, ctx.tp = eps, act, tp
        a = ACTIVATIONS[act](h1)
        if tp is None:
            return x + linear(a, p["fc2"])
        W = x.shape[-1]
        return row_parallel(a.reshape(-1, a.shape[-1]), w2.to(x.dtype), b2,
                            x.reshape(-1, W).contiguous(), tp, composed=True).view(x.shape)

    @staticmethod
    def backward(ctx, g):
        x, h1, ln_s, ln_b, w1, w2 = ctx.saved_tensors
        dt, W = x.dtype, x.shape[-1]
        g2 = g.reshape(-1, W)
        with torch.enable_grad():
            hl = h1.detach().requires_grad_()
            act = ACTIVATIONS[ctx.act](hl)
            da = torch.matmul(g2, w2.to(dt).t()).view(h1.shape)
            (dh1,) = torch.autograd.grad(act, hl, da)
            xl, sl, bl = (t.detach().requires_grad_() for t in (x, ln_s, ln_b))
            ln = layer_norm_rows(xl, sl, bl, ctx.eps)
            dh2 = dh1.reshape(-1, dh1.shape[-1])
            dln = torch.matmul(dh1, w1.to(dt).t())
            if ctx.tp is not None:
                dln = ctx.tp.sum_f32(dln)
            dx_ln, d_s, d_b = torch.autograd.grad(ln, (xl, sl, bl), dln)
        dw2 = torch.matmul(act.detach().reshape(-1, act.shape[-1]).t(), g2)
        dw1 = torch.matmul(ln.detach().reshape(-1, W).t(), dh2)
        return (g + dx_ln, None, None, None, d_s, d_b, dw1.float(), dh2.sum(0).float(),
                dw2.float(), g2.sum(0).float())


def mlp_half_h1(x: torch.Tensor, ln: Mapping, p: Mapping, eps: float = 1e-5,
                act: str = "quick_gelu", tp=None) -> torch.Tensor:
    """``mlp_half`` under ``remat="mlp_h1"`` (``MlpH1Fn``)."""
    return MlpH1Fn.apply(x, eps, act, tp, *_leaves(ln, p))
