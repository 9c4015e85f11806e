"""Tensor parallelism's own pieces of the towers' chains (``parallel.mesh``).

A Megatron pair runs a column-parallel product (qkv, fc1: this rank's
output columns, local), the local middle (the attention core on this rank's
heads, the activation), then a row-parallel product (out, fc2: this rank's
input rows), whose partial sums the tp group adds before the bias and the
residual. Here the row-parallel end is ``row_parallel``: the product in the
fp32 partial mode of K1's ``gemm_bias_residual`` (no bias, no cast), an fp32
all-reduce over the group, then ``tp_epilogue``, a hand-written elementwise
kernel (``csrc/tp_epilogue.cu``) that adds the bias and the residual in the
meshless path's rounding order: K1's, ``cast(sum + bias) + residual`` (the
fused sublayer, K7's recompute, K10), or the composed towers' ``linear``,
``cast(cast(sum) + cast(bias)) + residual`` (``composed``: the MLP half,
the composed attention), so that each computes the meshless function up to
the order of its fp32 sums. ``RowParallelFn`` is the composed one under
autograd (a local backward), ``row_linear`` the composed towers' entry
(W8A8 included), and ``copy_to_tp`` / ``reduce_from_tp``
(``parallel.distributed``) the pair's other ends.

``tp_epilogue`` takes its plain version (``tp_epilogue_reference``) only for
a tensor on the CPU; for a CUDA tensor it launches its kernel or raises.
``LAUNCHES`` counts its launches.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Mapping, Optional

import torch

from . import _build
from ..parallel.distributed import TPGroup
from .attention import (H100_SMS, _check, _dtype_code, _on_cpu, _sm_count, _stream,
                        gemm_bias_residual, linear)
from .quant import linear_w8a8

LAUNCHES = {"tp_epilogue": 0}

_vp, _int = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # acc, bias, residual, out, M, N, blocks (tp_epilogue_plan), composed, dtype, device,
    # stream
    "plip_tp_epilogue": (_vp, _vp, _vp, _vp, _int, _int, _int, _int, _int, _int, _vp),
}
_kernels = None


def reset_launch_counts() -> None:
    LAUNCHES["tp_epilogue"] = 0


def _lib() -> ctypes.CDLL:
    global _kernels
    if _kernels is None:
        _kernels = _build.bind(_SIGNATURES)
    return _kernels


def _launch(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"tp_epilogue: CUDA kernel launch failed with error {rc}")
    LAUNCHES["tp_epilogue"] += 1


# tp_epilogue's grid: at most this many blocks (256 threads) an SM, the rows
# walked in strides.
TP_EPILOGUE_BLOCKS_PER_SM = 8


def tp_epilogue_reference(acc: torch.Tensor, bias: torch.Tensor, residual: torch.Tensor,
                          composed: bool = False) -> torch.Tensor:
    """``cast(acc + bias) + residual``: the fp32 sum and bias, one cast to
    the residual's dtype, the residual added in that dtype (K1's epilogue);
    ``composed``: ``cast(cast(acc) + cast(bias)) + residual`` (the composed
    towers' ``linear``)."""
    dt = residual.dtype
    if composed:
        return residual + (acc.to(dt) + bias.to(dt))
    return residual + (acc + bias.float()).to(dt)


def tp_epilogue_plan(M: int, N: int, itemsize: int, sms: int = H100_SMS) -> int:
    """``tp_epilogue``'s grid: a thread per 16 bytes of the output, at most
    ``TP_EPILOGUE_BLOCKS_PER_SM`` blocks an SM."""
    chunks = M * N // (16 // itemsize)
    return max(1, min(-(-chunks // 256), TP_EPILOGUE_BLOCKS_PER_SM * sms))


def tp_epilogue(acc: torch.Tensor, bias: torch.Tensor, residual: torch.Tensor,
                composed: bool = False) -> torch.Tensor:
    """``cast(acc [M, N] + bias [N]) + residual [M, N]`` in the residual's
    dtype (fp32 or bf16), ``acc`` and ``bias`` fp32: the epilogue of a
    row-parallel product once the tp ranks' fp32 partials are summed
    (``csrc/tp_epilogue.cu``, 16-byte accesses where N and the bases allow);
    ``composed``: the composed order (``tp_epilogue_reference``)."""
    if _on_cpu(acc, "tp_epilogue"):
        return tp_epilogue_reference(acc, bias, residual, composed)
    code = _dtype_code("tp_epilogue", residual)
    M, N = residual.shape
    _check("tp_epilogue acc", acc, residual.device, torch.float32, (M, N))
    _check("tp_epilogue bias", bias, residual.device, torch.float32, (N,))
    _check("tp_epilogue residual", residual, residual.device, residual.dtype, (M, N))
    out = torch.empty_like(residual)
    _launch(_lib().plip_tp_epilogue, acc.data_ptr(), bias.data_ptr(),
            residual.data_ptr(), out.data_ptr(), M, N,
            tp_epilogue_plan(M, N, residual.element_size(), _sm_count(residual.device)),
            int(composed), code, residual.device.index, _stream(residual.device))
    return out


def row_parallel(x2: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 residual2: torch.Tensor, tp: TPGroup, gemm_fn: Callable = None,
                 epi_fn: Callable = None, composed: bool = False) -> torch.Tensor:
    """``cast(sum over the tp ranks of x2 . w + bias) + residual2`` on flat
    rows: this rank's input columns ``x2`` against its rows of the weight
    ``w`` (x2's dtype), the fp32 partial (``gemm_fn``'s partial mode,
    ``gemm_bias_residual``), an fp32 all-reduce over the tp group, the
    epilogue (``epi_fn``, ``tp_epilogue``). No autograd."""
    part = (gemm_fn or gemm_bias_residual)(x2, w, None)
    tp.all_reduce_(part)
    return (epi_fn or tp_epilogue)(part, bias, residual2, composed)


class RowParallelFn(torch.autograd.Function):
    """``row_parallel`` of ``x [..., K]`` (this rank's columns) and the fp32
    parameters ``w [K, N]`` (its rows), ``bias``, under autograd. The
    backward is local (the output is replicated, so is its gradient) and is
    autograd's of the meshless ``residual + linear(x, p)`` in x's dtype, as
    the composed towers differentiate it: ``dx = g . w^T``, ``dw = x^T . g``
    and ``dbias = colsum(g)`` cast to fp32, ``dresidual = g``."""

    @staticmethod
    def forward(ctx, x, w, bias, residual, tp):
        K, N = w.shape
        x2 = x.reshape(-1, K).contiguous()
        wd = w.to(x.dtype)
        ctx.save_for_backward(x2, wd)
        ctx.x_shape = x.shape
        out = row_parallel(x2, wd, bias, residual.reshape(-1, N).contiguous(), tp,
                           composed=True)
        return out.view(residual.shape)

    @staticmethod
    def backward(ctx, g):
        x2, wd = ctx.saved_tensors
        g2 = g.reshape(-1, wd.shape[1])
        dx = torch.matmul(g2, wd.t()).view(ctx.x_shape)
        return dx, torch.matmul(x2.t(), g2).float(), g2.sum(0).float(), g, None


def row_linear(x: torch.Tensor, p: Mapping, residual: torch.Tensor,
               tp: Optional[TPGroup]) -> torch.Tensor:
    """``residual + linear(x, p)``; under ``tp`` the row-parallel product of
    this rank's input columns: ``RowParallelFn``, or for a W8A8 linear
    ``linear_w8a8`` with the activation scale and the int32 sums reduced
    over the group."""
    if tp is None:
        return residual + linear(x, p)
    if "kernel_q" in p:
        return residual + linear_w8a8(x, p, tp)
    return RowParallelFn.apply(x, p["kernel"], p["bias"], residual, tp)
