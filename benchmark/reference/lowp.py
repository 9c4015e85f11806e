"""The reference in a lower precision than a configuration states: the
controls that the comparison deciding ``correct`` has to reject.

- ``tf32``: float32 products on the tensor cores' TF32 (10-bit mantissa),
  the step below float32 with TF32 off.
- ``fp8``: the step below bfloat16. Each product's operands are scaled per
  tensor to the range of float8 e4m3 and rounded to it; in the backward the
  incoming gradient is rounded to e5m2, as fp8 training recipes do.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / top
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = _round(a, torch.float8_e4m3fn, E4M3_MAX), _round(b, torch.float8_e4m3fn,
                                                                 E4M3_MAX)
        ctx.save_for_backward(a8, b8)
        return torch.matmul(a8, b8)

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = _round(g, torch.float8_e5m2, E5M2_MAX)
        ga = torch.matmul(g8, b8.transpose(-1, -2))
        gb = torch.matmul(a8.transpose(-1, -2), g8)
        # broadcast batch dimensions back to the operands' shapes
        while ga.dim() > a8.dim():
            ga = ga.sum(0)
        while gb.dim() > b8.dim():
            gb = gb.sum(0)
        return ga, gb


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8Matmul.apply(a, b)


@contextlib.contextmanager
def tf32():
    """Float32 products on TF32 inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@contextlib.contextmanager
def fp32():
    """The reference's own precision: TF32 off."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
