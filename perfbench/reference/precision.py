"""Operand rounding for the reference's lower-precision runs (the
control): every matrix product takes rounded operands, in the forward and
in the backward, and accumulates in float32, as a tensor core does.

- ``"f32"``: no rounding (TF32 must be off).
- ``"tf32"``: operands rounded to nearest (ties to even) at TF32's 10
  mantissa bits.
- ``"fp8"``: operands scaled per tensor so that their largest magnitude
  is float8 e4m3's largest, rounded to e4m3, and scaled back.
"""

from __future__ import annotations

import torch

PRECISIONS = ("f32", "tf32", "fp8")
_E4M3_MAX = 448.0


def round_tf32(x):
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def round_fp8(x):
    amax = x.abs().amax().clamp(min=1e-30)
    scale = _E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def rounder(precision):
    if precision == "f32":
        return None
    if precision == "tf32":
        return round_tf32
    if precision == "fp8":
        return round_fp8
    raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, fn):
        ra, rb = fn(a), fn(b)
        ctx.save_for_backward(ra, rb)
        ctx.fn = fn
        return ra @ rb

    @staticmethod
    def backward(ctx, grad):
        ra, rb = ctx.saved_tensors
        g = ctx.fn(grad)
        da = g @ rb.transpose(-1, -2)
        db = ra.transpose(-1, -2) @ g
        if db.dim() > rb.dim():  # a batched by a shared matrix
            db = db.reshape(-1, *rb.shape).sum(0)
        return da, db, None


def matmul(a, b, precision="f32"):
    """``a @ b`` with operands (and, in the backward, the incoming
    gradient) rounded to ``precision``."""
    fn = rounder(precision)
    if fn is None:
        return a @ b
    return _RoundedMatmul.apply(a, b, fn)


def plain_matmul(a, b, precision="f32"):
    """``a @ b`` without autograd, operands rounded to ``precision``."""
    fn = rounder(precision)
    return a @ b if fn is None else fn(a) @ fn(b)
