"""The control's precision: the reference with every float32 matrix
product taken in TF32, the step below the configuration's float32 with
TF32 off.

TF32 keeps 10 of float32's 23 mantissa bits in each operand of a product
and accumulates in float32.  :func:`tf32_products` emulates that on any
device by rounding both operands of every ``@`` to the nearest TF32 value
(ties away from zero), so the control reads the same on the CPU as on the
card; tangents pass through unrounded, so ``torch.func.jacfwd`` still
differentiates the rounded products."""

from __future__ import annotations

import contextlib

import torch


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its float32 values rounded to TF32 (others unchanged)."""
    if x.dtype != torch.float32:
        return x
    d = x.detach()
    bits = d.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    r = torch.where(torch.isfinite(d), r, d)
    return x + (r - d)


@contextlib.contextmanager
def tf32_products():
    """Within the block, every ``tensor @ tensor`` rounds its operands to
    TF32 first."""
    orig = torch.Tensor.__matmul__

    def matmul(a, b):
        return orig(to_tf32(a), to_tf32(b))

    torch.Tensor.__matmul__ = matmul
    try:
        yield
    finally:
        torch.Tensor.__matmul__ = orig
