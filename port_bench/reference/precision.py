"""The control: the reference computed one precision below the
configuration's. The configurations state float32 with TF32 off, so the
control rounds every float32 operand of a matrix product (``matmul``,
``@``, ``einsum``, ``mm``, ``bmm``, ``linear``) to TF32, as an H100's
tensor cores do with TF32 on: 10 mantissa bits, round to nearest even,
products accumulated in float32. The rounding is done here, not by the
backend's switch, so the control reads the same on the card and on the
CPU (whose matrix products ignore the switch)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_map

_MATMULS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
            torch.Tensor.__rmatmul__, torch.einsum, torch.mm,
            torch.Tensor.mm, torch.bmm, torch.Tensor.bmm, F.linear,
            torch.addmm, torch.baddbmm}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits (nearest even;
    infinities and NaNs kept)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    lsb = (bits >> 13) & 1
    r = ((bits + 0x0FFF + lsb) & ~0x1FFF)
    r = torch.where(torch.isfinite(x), r, bits)
    r = torch.where(r > 0x7FFFFFFF, r - (1 << 32), r)
    return r.to(torch.int32).view(torch.float32)


def _round(v):
    if isinstance(v, torch.Tensor) and v.dtype == torch.float32:
        return round_tf32(v)
    return v


class TF32(TorchFunctionMode):
    """Inside ``with TF32():`` every float32 matrix product rounds its
    operands to TF32 first."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _MATMULS:
            args = tree_map(_round, args)
            kwargs = tree_map(_round, kwargs)
        return func(*args, **kwargs)
