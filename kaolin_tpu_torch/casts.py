"""Float to integer casts with XLA's rule.

``kaolin_tpu`` casts with ``astype``, which XLA lowers to a convert that
truncates toward zero, maps NaN to 0 and saturates: a value at or above
the type's largest gives the largest, at or below its smallest the
smallest (so +-inf give the bounds; float32 to int64 too). PyTorch's CPU
cast of NaN, inf or an out-of-range value is undefined in C++ and gives
the most negative integer (int32, int64) or wraps (int16). The card's
cast (PTX ``cvt.rzi``) follows the XLA rule already; :func:`to_int` gives
it on every device.
"""

import torch

__all__ = ['to_int']


def to_int(x, dtype):
    """``x.to(dtype)`` for an integer ``dtype`` with XLA's convert rule
    for floats: truncation toward zero, NaN to 0, saturation at the
    type's bounds. Integer and bool tensors are cast as ``Tensor.to``
    casts them."""
    if not x.is_floating_point():
        return x.to(dtype)
    info = torch.iinfo(dtype)
    t = torch.trunc(x)
    # the bounds compare in x's dtype, where iinfo.max may round up to a
    # power of two: every value at or past it saturates
    over = t >= info.max
    under = t <= info.min
    safe = torch.where(torch.isnan(t) | over | under, torch.zeros_like(t), t)
    out = safe.to(dtype)
    out = torch.where(over, torch.full_like(out, info.max), out)
    return torch.where(under, torch.full_like(out, info.min), out)
