"""Bit-level helpers on octree bytes. Port of
``kaolin_tpu/ops/spc/uint8.py`` (reference
``kaolin/ops/spc/uint8.py:29-125``). Bit ``i`` of an octree byte is the
occupancy of child octant ``i = x << 2 | y << 1 | z``."""

import numpy as np
import torch

__all__ = ['uint8_to_bits', 'uint8_bits_sum', 'bits_to_uint8']

# set bits of every byte value
POPCOUNT8 = np.array([bin(i).count('1') for i in range(256)], dtype=np.int32)
_SHIFTS = tuple(range(8))


def popcount8(t):
    """Set bits of each value of an integer tensor in [0, 256), int32."""
    return torch.as_tensor(POPCOUNT8, device=t.device)[t.to(torch.int64)]


def uint8_to_bits(uint8_t):
    """Unpacks uint8 values to 8 booleans (bit 0 first)."""
    shifts = torch.tensor(_SHIFTS, dtype=torch.uint8, device=uint8_t.device)
    return ((uint8_t[..., None] >> shifts) & 1).to(torch.bool)


def uint8_bits_sum(uint8_t):
    """Number of set bits (children) per byte, int32."""
    return popcount8(uint8_t)


def bits_to_uint8(bool_t):
    """Packs (..., 8) booleans into uint8 (bit 0 first)."""
    weights = torch.tensor([1 << i for i in _SHIFTS], dtype=torch.int32,
                           device=bool_t.device)
    return torch.sum(bool_t.to(torch.int32) * weights, dim=-1).to(torch.uint8)
