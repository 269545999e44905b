"""Segment reductions over packed tensors. Port of
``kaolin_tpu/ops/reduction.py``: one ``index_add_`` where the JAX package
calls ``jax.ops.segment_sum``."""

import numpy as np
import torch

from .batch import segment_ids_from_numel

__all__ = ['packed_simple_sum']


def packed_simple_sum(packed_tensor, numel_per_tensor):
    """Sums each sub-tensor of a packed ``(total_numel, last_dim)`` tensor
    over all its elements, the last dim included. ``numel_per_tensor`` is
    a host array of element counts. Returns (batch_size,). On the card the
    adds into one sub-tensor's sum run in no fixed order."""
    numel = np.asarray(numel_per_tensor)
    seg = segment_ids_from_numel(numel, device=packed_tensor.device)
    per_row = packed_tensor.sum(dim=-1)
    out = per_row.new_zeros((int(numel.shape[0]),))
    return out.index_add_(0, seg, per_row)
