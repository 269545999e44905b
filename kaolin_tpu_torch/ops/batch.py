"""Batched-tensor representations: list / packed / padded. Port of
``kaolin_tpu/ops/batch.py``.

The *packed* representation is a concatenated ``(total_numel, last_dim)``
tensor plus a host numpy ``shape_per_tensor``: shapes stay host metadata,
as in the JAX package. The *padded* representation is a dense tensor
padded with ``padding_value``. Segment ids drive the segment reductions of
``ops.reduction``.
"""

import numpy as np
import torch

__all__ = [
    'get_shape_per_tensor',
    'list_to_packed',
    'packed_to_list',
    'list_to_padded',
    'padded_to_list',
    'packed_to_padded',
    'padded_to_packed',
    'get_first_idx',
    'tile_to_packed',
    'fill_max_shape',
    'segment_ids_from_numel',
]


def get_shape_per_tensor(tensor_list):
    """The shapes (without the last dim) of each tensor of the list:
    numpy (batch_size, ndim - 1) int64."""
    ndim = tensor_list[0].ndim
    for i, t in enumerate(tensor_list):
        if t.ndim != ndim:
            raise ValueError(f"Expected all tensors to have {ndim} dimensions "
                             f"but got {t.ndim} at index {i}")
    return np.array([tuple(t.shape[:-1]) for t in tensor_list],
                    dtype=np.int64)


def list_to_packed(tensor_list):
    """Concatenates tensors into one packed tensor. Returns (packed
    ``(sum(prod(shape_i)), last_dim)``, ``shape_per_tensor``)."""
    shape_per_tensor = get_shape_per_tensor(tensor_list)
    last_dim = tensor_list[0].shape[-1]
    for i, t in enumerate(tensor_list):
        if t.shape[-1] != last_dim:
            raise ValueError(f"Expected all tensors to have last dimension "
                             f"{last_dim} but got {t.shape[-1]} at index {i}")
    packed = torch.cat([t.reshape(-1, last_dim) for t in tensor_list], dim=0)
    return packed, shape_per_tensor


def get_first_idx(numel_per_tensor):
    """First index of each sub-tensor in the packed tensor, plus the end:
    numpy (batch_size + 1,) int64, ``[0, cumsum...]``."""
    numel = np.asarray(numel_per_tensor)
    out = np.zeros((numel.shape[0] + 1,), dtype=np.int64)
    np.cumsum(numel, axis=0, out=out[1:])
    return out


def packed_to_list(packed_tensor, shape_per_tensor, first_idx=None):
    """Splits a packed tensor back into a list of tensors."""
    shape_per_tensor = np.asarray(shape_per_tensor)
    numel = np.prod(shape_per_tensor, axis=1) if shape_per_tensor.ndim > 1 \
        else shape_per_tensor
    if first_idx is None:
        first_idx = get_first_idx(numel)
    else:
        first_idx = np.asarray(first_idx)
    last_dim = packed_tensor.shape[-1]
    return [packed_tensor[int(first_idx[i]):int(first_idx[i + 1])].reshape(
                tuple(int(s) for s in shape_per_tensor[i]) + (last_dim,))
            for i in range(shape_per_tensor.shape[0])]


def fill_max_shape(shape_per_tensor, partial_max_shape=None):
    """Fills the ``-1`` entries of a partial max shape with the per-dim
    maxima."""
    shape_per_tensor = np.asarray(shape_per_tensor)
    max_shape = shape_per_tensor.max(axis=0)
    if partial_max_shape is None:
        return max_shape
    partial = np.asarray(partial_max_shape).copy()
    mask = partial == -1
    partial[mask] = max_shape[mask]
    if np.any(partial < max_shape):
        raise ValueError(f"max_shape {tuple(partial)} is smaller than "
                         f"actual max shape {tuple(max_shape)}")
    return partial


def list_to_padded(tensor_list, padding_value=0., max_shape=None):
    """Stacks tensors into one padded tensor. Returns (padded
    ``(batch_size, *max_shape, last_dim)``, ``shape_per_tensor``)."""
    shape_per_tensor = get_shape_per_tensor(tensor_list)
    max_shape = fill_max_shape(shape_per_tensor, max_shape)
    last_dim = tensor_list[0].shape[-1]
    first = tensor_list[0]
    out = torch.full((len(tensor_list),) + tuple(int(m) for m in max_shape)
                     + (last_dim,), padding_value, dtype=first.dtype,
                     device=first.device)
    for i, t in enumerate(tensor_list):
        out[(i,) + tuple(slice(0, s) for s in t.shape[:-1])] = t
    return out, shape_per_tensor


def padded_to_list(padded_tensor, shape_per_tensor):
    """Splits a padded tensor back into a list of trimmed tensors."""
    shape_per_tensor = np.asarray(shape_per_tensor)
    return [padded_tensor[(i,) + tuple(slice(0, int(s))
                                       for s in shape_per_tensor[i])]
            for i in range(shape_per_tensor.shape[0])]


def packed_to_padded(packed_tensor, shape_per_tensor, first_idx=None,
                     padding_value=0., max_shape=None):
    """Converts a packed tensor to the padded layout."""
    return list_to_padded(
        packed_to_list(packed_tensor, shape_per_tensor, first_idx),
        padding_value=padding_value, max_shape=max_shape)[0]


def padded_to_packed(padded_tensor, shape_per_tensor):
    """Converts a padded tensor to the packed layout."""
    return list_to_packed(padded_to_list(padded_tensor, shape_per_tensor))[0]


def segment_ids_from_numel(numel_per_tensor, total=None, device='cuda'):
    """Per-element segment (sub-tensor) ids of a packed tensor: int32
    (total,) on ``device``. ``total`` is accepted for the JAX package's
    signature; the ids always cover ``sum(numel_per_tensor)``."""
    numel = np.asarray(numel_per_tensor)
    ids = np.repeat(np.arange(numel.shape[0]), numel)
    return torch.as_tensor(ids, dtype=torch.int32, device=device)


def tile_to_packed(values, numel_per_tensor):
    """Tiles per-tensor scalars to the packed layout: (total, 1), on the
    device of ``values`` (a tensor, or a sequence of numbers taken to the
    CPU)."""
    values = torch.as_tensor(values)
    seg = segment_ids_from_numel(numel_per_tensor, device=values.device)
    return values[seg.long()][:, None]
