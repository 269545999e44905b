"""Test and validation helpers.

Port of ``kaolin_tpu/utils/testing.py`` (reference
``kaolin/utils/testing.py:34-317``), on tensors with torch dtypes.
"""

import functools

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = [
    'contained_torch_equal',
    'FLOAT_DTYPES',
    'INT_DTYPES',
    'ALL_DTYPES',
    'with_seed',
    'check_tensor',
    'check_packed_tensor',
    'check_padded_tensor',
    'check_spc_octrees',
    'tensor_info',
    'contained_allclose',
]

FLOAT_DTYPES = [torch.float32, torch.float64]
INT_DTYPES = [torch.int32, torch.int64, torch.uint8]
ALL_DTYPES = FLOAT_DTYPES + INT_DTYPES


def _numpy(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def with_seed(seed=0):
    """Decorator fixing the module-level PRNG seed around a test function
    (:func:`kaolin_tpu_torch.ops.random.manual_seed`).

    Reference: ``kaolin/utils/testing.py:44``.
    """
    from ..ops import random as krandom

    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            krandom.manual_seed(seed)
            return func(*args, **kwargs)
        return wrapper
    return decorator


def check_tensor(tensor, shape=None, dtype=None, throw=True):
    """Checks a tensor against expected shape (None entries = wildcard) / dtype.

    Reference: ``kaolin/utils/testing.py:63``.

    Example:
        >>> import torch
        >>> t = torch.zeros((4, 3), dtype=torch.float32)
        >>> check_tensor(t, shape=(4, None), dtype=torch.float32)
        True
        >>> check_tensor(t, shape=(5, 3), throw=False)
        False
    """
    if shape is not None:
        if len(shape) != tensor.ndim:
            if throw:
                raise ValueError(f"tensor have {tensor.ndim} dimensions, "
                                 f"should have {len(shape)}")
            return False
        for i, (s, s2) in enumerate(zip(tensor.shape, shape)):
            if s2 is not None and s != s2:
                if throw:
                    raise ValueError(f"tensor shape is {tensor.shape}, "
                                     f"should be {shape}")
                return False
    if dtype is not None and tensor.dtype != dtype:
        if throw:
            raise TypeError(f"tensor dtype is {tensor.dtype}, should be {dtype}")
        return False
    return True


def check_packed_tensor(tensor, total_numel=None, last_dim=None, dtype=None,
                        throw=True):
    """Checks a packed tensor (reference: ``kaolin/utils/testing.py:93``)."""
    return check_tensor(tensor, shape=(total_numel, last_dim), dtype=dtype,
                        throw=throw)


def check_padded_tensor(tensor, padding_value=None, shape_per_tensor=None,
                        batch_size=None, max_shape=None, last_dim=None,
                        dtype=None, throw=True):
    """Checks a padded tensor and its padding values.

    Reference: ``kaolin/utils/testing.py:121``.
    """
    shape = None
    if batch_size is not None or max_shape is not None or last_dim is not None:
        ndim = tensor.ndim
        shape = [None] * ndim
        if batch_size is not None:
            shape[0] = batch_size
        if max_shape is not None:
            for i, s in enumerate(max_shape):
                shape[1 + i] = s
        if last_dim is not None:
            shape[-1] = last_dim
    if not check_tensor(tensor, shape=shape, dtype=dtype, throw=throw):
        return False
    if padding_value is not None and shape_per_tensor is not None:
        shape_per_tensor = np.asarray(shape_per_tensor)
        arr = _numpy(tensor)
        for i in range(shape_per_tensor.shape[0]):
            mask = np.ones(arr.shape[1:-1], dtype=bool)
            idx = tuple(slice(0, int(s)) for s in shape_per_tensor[i])
            mask[idx] = False
            if not np.all(arr[i][mask] == padding_value):
                if throw:
                    raise ValueError("padding values mismatch")
                return False
    return True


def check_spc_octrees(octrees, lengths, batch_size=None, level=None,
                      throw=True):
    """Validates a batch of SPC octree byte streams.

    Reference: ``kaolin/utils/testing.py:179``. Walks each octree
    breadth-first checking that the byte count matches the node hierarchy.
    """
    octrees_np = _numpy(octrees)
    lengths_np = _numpy(lengths)
    if batch_size is not None and lengths_np.shape[0] != batch_size:
        if throw:
            raise ValueError(f"lengths has {lengths_np.shape[0]} elements, "
                             f"expected batch_size {batch_size}")
        return False
    if int(lengths_np.sum()) != octrees_np.shape[0]:
        if throw:
            raise ValueError("sum of lengths doesn't match octrees size")
        return False
    start = 0
    for bidx, length in enumerate(lengths_np):
        octree = octrees_np[start:start + int(length)]
        start += int(length)
        cur_num_nodes = 1
        offset = 0
        octree_level = 0
        while offset + cur_num_nodes <= octree.shape[0]:
            level_bytes = octree[offset:offset + cur_num_nodes]
            offset += cur_num_nodes
            cur_num_nodes = int(np.unpackbits(level_bytes).sum())
            octree_level += 1
        if offset != octree.shape[0]:
            if throw:
                raise ValueError(f"octree {bidx} has inconsistent structure")
            return False
        if level is not None and octree_level != level:
            if throw:
                raise ValueError(f"octree {bidx} has level {octree_level}, "
                                 f"expected {level}")
            return False
    return True


def tensor_info(t, name='', print_stats=False, detailed=False):
    """Returns a debug string describing an array.

    Reference: ``kaolin/utils/testing.py:217``.
    """
    info = f"{name}: shape={tuple(t.shape)} dtype={t.dtype}"
    if print_stats or detailed:
        arr = _numpy(t)
        info += f" min={arr.min():.5g} max={arr.max():.5g}"
        if np.issubdtype(arr.dtype, np.floating):
            info += f" mean={arr.mean():.5g} std={arr.std():.5g}"
    return info


def contained_allclose(lhs, rhs, rtol=1e-5, atol=1e-8):
    """Recursively compares two (nested) containers of arrays.

    Reference: ``kaolin/utils/testing.py:278`` (``contained_torch_equal``).
    """
    flat_l, tree_l = pytree.tree_flatten(lhs)
    flat_r, tree_r = pytree.tree_flatten(rhs)
    if tree_l != tree_r:
        return False
    for a, b in zip(flat_l, flat_r):
        a, b = _numpy(a), _numpy(b)
        if a.shape != b.shape:
            return False
        if np.issubdtype(a.dtype, np.floating):
            if not np.allclose(a, b, rtol=rtol, atol=atol):
                return False
        else:
            if not np.array_equal(a, b):
                return False
    return True


def contained_torch_equal(lhs, rhs):
    """Recursively compares containers for exact equality (reference
    ``kaolin/utils/testing.py:278``): tensors and arrays compared with
    array_equal."""
    return contained_allclose(lhs, rhs, rtol=0., atol=0.)
