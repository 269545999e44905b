"""Voxelgrid operations: downsample, surface extraction, filling,
orthographic depth maps. Port of ``kaolin_tpu/ops/voxelgrid.py``
(reference ``kaolin/ops/voxelgrid.py:21-390``), on the inputs' device.

The window averages sum the window (padding counted as zeros) and divide
by its size, as the JAX package does, so a full 27-voxel window of a 0/1
grid averages to exactly 1. :func:`fill` floods the background from the
border through empty voxels, 6-connected, which is what scipy's
``ndimage.binary_fill_holes`` leaves out (the JAX package calls it on the
host).
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..casts import to_int

__all__ = ['downsample', 'extract_surface', 'fill', 'extract_odms',
           'project_odms']

# flood steps between two tests for convergence (each test reads the host)
_FILL_STEPS = 16


def _avg_pool3d(x, kernel, stride=None, padding=0):
    """3D window average on (B, X, Y, Z): the window's sum (padding counts
    as zeros) divided by the window's size."""
    if isinstance(kernel, int):
        kernel = (kernel,) * 3
    if stride is None:
        stride = kernel
    elif isinstance(stride, int):
        stride = (stride,) * 3
    if isinstance(padding, int):
        padding = (padding,) * 3
    summed = F.avg_pool3d(x[:, None], tuple(kernel), tuple(stride),
                          tuple(padding), divisor_override=1)[:, 0]
    return summed / float(np.prod(kernel))


def downsample(voxelgrids, scale):
    """Average-pools a voxelgrid down by ``scale`` per dimension.

    Reference: ``kaolin/ops/voxelgrid.py:21``.
    """
    if isinstance(scale, (list, tuple)):
        if len(scale) != 3:
            raise ValueError(f"Expected scale to have 3 dimensions "
                             f"but got {len(scale)} dimensions.")
    elif not isinstance(scale, int):
        raise TypeError(f"Expected scale to be type list or int "
                        f"but got {type(scale)}.")
    if voxelgrids.ndim != 4:
        raise ValueError(f"Expected voxelgrids to have 4 dimensions "
                         f"but got {voxelgrids.ndim} dimensions.")
    scale3 = (scale,) * 3 if isinstance(scale, int) else tuple(scale)
    for i, s in enumerate(scale3):
        if s < 1:
            raise ValueError(f"Downsample ratio must be at least 1 along "
                             f"every dimension but got {s} at index {i}.")
        if s > voxelgrids.shape[i + 1]:
            raise ValueError(
                f"Downsample ratio must be less than voxelgrids shape of "
                f"{voxelgrids.shape[i + 1]} at index {i}, but got {s}.")
    return _avg_pool3d(voxelgrids.to(torch.float32), scale3)


def extract_surface(voxelgrids, mode="wide"):
    """Removes internal voxels, keeping the surface shell.

    Reference: ``kaolin/ops/voxelgrid.py:92``. "wide": any filled voxel
    with a vertex touching an empty voxel; "thin": a face touching.
    """
    if voxelgrids.ndim != 4:
        raise ValueError(f"Expected voxelgrids to have 4 dimensions "
                         f"but got {voxelgrids.ndim} dimensions.")
    vg = voxelgrids.to(torch.float32)
    if mode == "wide":
        avg = _avg_pool3d(vg, (3, 3, 3), stride=1, padding=1)
        return (avg < 1) & (vg > 0)
    elif mode == "thin":
        ax = _avg_pool3d(vg, (3, 1, 1), stride=1, padding=(1, 0, 0))
        ay = _avg_pool3d(vg, (1, 3, 1), stride=1, padding=(0, 1, 0))
        az = _avg_pool3d(vg, (1, 1, 3), stride=1, padding=(0, 0, 1))
        return ((ax < 1) | (ay < 1) | (az < 1)) & (vg > 0)
    raise ValueError(f'mode "{mode}" is not supported.')


def _dilate6(r):
    """``r`` or any of its 6 face neighbours, on (B, X, Y, Z) bools."""
    out = r.clone()
    out[:, 1:] |= r[:, :-1]
    out[:, :-1] |= r[:, 1:]
    out[:, :, 1:] |= r[:, :, :-1]
    out[:, :, :-1] |= r[:, :, 1:]
    out[:, :, :, 1:] |= r[:, :, :, :-1]
    out[:, :, :, :-1] |= r[:, :, :, 1:]
    return out


def fill(voxelgrids):
    """Fills internal holes (non-differentiable): every empty voxel that no
    6-connected path of empty voxels joins to the grid's border is filled,
    as scipy's ``ndimage.binary_fill_holes`` with its default structure.

    Reference: ``kaolin/ops/voxelgrid.py:143``.

    Returns:
        (B, X, Y, Z) bool, on the input's device.
    """
    if voxelgrids.ndim != 4:
        raise ValueError(f"Expected voxelgrids to have 4 dimensions "
                         f"but got {voxelgrids.ndim} dimensions.")
    empty = voxelgrids == 0
    border = torch.zeros_like(empty)
    for d in (1, 2, 3):
        border.narrow(d, 0, 1).fill_(True)
        border.narrow(d, empty.shape[d] - 1, 1).fill_(True)
    outside = empty & border
    while True:
        prev = outside
        for _ in range(_FILL_STEPS):
            outside = _dilate6(outside) & empty
        if torch.equal(prev, outside):
            return ~outside


def extract_odms(voxelgrids):
    """Orthographic depth maps from the 6 primary viewing directions.

    Reference: ``kaolin/ops/voxelgrid.py:208``. Returns (B, 6, dim, dim)
    int64: depth to the first filled voxel per direction (dim = no hit).
    """
    vg = voxelgrids.to(torch.float32)
    dim = vg.shape[-1]
    mult = torch.arange(1, dim + 1, device=vg.device)
    rev = torch.arange(dim, 0, -1, device=vg.device)
    full = torch.cat([mult, rev]).to(vg.dtype)
    z = vg[:, None] * full.reshape(1, 2, 1, 1, -1)
    z_vals = torch.amax(z, dim=4)
    y = vg[:, None] * full.reshape(1, 2, 1, -1, 1)
    y_vals = torch.amax(y, dim=3)
    x = vg[:, None] * full.reshape(1, 2, -1, 1, 1)
    x_vals = torch.amax(x, dim=2)
    return to_int(dim - torch.cat([z_vals, y_vals, x_vals], dim=1),
                  torch.int64)


def project_odms(odms, voxelgrids=None, votes=1):
    """Projects orthographic depth maps back onto a voxelgrid (carving).

    Reference: ``kaolin/ops/voxelgrid.py:307``. Returns (B, dim, dim, dim)
    bool.
    """
    if odms.shape[1] != 6:
        raise ValueError(f"Expected odms' second dimension to be 6, "
                         f"but got {odms.shape[1]} instead.")
    batch_size = odms.shape[0]
    dim = odms.shape[-1]
    if voxelgrids is None:
        voxelgrids = torch.ones((batch_size, dim, dim, dim), dtype=torch.bool,
                                device=odms.device)
    else:
        if voxelgrids.shape[0] != batch_size:
            raise ValueError(
                f"Expected voxelgrids and odms' batch size to be the same, "
                f"but got {batch_size} for odms and "
                f"{voxelgrids.shape[0]} for voxelgrid.")
        for i in voxelgrids.shape[1:]:
            if i != dim:
                raise ValueError(
                    f"Expected voxelgrids and odms' dimension size to be "
                    f"the same, but got {dim} for odms and {i} for "
                    f"voxelgrid.")
    u = odms.reshape(batch_size, 3, 2, dim, dim).clone()
    u[:, :, 0] = dim - u[:, :, 0]
    u = u.reshape(batch_size, 6, dim, dim)
    base = torch.arange(dim, device=odms.device)
    z_neg = (base.reshape(1, 1, 1, -1) >= u[:, 0][..., None]).to(torch.int32)
    z_pos = (base.reshape(1, 1, 1, -1) < u[:, 1][..., None]).to(torch.int32)
    y_neg = (base.reshape(1, 1, -1, 1) >= u[:, 2][:, :, None]).to(torch.int32)
    y_pos = (base.reshape(1, 1, -1, 1) < u[:, 3][:, :, None]).to(torch.int32)
    x_neg = (base.reshape(1, -1, 1, 1) >= u[:, 4][:, None]).to(torch.int32)
    x_pos = (base.reshape(1, -1, 1, 1) < u[:, 5][:, None]).to(torch.int32)
    total = z_neg + z_pos + y_neg + y_pos + x_neg + x_pos
    return (voxelgrids * votes - total) > 0
