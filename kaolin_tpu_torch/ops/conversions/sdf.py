"""SDF callables to voxelgrids by multiresolution refinement. Port of
``kaolin_tpu/ops/conversions/sdf.py``.

The refinement stays host numpy, as in the JAX package: evaluate the SDF on
a coarse grid, then double the resolution, evaluating new points only next
to cells whose corners disagree and filling the others from their coarse
corner. The SDF callable is given torch tensors (float64 coordinates) on
``device``.
"""

import numpy as np
import torch

__all__ = ['sdf_to_voxelgrids']


def _upsample(occ, res, evaluate):
    """One refinement step from resolution ``res`` to ``2 * res``."""
    c = occ
    corner_sum = (c[:-1, :-1, :-1] + c[:-1, :-1, 1:]
                  + c[:-1, 1:, :-1] + c[:-1, 1:, 1:]
                  + c[1:, :-1, :-1] + c[1:, :-1, 1:]
                  + c[1:, 1:, :-1] + c[1:, 1:, 1:])
    active = (corner_sum > 0) & (corner_sum < 8)
    new_res = res * 2
    # every new point takes its coarse cell's corner; old points keep
    # their values at the even indices
    new_occ = np.zeros((new_res + 1,) * 3)
    new_occ[:new_res, :new_res, :new_res] = np.repeat(np.repeat(np.repeat(
        occ[:-1, :-1, :-1], 2, 0), 2, 1), 2, 2)
    new_occ[::2, ::2, ::2] = occ
    # evaluate the new lattice points of each active fine cell
    up_active = np.repeat(np.repeat(np.repeat(active, 2, 0), 2, 1), 2, 2)
    grow = np.zeros((new_res + 1,) * 3, dtype=bool)
    for dx in range(2):
        for dy in range(2):
            for dz in range(2):
                grow[dx:new_res + dx, dy:new_res + dy,
                     dz:new_res + dz] |= up_active
    known = np.zeros_like(grow)
    known[::2, ::2, ::2] = True
    to_eval = grow & ~known
    idx = np.argwhere(to_eval)
    if idx.shape[0]:
        new_occ[to_eval] = evaluate(idx, new_res)
    return new_occ


def sdf_to_voxelgrids(sdf, bbox_center=0., bbox_dim=1., init_res=32,
                      upsampling_steps=0, device='cuda'):
    """Converts SDF callables to binary occupancy voxelgrids of resolution
    ``init_res * 2**upsampling_steps + 1``.

    Args:
        sdf: list of callables mapping (N, 3) coordinates (a float64 tensor
            on ``device``) to (N,) SDF values.
        bbox_center, bbox_dim: surface bounding box.
        init_res: initial grid resolution.
        upsampling_steps: number of resolution doublings.
        device: where the callables get their coordinates and where the
            result is put.

    Returns:
        (batch_size, R+1, R+1, R+1) float32 on ``device``, 1.0 where
        sdf <= 0.
    """
    if not isinstance(bbox_center, (int, float)):
        raise TypeError(f"Expected bbox_center to be int or float "
                        f"but got {type(bbox_center)}.")
    if not isinstance(bbox_dim, (int, float)):
        raise TypeError(f"Expected bbox_dim to be int or float "
                        f"but got {type(bbox_dim)}.")
    if not isinstance(init_res, int):
        raise TypeError(f"Expected init_res to be int "
                        f"but got {type(init_res)}.")
    if not isinstance(upsampling_steps, int):
        raise TypeError(f"Expected upsampling_steps to be int "
                        f"but got {type(upsampling_steps)}.")
    if not isinstance(sdf, list):
        raise TypeError(f"Expected sdf to be list but got {type(sdf)}.")

    out = []
    for i_batch, f in enumerate(sdf):
        if not callable(f):
            raise TypeError(f"Expected sdf[{i_batch}] to be callable "
                            f"but got {type(f)}.")

        def evaluate(idx, res, f=f):
            pts = idx.astype(np.float64) / res
            pts = bbox_dim * (pts - 0.5 + bbox_center)
            vals = f(torch.as_tensor(pts, device=device))
            vals = torch.as_tensor(vals).detach().cpu().numpy()
            return (vals <= 0).astype(np.float64)

        res = init_res
        ii, jj, kk = np.meshgrid(*([np.arange(res + 1)] * 3), indexing='ij')
        idx = np.stack([ii, jj, kk], axis=-1).reshape(-1, 3)
        occ = evaluate(idx, res).reshape(res + 1, res + 1, res + 1)
        for _ in range(upsampling_steps):
            occ = _upsample(occ, res, evaluate)
            res *= 2
        out.append(occ)
    return torch.as_tensor(np.stack(out), dtype=torch.float32, device=device)
