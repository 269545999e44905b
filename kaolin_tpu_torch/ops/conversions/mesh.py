"""Mesh to Structured Point Cloud (octree) conversion. Port of
``kaolin_tpu/ops/conversions/mesh.py`` (reference
``kaolin/csrc/ops/conversions/mesh_to_spc/mesh_to_spc_cuda.cu``).

Conservative triangle voxelization, then the octree build, both on the
host by the native library (``csrc/core.cpp``): vertices are snapped to
the integer lattice, each triangle is projected along its dominant normal
axis, the three homogeneous edge lines are dilated by the half-pixel L1
bound (a conservative 2D footprint), and every covered pixel column emits
one voxel whose depth comes from the snapped plane at the pixel centre, a
26-connected surface band. Degenerate (collinear or point) triangles
rasterize as segments or points. ``_voxelize_triangles_np`` is the numpy
plain version of the same math. The octree then feeds the SPC ops on the
vertices' device.
"""

import numpy as np
import torch

from ...native import voxelize_triangles_fast
from ..spc.points import unbatched_points_to_octree

__all__ = ['voxelize_triangles', 'unbatched_mesh_to_spc', 'mesh_to_spc']

_CYCLIC_U = (1, 2, 0)
_CYCLIC_V = (2, 0, 1)


def _voxelize_triangles_np(vertices, faces, level):
    """Numpy twin of ``csrc/core.cpp voxelize_triangles`` (same math)."""
    res = 1 << level
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int64)
    p = np.floor(v[f].astype(np.float64) + 0.5)         # (T, 3, 3) snapped
    # the C cast `(int)(h + 0.5)` truncates toward zero; grid coords are
    # non-negative in range, so floor matches
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    # plane oriented as the reference's crs4 (spc_math.h:130): the normal
    # is the NEGATED (p1-p0)x(p2-p0); the edge-test sign depends on it
    n = -np.cross(e1, e2)
    w = -np.einsum('td,td->t', n, p[:, 0])

    out = []
    for t in range(p.shape[0]):
        nt_, wt = n[t], w[t]
        pt = p[t]
        if not np.any(nt_):
            mn, mx = pt.min(0), pt.max(0)
            diff = mx - mn
            if not np.any(diff):
                axis = 2
                q = np.broadcast_to(mn, (3, 3)).copy()
                lines = np.broadcast_to(-mn, (3, 3)).copy()
                F = np.array([0., 0., mn[2]])
            else:
                if diff[0] < diff[1]:
                    axis = 0 if diff[0] < diff[2] else 2
                else:
                    axis = 1 if diff[1] < diff[2] else 2
                u, vv = _CYCLIC_U[axis], _CYCLIC_V[axis]
                q = np.array([[mn[u], mn[vv], 1.],
                              [mx[u], mx[vv], 1.],
                              [mx[u], mx[vv], 1.]])
                if diff[u] != 0.:
                    F = np.array([diff[axis] / diff[u], 0.,
                                  (mn[axis] * mx[u] - mn[u] * mx[axis])
                                  / diff[u]])
                else:
                    F = np.array([0., diff[axis] / diff[vv],
                                  (mn[axis] * mx[vv] - mn[vv] * mx[axis])
                                  / diff[vv]])
                l1 = -np.cross(q[0], q[1])
                lines = np.stack([-l1, l1, l1])
        else:
            a = np.abs(nt_)
            if a[0] > a[1]:
                axis = 0 if a[0] > a[2] else 2
            else:
                axis = 1 if a[1] > a[2] else 2
            sign = 1. if nt_[axis] > 0. else -1.
            u, vv = _CYCLIC_U[axis], _CYCLIC_V[axis]
            q = np.stack([pt[:, u], pt[:, vv], np.ones(3)], axis=-1)
            F = np.array([-nt_[u], -nt_[vv], -wt]) / nt_[axis]
            lines = sign * np.stack([np.cross(q[1], q[2]),
                                     np.cross(q[2], q[0]),
                                     np.cross(q[0], q[1])])
        lines[:, 2] -= 0.5 * (np.abs(lines[:, 0]) + np.abs(lines[:, 1]))

        xmin, xmax = int(q[:, 0].min()), int(q[:, 0].max())
        ymin, ymax = int(q[:, 1].min()), int(q[:, 1].max())
        xs, ys = np.meshgrid(np.arange(xmin, xmax + 1, dtype=np.float64),
                             np.arange(ymin, ymax + 1, dtype=np.float64),
                             indexing='ij')
        inside = np.ones(xs.shape, bool)
        for c in range(3):
            inside &= (xs * lines[c, 0] + ys * lines[c, 1]
                       + lines[c, 2]) < 0.
        xs, ys = xs[inside], ys[inside]
        z = np.floor(xs * F[0] + ys * F[1] + F[2] + 0.5)
        if axis == 0:
            vox = np.stack([z, xs, ys], axis=-1)
        elif axis == 1:
            vox = np.stack([ys, z, xs], axis=-1)
        else:
            vox = np.stack([xs, ys, z], axis=-1)
        ok = np.all((vox >= 0) & (vox < res), axis=-1)
        out.append(vox[ok].astype(np.int16))
    if not out:
        return np.zeros((0, 3), np.int16)
    vox = np.concatenate(out)
    key = ((vox[:, 0].astype(np.int64) << 32)
           | (vox[:, 1].astype(np.int64) << 16) | vox[:, 2].astype(np.int64))
    _, idx = np.unique(key, return_index=True)
    return vox[np.sort(idx)]


def _host(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def voxelize_triangles(vertices, faces, level):
    """Conservatively voxelizes triangles given in grid coordinates, with
    the native library.

    Reference semantics: ``mesh_to_spc_cuda.cu:79-333``.

    Args:
        vertices: (num_vertices, 3) float, grid coords in [0, 2^level].
        faces: (num_faces, 3) int.
        level (int): grid resolution exponent.

    Returns:
        (num_voxels, 3) int16 numpy array of unique voxel coordinates, in
        Morton order.
    """
    return voxelize_triangles_fast(_host(vertices).astype(np.float32),
                                   _host(faces).astype(np.int64), int(level))


def unbatched_mesh_to_spc(vertices, faces, level):
    """Voxelizes a [-1, 1] mesh surface into an SPC octree.

    Args:
        vertices: (num_vertices, 3) in [-1, 1].
        faces: (num_faces, 3) int.
        level (int): octree depth.

    Returns:
        uint8 octree byte stream (see
        :func:`kaolin_tpu_torch.ops.spc.scan_octrees`), on the vertices'
        device.
    """
    res = 1 << level
    grid = (_host(vertices).astype(np.float64) + 1.) * (res / 2.)
    vox = voxelize_triangles(grid.astype(np.float32), faces, level)
    device = vertices.device if torch.is_tensor(vertices) else 'cpu'
    return unbatched_points_to_octree(vox, level).to(device)


def mesh_to_spc(vertices, faces, level):
    """Batched mesh-to-SPC; returns a :class:`kaolin_tpu_torch.rep.Spc`.

    Args:
        vertices: (batch_size, num_vertices, 3) in [-1, 1].
        faces: (num_faces, 3) int (shared topology).
        level (int): octree depth.
    """
    from ...rep.spc import Spc
    octrees = [unbatched_mesh_to_spc(vertices[b], faces, level)
               for b in range(vertices.shape[0])]
    lengths = np.asarray([o.shape[0] for o in octrees], np.int32)
    return Spc(torch.cat(octrees), lengths)
