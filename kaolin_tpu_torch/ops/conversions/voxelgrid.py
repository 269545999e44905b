"""Voxelgrid-to-mesh conversions. Port of
``kaolin_tpu/ops/conversions/voxelgrid.py`` (reference
``kaolin/ops/conversions/voxelgrid.py:56-246``), on the input's device.

``voxelgrids_to_trianglemeshes`` is table-driven Lorensen marching cubes
with the reference's vertex deduplication
(``csrc/ops/conversions/unbatched_mcube/unbatched_mcube_cuda.cu``): each
voxel owns the interpolated vertices on its three corner-7-incident edges
(6, 7, 11), and faces find shared vertices through neighbour offsets, so
the vertex and face order is the CUDA kernel's. The classify, scan,
compact and generate passes are tensor operations: the corner codes from
shifted slices, two int64 exclusive scans, gathers from the tables, and
the owners' shifts by ``torch.roll``; the two totals are read on the host
to size the outputs. ``method='tets'`` is the marching-tetrahedra
variant (the 6-tet cell decomposition) through
:func:`~kaolin_tpu_torch.ops.conversions.marching_tetrahedra`.
"""

import numpy as np
import torch
import torch.nn.functional as F

from . import mc_tables
from .tetmesh import _CUBE_TETS, marching_tetrahedra

__all__ = ['voxelgrids_to_cubic_meshes', 'voxelgrids_to_trianglemeshes']

_QUAD_TO_TRI = np.array([[0, 1, 3], [3, 2, 0]])


def voxelgrids_to_cubic_meshes(voxelgrids, is_trimesh=True):
    """Replaces each occupied voxel by a unit cuboid, dropping internal
    faces ("Cubify", Mesh R-CNN).

    Reference: ``kaolin/ops/conversions/voxelgrid.py:56``. The exposed
    faces are listed axis by axis in row-major order of their cells, and
    the vertices are the sorted unique corners, as in the JAX package.

    Returns:
        (list of verts (V, 3) float32, list of faces (F, 3 or 4) int64)
        per batch item.
    """
    vg = voxelgrids > 0.5
    out_v, out_f = [], []
    for b in range(vg.shape[0]):
        occ = vg[b]
        quads = []
        for axis in range(3):
            pad = [0, 0] * 3
            pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = 1
            padded = F.pad(occ[None].to(torch.uint8), pad)[0].bool()
            lo = padded.narrow(axis, 0, padded.shape[axis] - 1)
            hi = padded.narrow(axis, 1, padded.shape[axis] - 1)
            # the face between cells i-1 and i along the axis is exposed
            # where their occupancy differs; its normal points away from
            # the occupied cell (-axis when the cell above is occupied)
            exposed = lo != hi
            coords = torch.nonzero(exposed)
            if coords.shape[0] == 0:
                continue
            outward = hi[exposed]
            a1, a2 = [a for a in range(3) if a != axis]
            corners = []
            for d1 in (0, 1):
                for d2 in (0, 1):
                    p = coords.clone()
                    p[:, a1] += d1
                    p[:, a2] += d2
                    corners.append(p)
            corners = torch.stack(corners, dim=1)   # (Q, 4, 3): 00,01,10,11
            order = torch.where(
                outward[:, None],
                torch.tensor([0, 1, 3, 2], device=coords.device),
                torch.tensor([0, 2, 3, 1], device=coords.device))
            quads.append(torch.gather(corners, 1,
                                      order[:, :, None].expand(-1, -1, 3)))
        if not quads:
            out_v.append(torch.zeros((0, 3), device=vg.device))
            out_f.append(torch.zeros((0, 3 if is_trimesh else 4),
                                     dtype=torch.int32, device=vg.device))
            continue
        flat = torch.cat(quads).reshape(-1, 3)
        verts, inv = torch.unique(flat, dim=0, return_inverse=True)
        faces = inv.reshape(-1, 4)
        if is_trimesh:
            faces = faces[:, torch.as_tensor(_QUAD_TO_TRI, device=vg.device)
                          ].reshape(-1, 3)
        out_v.append(verts.to(torch.float32))
        out_f.append(faces)
    return out_v, out_f


# kernel-frame corner offsets (x, y, z); corner c of the marching cube
# (unbatched_mcube_cuda.cu:386-404). The kernel frame maps x -> array
# dim 2, y -> dim 1, z -> dim 0 (the CUDA kernel walks the flat buffer
# with x fastest, and emits positions reversed as (z, y, x)).
_MC_CORNERS = np.array([
    (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)], np.int32)
# the 12 cube edges as (corner a, corner b) index pairs
_MC_EDGES = np.array([
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7)], np.int32)
# every edge is owned by a neighbouring voxel where it coincides with one
# of the owned edges 6/7/11: (dx, dy, dz) of the owner, owned-edge column
# (0 -> edge 6, 1 -> edge 7, 2 -> edge 11)
# (find_target_voxel/find_offset, unbatched_mcube_cuda.cu:215-355)
_MC_EDGE_OWNER = np.array([
    # edge: (dx, dy, dz, owned-col)
    (0, -1, -1, 0),   # 0  -> edge 6 of (y-1, z-1)
    (1, 0, -1, 1),    # 1  -> edge 7 of (x+1, z-1)
    (0, 0, -1, 0),    # 2  -> edge 6 of (z-1)
    (0, 0, -1, 1),    # 3  -> edge 7 of (z-1)
    (0, -1, 0, 0),    # 4  -> edge 6 of (y-1)
    (1, 0, 0, 1),     # 5  -> edge 7 of (x+1)
    (0, 0, 0, 0),     # 6  -> itself
    (0, 0, 0, 1),     # 7  -> itself
    (0, -1, 0, 2),    # 8  -> edge 11 of (y-1)
    (1, -1, 0, 2),    # 9  -> edge 11 of (x+1, y-1)
    (1, 0, 0, 2),     # 10 -> edge 11 of (x+1)
    (0, 0, 0, 2),     # 11 -> itself
], np.int32)


def _tables(device):
    """The marching-cubes tables as int64 tensors on ``device``."""
    t = {name: torch.as_tensor(getattr(mc_tables, name).astype(np.int64),
                               device=device)
         for name in ('NUM_PARTIAL_VERTS', 'NUM_TRIANGLES', 'VERTS_ORDER',
                      'OWNED_EDGE_SLOT', 'TRI_TABLE')}
    t['corners'] = torch.as_tensor(_MC_CORNERS.astype(np.int64),
                                   device=device)
    t['edges'] = torch.as_tensor(_MC_EDGES.astype(np.int64), device=device)
    return t


def _exclusive_scan(x):
    inclusive = torch.cumsum(x, 0)
    return inclusive - x, int(inclusive[-1])


def _unbatched_marching_cubes(grid, iso_value):
    """Lorensen marching cubes over one zero-padded float32 grid. ``grid``
    is indexed [d0, d1, d2]; kernel frame x = d2, y = d1, z = d0. Returns
    (verts float32 (V, 3) in (d0, d1, d2) voxel coords of the padded grid,
    faces int64 (F, 3)) in the reference kernel's exact order.
    """
    Z, Y, X = grid.shape  # kernel-frame extents: z, y, x
    dev = grid.device
    t = _tables(dev)
    # corner fields via edge-clamped shifted views (sampleVolume clamps,
    # unbatched_mcube_cuda.cu:63-71)
    gpad = F.pad(grid[None, None], (0, 1, 0, 1, 0, 1), mode='replicate')[0, 0]
    field = [gpad[oz:oz + Z, oy:oy + Y, ox:ox + X].reshape(-1)
             for (ox, oy, oz) in _MC_CORNERS]
    ci = torch.zeros(Z * Y * X, dtype=torch.int64, device=dev)
    for c in range(8):
        ci |= (field[c] < iso_value).to(torch.int64) << c

    # exclusive scans in voxel memory order (kernel x fastest)
    pv_scan, total_verts = _exclusive_scan(t['NUM_PARTIAL_VERTS'][ci])
    tri_scan, total_tris = _exclusive_scan(t['NUM_TRIANGLES'][ci])
    # only voxels with a crossing emit anything
    active = torch.nonzero((ci != 0) & (ci != 255))[:, 0]
    ca = ci[active]

    verts = torch.zeros((total_verts, 3), dtype=torch.float32, device=dev)
    if total_verts:
        base = torch.stack([active % X, (active // X) % Y, active // (Y * X)],
                           -1).to(torch.float32)    # kernel frame (x, y, z)
        fstack = torch.stack([f[active] for f in field], -1)     # (A, 8)
        order = t['VERTS_ORDER'][ca]                              # (A, 3)
        for slot in range(3):
            sel = torch.nonzero(order[:, slot] != 255)[:, 0]
            if sel.shape[0] == 0:
                continue
            e = order[sel, slot]
            a, b = t['edges'][e, 0], t['edges'][e, 1]
            fa = fstack[sel, a]
            fb = fstack[sel, b]
            w = (iso_value - fa) / (fb - fa)
            pa = t['corners'][a].to(torch.float32)
            pb = t['corners'][b].to(torch.float32)
            v = base[sel] + pa + (pb - pa) * w[:, None]
            verts[pv_scan[active[sel]] + slot] = v.flip(-1)  # (z, y, x)

    faces = torch.zeros((total_tris, 3), dtype=torch.int64, device=dev)
    if total_tris:
        # global vertex index of each voxel's owned edges 6/7/11, shifted
        # to every edge's owner (the owner offsets are in the kernel frame:
        # dx -> dim 2, dy -> dim 1, dz -> dim 0). Out-of-range shifts wrap;
        # the zero padding keeps an emitted triangle from reading them.
        owned = (pv_scan[:, None] + t['OWNED_EDGE_SLOT'][ci]).reshape(
            Z, Y, X, 3)
        edge_vert = torch.stack([
            torch.roll(owned[..., col], (-dz, -dy, -dx), (0, 1, 2))
            for dx, dy, dz, col in _MC_EDGE_OWNER.tolist()]).reshape(12, -1)
        rows = t['TRI_TABLE'][ca]                                 # (A, 16)
        for t_slot in range(5):
            sel = torch.nonzero(rows[:, 3 * t_slot] != 255)[:, 0]
            if sel.shape[0] == 0:
                continue
            vox = active[sel]
            e123 = rows[sel, 3 * t_slot:3 * t_slot + 3]
            # faces are emitted reversed: row = (e3's, e2's, e1's vertex)
            # (unbatched_mcube_cuda.cu:484-501)
            faces[tri_scan[vox] + t_slot] = torch.stack(
                [edge_vert[e123[:, 2], vox], edge_vert[e123[:, 1], vox],
                 edge_vert[e123[:, 0], vox]], -1)
    return verts, faces


def voxelgrids_to_trianglemeshes(voxelgrids, iso_value=0.5, method='mc'):
    """Extracts iso-surface triangle meshes from batched voxelgrids.

    Reference: ``kaolin/ops/conversions/voxelgrid.py:169``. The default
    ``method='mc'`` is Lorensen marching cubes with the reference CUDA
    kernel's vertex and face order; ``method='tets'`` the
    marching-tetrahedra variant (a finer triangulation of the same
    iso-surface). The input is zero-padded by one voxel on all sides like
    the reference, so vertex coordinates are offset by +1 voxel.

    Returns:
        (list of verts (V, 3), list of faces (F, 3)) per batch item: float32
        verts and int32 faces for ``'mc'``, float64 verts and int64 faces
        for ``'tets'``.
    """
    out_v, out_f = [], []
    if method == 'mc':
        for b in range(voxelgrids.shape[0]):
            grid = F.pad(voxelgrids[b].to(torch.float32), (1, 1) * 3)
            if not bool(grid.any()):
                out_v.append(torch.zeros((0, 3), dtype=torch.float32,
                                         device=grid.device))
                out_f.append(torch.zeros((0, 3), dtype=torch.int32,
                                         device=grid.device))
                continue
            verts, faces = _unbatched_marching_cubes(grid, float(iso_value))
            out_v.append(verts)
            out_f.append(faces.to(torch.int32))
        return out_v, out_f
    if method != 'tets':
        raise ValueError(f"unknown method: {method!r} (use 'mc' or 'tets')")
    for b in range(voxelgrids.shape[0]):
        grid = F.pad(voxelgrids[b].to(torch.float64), (1, 1) * 3)
        dev = grid.device
        X, Y, Z = grid.shape
        # grid vertices and SDF (= iso - value, so > 0 outside)
        ii, jj, kk = torch.meshgrid(
            torch.arange(X, device=dev), torch.arange(Y, device=dev),
            torch.arange(Z, device=dev), indexing='ij')
        verts = torch.stack([ii, jj, kk], -1).reshape(-1, 3)
        sdf = (iso_value - grid).reshape(-1)

        ci, cj, ck = torch.meshgrid(
            torch.arange(X - 1, device=dev), torch.arange(Y - 1, device=dev),
            torch.arange(Z - 1, device=dev), indexing='ij')
        ci, cj, ck = ci.reshape(-1), cj.reshape(-1), ck.reshape(-1)
        corner_ids = torch.stack([
            ((ci + (c >> 2 & 1)) * Y + cj + (c >> 1 & 1)) * Z + ck + (c & 1)
            for c in range(8)], -1)                       # (C, 8)
        # only keep cells containing a crossing (memory)
        s = (sdf[corner_ids] > 0).sum(-1)
        active = (s > 0) & (s < 8)
        tets = corner_ids[active][:, torch.as_tensor(_CUBE_TETS, device=dev)
                                  ].reshape(-1, 4)
        if tets.shape[0] == 0:
            out_v.append(torch.zeros((0, 3), dtype=torch.float64, device=dev))
            out_f.append(torch.zeros((0, 3), dtype=torch.int64, device=dev))
            continue
        vlist, flist = marching_tetrahedra(
            verts.to(torch.float64)[None], tets, sdf[None])
        # -1 to undo padding, +0.5 for voxel-center convention
        out_v.append(vlist[0] - 1.0 + 0.5)
        out_f.append(flist[0])
    return out_v, out_f
