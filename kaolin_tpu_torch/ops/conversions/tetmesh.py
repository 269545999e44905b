"""Marching tetrahedra (the DMTet core), differentiable with respect to the
vertices and the SDF values, and the regular tet grid. Port of
``kaolin_tpu/ops/conversions/tetmesh.py`` (reference
``kaolin/ops/conversions/tetmesh.py:20-165``).

- :func:`marching_tetrahedra`: topology chosen on the host (numpy) from the
  SDF's values, vertices interpolated with tensor operations;
- :func:`marching_tetrahedra_fixed`: fixed shapes, vertices on every edge
  of the grid (masked to the crossings) and two faces per tetrahedron with
  a validity mask. Its grid's edges are found on the host; a loop over one
  grid makes them once with :func:`tet_topology` and passes that in place
  of the tets.
"""

from typing import NamedTuple

import numpy as np
import torch

__all__ = ['marching_tetrahedra', 'marching_tetrahedra_fixed', 'tet_grid',
           'TetTopology', 'tet_topology']

# kaolin/ops/conversions/tetmesh.py:20-40
TRIANGLE_TABLE = np.array([
    [-1, -1, -1, -1, -1, -1],
    [1, 0, 2, -1, -1, -1],
    [4, 0, 3, -1, -1, -1],
    [1, 4, 2, 1, 3, 4],
    [3, 1, 5, -1, -1, -1],
    [2, 3, 0, 2, 5, 3],
    [1, 4, 0, 1, 5, 4],
    [4, 2, 5, -1, -1, -1],
    [4, 5, 2, -1, -1, -1],
    [4, 1, 0, 4, 5, 1],
    [3, 2, 0, 3, 5, 2],
    [1, 3, 5, -1, -1, -1],
    [4, 1, 2, 4, 3, 1],
    [3, 0, 4, -1, -1, -1],
    [2, 0, 1, -1, -1, -1],
    [-1, -1, -1, -1, -1, -1]], dtype=np.int64)

NUM_TRIANGLES_TABLE = np.array([0, 1, 1, 2, 1, 2, 2, 1, 1, 2, 2, 1, 2, 1,
                                1, 0], dtype=np.int64)
BASE_TET_EDGES = np.array([0, 1, 0, 2, 0, 3, 1, 2, 1, 3, 2, 3],
                          dtype=np.int64)
# the 6 tetrahedra of a cube by corner index c = x<<2 | y<<1 | z (the JAX
# package's ops/conversions/voxelgrid.py _CUBE_TETS)
_CUBE_TETS = np.array([
    [0, 4, 6, 7],
    [0, 4, 7, 5],
    [0, 5, 7, 1],
    [0, 6, 2, 7],
    [0, 2, 3, 7],
    [0, 3, 1, 7],
], dtype=np.int64)


def _host(a):
    return np.asarray(a.detach().cpu() if torch.is_tensor(a) else a)


def _grid_edges(tets_np):
    """Unique sorted edges of the tet grid + per-tet edge->unique map (in
    the order of ``np.unique(..., axis=0)``: an edge (a, b), a < b, is
    keyed by a * n + b)."""
    all_edges = np.sort(tets_np[:, BASE_TET_EDGES].reshape(-1, 2), axis=1)
    n = int(all_edges.max()) + 1 if all_edges.size else 1
    keys, idx_map = np.unique(all_edges[:, 0] * n + all_edges[:, 1],
                              return_inverse=True)
    unique_edges = np.stack([keys // n, keys % n], axis=1)
    return unique_edges, idx_map.reshape(-1, 6)


class TetTopology(NamedTuple):
    """A tet grid's fixed topology on a device, for
    :func:`marching_tetrahedra_fixed`."""
    tets: torch.Tensor        # (T, 4) int64
    edge0: torch.Tensor       # (E,) int64, first vertex of each edge
    edge1: torch.Tensor       # (E,) int64
    idx_map6: torch.Tensor    # (T, 6) int64, each tet's edges
    num_triangles: torch.Tensor   # NUM_TRIANGLES_TABLE
    triangles: torch.Tensor       # TRIANGLE_TABLE
    bits: torch.Tensor            # (4,) [1, 2, 4, 8]


def tet_topology(tets, device):
    """The edges and tables that :func:`marching_tetrahedra_fixed` needs for
    the tets ``tets`` (T, 4), found on the host once and put on
    ``device``."""
    tets_np = _host(tets).astype(np.int64)
    unique_edges, idx_map6 = _grid_edges(tets_np)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return TetTopology(t(tets_np), t(unique_edges[:, 0]),
                       t(unique_edges[:, 1]), t(idx_map6),
                       t(NUM_TRIANGLES_TABLE), t(TRIANGLE_TABLE),
                       t(np.array([1, 2, 4, 8], dtype=np.int64)))


def _interp_verts(vertices, sdf, edges):
    """Linear zero-crossing interpolation on edges (differentiable), as
    ``kaolin/ops/conversions/tetmesh.py:82-90``."""
    va = vertices[edges[:, 0]]
    vb = vertices[edges[:, 1]]
    sa = sdf[edges[:, 0]]
    sb = sdf[edges[:, 1]]
    denom = sa - sb
    wa = -sb / denom
    wb = sa / denom
    return va * wa[:, None] + vb * wb[:, None]


def _unbatched_mt(vertices, tets_np, sdf, return_tet_idx):
    dev = vertices.device
    occ_n = _host(sdf) > 0
    occ_fx4 = occ_n[tets_np]
    occ_sum = occ_fx4.sum(-1)
    valid_tets = (occ_sum > 0) & (occ_sum < 4)
    vt = tets_np[valid_tets]

    all_edges = np.sort(vt[:, BASE_TET_EDGES].reshape(-1, 2), axis=1)
    unique_edges, idx_map = np.unique(all_edges, axis=0, return_inverse=True)
    mask_edges = occ_n[unique_edges].sum(-1) == 1
    mapping = np.full(unique_edges.shape[0], -1, dtype=np.int64)
    mapping[mask_edges] = np.arange(mask_edges.sum())
    idx_map = mapping[idx_map.reshape(-1)].reshape(-1, 6)
    interp_edges = unique_edges[mask_edges]

    verts = _interp_verts(vertices, sdf,
                          torch.as_tensor(interp_edges, device=dev))

    tetindex = (occ_fx4[valid_tets] * (2 ** np.arange(4))).sum(-1)
    num_tri = NUM_TRIANGLES_TABLE[tetindex]
    faces1 = np.take_along_axis(
        idx_map[num_tri == 1], TRIANGLE_TABLE[tetindex[num_tri == 1]][:, :3],
        axis=1).reshape(-1, 3)
    faces2 = np.take_along_axis(
        idx_map[num_tri == 2], TRIANGLE_TABLE[tetindex[num_tri == 2]][:, :6],
        axis=1).reshape(-1, 3)
    faces = torch.as_tensor(np.concatenate([faces1, faces2], axis=0),
                            device=dev)
    if return_tet_idx:
        tid = np.arange(tets_np.shape[0])[valid_tets]
        tet_idx = np.concatenate([tid[num_tri == 1],
                                  np.repeat(tid[num_tri == 2], 2)])
        return verts, faces, torch.as_tensor(tet_idx, device=dev)
    return verts, faces


def marching_tetrahedra(vertices, tets, sdf, return_tet_idx=False):
    """Converts SDFs on tet grids to triangle meshes.

    Output vertices are differentiable with respect to ``vertices`` and
    ``sdf``; the topology is chosen on the host from the SDF's values.

    Args:
        vertices: (batch_size, num_vertices, 3).
        tets: (num_tetrahedrons, 4) integer tensor or array.
        sdf: (batch_size, num_vertices).
        return_tet_idx: also return the source tet index of each face.

    Returns:
        (list of verts, list of faces (int64)[, list of tet_idx (int64)]),
        one entry per batch item, on the vertices' device.
    """
    tets_np = _host(tets).astype(np.int64)
    outs = [_unbatched_mt(vertices[b], tets_np, sdf[b], return_tet_idx)
            for b in range(vertices.shape[0])]
    return tuple(list(z) for z in zip(*outs))


def marching_tetrahedra_fixed(vertices, tets, sdf):
    """Marching tetrahedra with fixed shapes.

    Vertices are computed for ALL unique grid edges (masked to actual
    sign crossings); faces are emitted as 2 triangles per tet with a
    validity mask. Differentiable with respect to ``vertices`` and
    ``sdf``.

    Args:
        vertices: (num_vertices, 3) (unbatched).
        tets: (num_tetrahedrons, 4) host numpy int array (fixed topology),
            or its :func:`tet_topology`.
        sdf: (num_vertices,).

    Returns:
        (verts (E, 3), verts_mask (E,) bool -- True where the edge crosses
        the surface, others hold midpoints; faces (2*T, 3) int32 indices
        into the edge-vertex array; faces_mask (2*T,) bool; tet_idx (2*T,)
        int32).
    """
    topo = tets if isinstance(tets, TetTopology) \
        else tet_topology(tets, vertices.device)
    dev = vertices.device
    T = topo.tets.shape[0]
    e0, e1 = topo.edge0, topo.edge1

    sa, sb = sdf[e0], sdf[e1]
    crossing = (sa > 0) != (sb > 0)
    # guard the denominator on non-crossing edges
    denom = torch.where(crossing, sa - sb, torch.ones_like(sa))
    va, vb = vertices[e0], vertices[e1]
    half = torch.full_like(sa, 0.5)
    wa = torch.where(crossing, -sb / denom, half)
    wb = torch.where(crossing, sa / denom, half)
    verts = va * wa[:, None] + vb * wb[:, None]

    occ = (sdf[topo.tets] > 0).to(torch.int64)
    tetindex = torch.sum(occ * topo.bits, dim=-1)
    ntri = topo.num_triangles[tetindex]
    local = topo.triangles[tetindex]                                 # (T, 6)
    gidx = torch.gather(topo.idx_map6, 1, local.clamp(min=0))        # (T, 6)
    faces = gidx.reshape(T * 2, 3).to(torch.int32)
    faces_mask = torch.stack([ntri >= 1, ntri >= 2], dim=1).reshape(-1)
    tet_idx = torch.arange(T, dtype=torch.int32,
                           device=dev).repeat_interleave(2)
    return verts, crossing, faces, faces_mask, tet_idx


def tet_grid(res, normalize=True):
    """Regular tetrahedral grid: (res+1)^3 lattice vertices, 6 tets per
    cell -- the DMTet working grid.

    Args:
        res: cells per axis.
        normalize: scale vertices into [-0.5, 0.5]^3 (else integer
            lattice coordinates).

    Returns:
        (vertices (N, 3) float32 numpy, tets (6*res^3, 4) int64 numpy) --
        host-side fixed topology for :func:`marching_tetrahedra_fixed`.
    """
    n = res + 1
    ii, jj, kk = np.meshgrid(np.arange(n), np.arange(n), np.arange(n),
                             indexing='ij')
    verts = np.stack([ii, jj, kk], -1).reshape(-1, 3).astype(np.float32)
    if normalize:
        verts = verts / res - 0.5
    ci, cj, ck = np.meshgrid(np.arange(res), np.arange(res),
                             np.arange(res), indexing='ij')
    ci, cj, ck = ci.ravel(), cj.ravel(), ck.ravel()
    corner_ids = np.stack([
        ((ci + (c >> 2 & 1)) * n + (cj + (c >> 1 & 1))) * n + (ck + (c & 1))
        for c in range(8)], -1)                        # (res^3, 8)
    tets = corner_ids[:, _CUBE_TETS].reshape(-1, 4).astype(np.int64)
    return verts, tets
