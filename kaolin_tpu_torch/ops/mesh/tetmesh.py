"""Tetrahedral-mesh utilities. Port of ``kaolin_tpu/ops/mesh/tetmesh.py``
(reference ``kaolin/ops/mesh/tetmesh.py:41-181``)."""

import numpy as np
import torch

__all__ = ['inverse_vertices_offset', 'subdivide_tetmesh']

# pairs (A,B),(A,C),(A,D),(B,C),(B,D),(C,D) -- kaolin/ops/mesh/tetmesh.py:19
BASE_TET_EDGES = np.array([0, 1, 0, 2, 0, 3, 1, 2, 1, 3, 2, 3],
                          dtype=np.int64)


def _validate_tet_vertices(tet_vertices):
    assert tet_vertices.ndim == 4, \
        f"tetrahedrons has {tet_vertices.ndim} but must have 4 dimensions."
    assert tet_vertices.shape[2] == 4, \
        "the third dimension of the tetrahedrons must be 4"
    assert tet_vertices.shape[3] == 3, \
        "the fourth dimension of the tetrahedrons must be 3"


def _offsets(tet_vertices):
    """(B, T, 3, 3) rows B-A, C-A, D-A of each tetrahedron."""
    A = tet_vertices[:, :, 0:1]
    return torch.cat([tet_vertices[:, :, 1:2] - A,
                      tet_vertices[:, :, 2:3] - A,
                      tet_vertices[:, :, 3:4] - A], dim=2)


def inverse_vertices_offset(tet_vertices):
    """Inverse of the per-tet offset matrix [B-A; C-A; D-A].

    Args:
        tet_vertices: (batch_size, num_tetrahedrons, 4, 3).

    Returns:
        (batch_size, num_tetrahedrons, 3, 3).
    """
    _validate_tet_vertices(tet_vertices)
    return torch.linalg.inv(_offsets(tet_vertices))


def subdivide_tetmesh(vertices, tetrahedrons, features=None):
    """Subdivides each tetrahedron into 8 by adding edge midpoints
    (DMTet-style); features of new vertices are edge averages. The edge
    dedup runs on host numpy.

    Args:
        vertices: (batch_size, num_vertices, 3).
        tetrahedrons: (num_tetrahedrons, 4) integer tensor or array.
        features: optional (batch_size, num_vertices, feat_dim).

    Returns:
        (new_vertices, new_tetrahedrons (int64, on the vertices' device)[,
        new_features]).
    """
    tets_np = np.asarray(tetrahedrons.cpu() if torch.is_tensor(tetrahedrons)
                         else tetrahedrons).astype(np.int64)
    num_vertices = vertices.shape[1]
    all_edges = np.sort(tets_np[:, BASE_TET_EDGES].reshape(-1, 2), axis=1)
    unique_edges, idx_map = np.unique(all_edges, axis=0, return_inverse=True)
    idx_map = idx_map.reshape(-1) + num_vertices

    pos_feature = vertices if features is None else \
        torch.cat([vertices, features], dim=-1)
    edges = torch.as_tensor(unique_edges.reshape(-1), device=vertices.device)
    gathered = pos_feature[:, edges]
    mid = gathered.reshape(pos_feature.shape[0], -1, 2,
                           pos_feature.shape[-1]).mean(dim=2)
    new_pos_feature = torch.cat([pos_feature, mid], dim=1)
    new_pos = new_pos_feature[..., :3]
    new_features = new_pos_feature[..., 3:]

    idx_a, idx_b, idx_c, idx_d = np.split(tets_np, 4, axis=-1)
    (idx_ab, idx_ac, idx_ad, idx_bc, idx_bd,
     idx_cd) = np.split(idx_map.reshape(-1, 6), 6, axis=-1)
    tets = np.concatenate([
        np.concatenate([idx_a, idx_ab, idx_ac, idx_ad], axis=1),
        np.concatenate([idx_b, idx_bc, idx_ab, idx_bd], axis=1),
        np.concatenate([idx_c, idx_ac, idx_bc, idx_cd], axis=1),
        np.concatenate([idx_d, idx_ad, idx_cd, idx_bd], axis=1),
        np.concatenate([idx_ab, idx_ac, idx_ad, idx_bd], axis=1),
        np.concatenate([idx_ab, idx_ac, idx_bd, idx_bc], axis=1),
        np.concatenate([idx_cd, idx_ac, idx_bd, idx_ad], axis=1),
        np.concatenate([idx_cd, idx_ac, idx_bc, idx_bd], axis=1),
    ], axis=0)
    new_tets = torch.as_tensor(tets, device=vertices.device)
    if features is None:
        return new_pos, new_tets
    return new_pos, new_tets, new_features
