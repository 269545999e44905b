"""Tetrahedral-mesh quality losses. Port of
``kaolin_tpu/metrics/tetmesh.py`` (reference
``kaolin/metrics/tetmesh.py:20-195``)."""

import torch

from ..ops.mesh.tetmesh import _offsets, _validate_tet_vertices

__all__ = ['tetrahedron_volume', 'equivolume', 'amips']


def tetrahedron_volume(tet_vertices):
    """Signed volume of each tetrahedron: ``(A-D).((B-D)x(C-D)) / 6``,
    (batch_size, num_tetrahedrons)."""
    _validate_tet_vertices(tet_vertices)
    A = tet_vertices[:, :, 0]
    B = tet_vertices[:, :, 1]
    C = tet_vertices[:, :, 2]
    D = tet_vertices[:, :, 3]
    return torch.sum((A - D) * torch.linalg.cross(B - D, C - D), dim=2) / 6.


def equivolume(tet_vertices, tetrahedrons_mean=None, pow=4):
    """EquiVolume loss (Gao et al., DefTet NeurIPS 2020), (batch_size,
    1)."""
    _validate_tet_vertices(tet_vertices)
    volumes = tetrahedron_volume(tet_vertices)
    if tetrahedrons_mean is None:
        tetrahedrons_mean = torch.mean(volumes, dim=-1)
    tetrahedrons_mean = torch.reshape(
        torch.as_tensor(tetrahedrons_mean, dtype=volumes.dtype,
                        device=volumes.device), (1, -1))
    return torch.mean(torch.abs(volumes - tetrahedrons_mean) ** pow, dim=-1,
                      keepdim=True)


def amips(tet_vertices, inverse_offset_matrix):
    """AMIPS energy (Fu et al. SIGGRAPH 2015) over the tetrahedrons with a
    non-negative Jacobian determinant, (batch_size, 1)."""
    _validate_tet_vertices(tet_vertices)
    jacobian = torch.matmul(_offsets(tet_vertices), inverse_offset_matrix)
    j_det = torch.linalg.det(jacobian)
    jj = torch.matmul(jacobian, jacobian.transpose(-2, -1))
    trace = jj.diagonal(dim1=-2, dim2=-1).sum(dim=-1)
    EPS = 1e-10
    denominator = (j_det ** 2 + EPS) ** (1. / 3.)
    return torch.mean((trace / denominator) * (j_det >= 0), dim=1,
                      keepdim=True)
