"""Sharded point metrics: queries split over the ranks, targets replicated.

Port of ``kaolin_tpu/parallel/metrics.py``. The query points split over
every rank of the mesh (both axes flattened, data-major: metric workloads
have no image plane), the target cloud or face table is replicated, and
each rank runs the port's kernel on its slice. The forward exchanges
nothing but the Chamfer sum. The replicated operand (and the split one,
which every rank also holds whole) passes through
:func:`kaolin_tpu_torch.parallel.mesh.replicate`, so every rank's gradient
is the one-process gradient.
"""

import torch

from ..metrics.pointcloud import sided_distance
from ..metrics.trianglemesh import point_to_mesh_distance
from .mesh import flat_index, mesh_sum, replicate

__all__ = ['sharded_sided_distance', 'sharded_chamfer_distance',
           'sharded_point_to_mesh_distance']


def _split(mesh, queries, *replicated):
    """This rank's slice of ``queries`` (B, N, ...) along N, and the
    replicated tensors, all through ``replicate``."""
    n, i = flat_index(mesh)
    num = queries.shape[1]
    assert num % n == 0, (num, n)
    per = num // n
    queries, *replicated = replicate(mesh, queries, *replicated)
    return (queries[:, i * per:(i + 1) * per], *replicated)


def sharded_sided_distance(mesh, p1, p2, backend='auto'):
    """:func:`sided_distance` with ``p1`` split over every rank of the
    mesh and ``p2`` replicated. Returns this rank's slice of (dist (B, N1),
    idx (B, N1)); N1 must divide by the number of ranks. Differentiable:
    with every rank's loss summed, every rank gets its gradient."""
    return sided_distance(*_split(mesh, p1, p2), backend=backend)


def sharded_chamfer_distance(mesh, p1, p2, w1=1., w2=1., squared=True,
                             backend='auto'):
    """:func:`chamfer_distance` over the mesh: each direction splits its
    query side and replicates the other; each rank's sums over its
    queries are summed over the mesh (:func:`mesh_sum`, whose backward is
    the identity, so that the replicated inputs' gradient sum counts each
    rank once). Returns the full (B,) value on every rank."""
    sdist1 = sided_distance(*_split(mesh, p1, p2), backend=backend)[0]
    sdist2 = sided_distance(*_split(mesh, p2, p1), backend=backend)[0]
    if not squared:
        sdist1 = torch.sqrt(sdist1)
        sdist2 = torch.sqrt(sdist2)
    sums = mesh_sum(mesh, torch.stack([sdist1.sum(dim=-1),
                                       sdist2.sum(dim=-1)]))
    return w1 * (sums[0] / p1.shape[1]) + w2 * (sums[1] / p2.shape[1])


def sharded_point_to_mesh_distance(mesh, pointclouds, face_vertices,
                                   backend='auto'):
    """:func:`point_to_mesh_distance` with the points split over every
    rank of the mesh and the face table replicated. Returns this rank's
    slice of (distance, face_idx, dist_type)."""
    return point_to_mesh_distance(*_split(mesh, pointclouds, face_vertices),
                                  backend=backend)
