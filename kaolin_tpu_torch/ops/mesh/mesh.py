"""Mesh indexing and graph structure ops. Port of
``kaolin_tpu/ops/mesh/mesh.py``."""

import numpy as np
import torch

__all__ = ['index_vertices_by_faces', 'adjacency_matrix', 'uniform_laplacian']


def index_vertices_by_faces(vertices_features, faces):
    """Gathers per-vertex features into per-face per-vertex layout.

    Args:
        vertices_features: (batch_size, num_vertices, feat_dim).
        faces: (num_faces, face_size) integer tensor.

    Returns:
        (batch_size, num_faces, face_size, feat_dim).
    """
    if vertices_features.ndim != 3:
        raise ValueError("vertices_features must have 3 dimensions "
                         "(batch_size, num_points, knum)")
    if faces.ndim != 2:
        raise ValueError("faces must have 2 dimensions "
                         "(num_faces, num_vertices)")
    return vertices_features[:, faces.long()]


def adjacency_matrix(num_vertices, faces, sparse=False, device='cuda'):
    """Vertex adjacency matrix of a mesh, dense float32 (V, V).

    The edge list is built in numpy from the faces, as in the JAX package
    (so a faces tensor on the card is copied to the host); the dense
    matrix is filled on the faces' device, or on ``device`` when the faces
    are a host array. ``sparse=True`` returns ``(indices (2, E) int64,
    values (E,) float32)`` instead.
    """
    if isinstance(faces, torch.Tensor):
        faces_np, dev = faces.detach().cpu().numpy(), faces.device
    else:
        faces_np, dev = np.asarray(faces), torch.device(device)
    fwd = np.stack([faces_np, np.roll(faces_np, 1, axis=-1)], axis=-1)
    bwd = np.stack([np.roll(faces_np, 1, axis=-1), faces_np], axis=-1)
    indices = np.concatenate([fwd, bwd], axis=1).reshape(-1, 2)
    indices = torch.as_tensor(np.unique(indices, axis=0).T.astype(np.int64),
                              device=dev)
    if sparse:
        return indices, torch.ones(indices.shape[1], dtype=torch.float32,
                                   device=dev)
    adj = torch.zeros((num_vertices, num_vertices), dtype=torch.float32,
                      device=dev)
    adj[indices[0], indices[1]] = 1.
    return adj


def uniform_laplacian(num_vertices, faces, device='cuda'):
    """Uniform graph laplacian: ``L[i, j] = 1 / deg(i)`` for neighbours,
    ``-1`` on the diagonal, ``0`` elsewhere (an isolated vertex's row is 0
    off the diagonal). On the device of :func:`adjacency_matrix`."""
    adj = adjacency_matrix(num_vertices, faces, device=device)
    num_neighbour = adj.sum(dim=1, keepdim=True)
    L = torch.where(num_neighbour > 0, adj / num_neighbour,
                    torch.zeros_like(adj))
    L.diagonal().fill_(-1.)
    return L
