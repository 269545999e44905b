"""Loop-style differentiable mesh subdivision with a learnable alpha. Port
of ``kaolin_tpu/ops/mesh/subdivision.py`` (reference
``kaolin/ops/mesh/trianglemesh.py:481``, ``subdivide_trianglemesh``).

The topology (edge dedup, face pairing) is worked out on the host with
numpy, as in the JAX package: connectivity is static metadata. The vertex
and alpha updates are tensor operations on the vertices' device and
differentiable (the DMTet use case). The neighbour sums are an
``index_add_``, whose CUDA atomics add in no fixed order: on the card the
new vertices agree with the CPU's to float32 rounding, not bit for bit.
"""

import math

import numpy as np
import torch

__all__ = ['subdivide_trianglemesh']


def _get_alpha(n):
    """Loop-subdivision weight per vertex valence
    (``kaolin/ops/mesh/trianglemesh.py:467``)."""
    alpha = (5.0 / 8 - (3.0 / 8 + 1.0 / 4 * np.cos(2 * math.pi / n)) ** 2) / n
    alpha = np.where(n == 3, 3. / 16., alpha)
    return alpha


def _take(x, idx):
    """``x[:, idx]`` with ``idx`` a numpy index array."""
    return x[:, torch.as_tensor(np.asarray(idx, np.int64), device=x.device)]


def subdivide_trianglemesh(vertices, faces, iterations, alpha=None):
    """Subdivides triangle meshes following Loop subdivision; with a given
    per-vertex ``alpha`` the positional update is differentiable and alpha
    carries over iterations (alpha=0 pins a vertex).

    Reference: ``kaolin/ops/mesh/trianglemesh.py:481``.

    Args:
        vertices: (batch_size, num_vertices, 3).
        faces: (num_faces, 3) int (host or device).
        iterations (int): number of subdivision rounds.
        alpha: optional (batch_size, num_vertices) smoothing factors.

    Returns:
        (new_vertices (B, V', 3), new_faces (F * 4**iterations, 3)), the
        faces on the vertices' device.
    """
    faces_np = faces.detach().cpu().numpy() if torch.is_tensor(faces) \
        else np.asarray(faces)
    dev, dtype = vertices.device, vertices.dtype
    init_alpha = alpha
    if alpha is not None and alpha.ndim == 2:
        alpha = alpha[..., None]
    for _ in range(iterations):
        b, v = vertices.shape[0], vertices.shape[1]
        f = faces_np.shape[0]

        edges = faces_np[:, [[0, 1], [1, 2], [2, 0]]].reshape(-1, 2)
        edges_sorted = np.sort(edges, axis=-1)
        all_edges_face_idx = np.repeat(np.arange(f), 3)
        edges_ex2, inverse_indices, counts = np.unique(
            edges_sorted, axis=0, return_inverse=True, return_counts=True)
        inverse_indices = inverse_indices.reshape(-1)
        e = edges_ex2.shape[0]

        # symmetric vertex adjacency -> valence n (trianglemesh.py:455-464)
        adj_idx = np.unique(np.concatenate(
            [edges_ex2, edges_ex2[:, ::-1]]), axis=0)
        n_np = np.bincount(adj_idx[:, 1], minlength=v).astype(np.float64)
        n = torch.as_tensor(n_np, dtype=dtype, device=dev)[:, None]

        if init_alpha is None:
            alpha = torch.as_tensor(_get_alpha(n_np) * n_np, dtype=dtype,
                                    device=dev)[None, :, None]
        if alpha.ndim == 2:
            alpha = alpha[..., None]

        # neighbour sum: each directed edge adds its source to its target
        gathered = _take(vertices, adj_idx[:, 0])
        dst = torch.as_tensor(adj_idx[:, 1], device=dev)
        adj_sum = torch.zeros_like(vertices).index_add_(1, dst, gathered)
        vertices_new = (1 - alpha) * vertices + alpha / n * adj_sum

        # interior edges: mean over the 6 verts of the 2 adjacent faces
        # plus the 2 edge verts; boundary edges: midpoint
        mask_e = counts == 2
        mids = _take(vertices, edges_ex2.reshape(-1)).reshape(b, e, 2, 3)
        mid_alpha = _take(alpha, edges_ex2.reshape(-1)).reshape(
            alpha.shape[0], e, 2, 1)
        edge_points = torch.mean(mids, dim=2)
        alpha_points = torch.mean(mid_alpha, dim=2)

        if mask_e.any():
            counts_f = counts[inverse_indices]
            mask_f = counts_f == 2
            group = inverse_indices[mask_f]
            order = np.argsort(group, kind='stable')
            edges_grouped = all_edges_face_idx[mask_f][order]
            edges_face_idx = np.stack(
                [edges_grouped[::2], edges_grouped[1::2]], axis=-1)
            edges_face = faces_np[edges_face_idx.reshape(-1)].reshape(-1, 2, 3)
            int_ids = torch.as_tensor(np.where(mask_e)[0], device=dev)
            verts6 = _take(vertices, edges_face.reshape(-1)).reshape(
                b, -1, 6, 3)
            ends2 = _take(vertices, edges_ex2[mask_e].reshape(-1)).reshape(
                b, -1, 2, 3)
            interior_pts = torch.cat([verts6, ends2], dim=2).mean(2)
            a6 = _take(alpha, edges_face.reshape(-1)).reshape(
                alpha.shape[0], -1, 6, 1)
            a2 = _take(alpha, edges_ex2[mask_e].reshape(-1)).reshape(
                alpha.shape[0], -1, 2, 1)
            interior_alpha = torch.cat([a6, a2], dim=2).mean(2)
            edge_points = edge_points.index_copy(1, int_ids, interior_pts)
            alpha_points = alpha_points.index_copy(1, int_ids, interior_alpha)

        alpha = torch.cat([alpha, alpha_points], dim=1)
        vertices = torch.cat([vertices_new, edge_points], dim=1)
        edges_fx3 = inverse_indices.reshape(f, 3) + v
        faces6 = np.concatenate([faces_np, edges_fx3], axis=1)
        faces_np = faces6[:, [[1, 4, 3], [0, 3, 5], [2, 5, 4],
                              [5, 3, 4]]].reshape(-1, 3)
    return vertices, torch.as_tensor(faces_np, device=dev)
