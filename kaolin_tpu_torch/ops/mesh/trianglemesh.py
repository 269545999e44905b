"""Triangle-mesh geometry: areas, normals, point sampling, edge lengths.
Port of ``kaolin_tpu/ops/mesh/trianglemesh.py``.

``sample_points`` and ``packed_sample_points`` take a ``torch.Generator``
where the JAX package takes a PRNG key; the two give different numbers.
Their deterministic parts are named helpers that take the uniforms
(:func:`_picks_from_cdf`, :func:`_barycentric`), so that both packages can
be fed the same draws.
"""

import numpy as np
import torch

from ..batch import get_first_idx, segment_ids_from_numel

__all__ = [
    'face_areas',
    'packed_face_areas',
    'sample_points',
    'packed_sample_points',
    'face_normals',
    'average_edge_length',
]


def _base_face_areas(v0, v1, v2):
    """Face areas from the three per-face vertex tensors (..., 3)."""
    x1, x2, x3 = (v0 - v1).split(1, dim=-1)
    y1, y2, y3 = (v1 - v2).split(1, dim=-1)
    a = (x2 * y3 - x3 * y2) ** 2
    b = (x3 * y1 - x1 * y3) ** 2
    c = (x1 * y2 - x2 * y1) ** 2
    return torch.sqrt(a + b + c) * 0.5


def _check_triangles(faces, fn):
    if faces.shape[-1] != 3:
        raise NotImplementedError(
            f"{fn} is only implemented for triangle meshes")


def _corners(vertices, faces):
    """(v0, v1, v2), each (B, F, 3): the corners of every face."""
    faces = faces.long()
    return tuple(vertices[:, faces[:, k]] for k in range(3))


def face_areas(vertices, faces):
    """Areas of each face of batched triangle meshes.

    Args:
        vertices: (batch_size, num_vertices, 3).
        faces: (num_faces, 3) integer tensor.

    Returns:
        (batch_size, num_faces).
    """
    _check_triangles(faces, 'face_areas')
    return _base_face_areas(*_corners(vertices, faces))[..., 0]


def _merged_faces(faces, first_idx_vertices, num_faces_per_mesh):
    """Packed faces shifted to index the packed vertices."""
    first_idx_vertices = np.asarray(first_idx_vertices)
    seg = segment_ids_from_numel(num_faces_per_mesh, device=faces.device)
    offset = torch.as_tensor(first_idx_vertices[:-1],
                             device=faces.device)[seg.long()]
    return faces.long() + offset[:, None]


def packed_face_areas(vertices, first_idx_vertices, faces, num_faces_per_mesh):
    """Areas of each face of packed triangle meshes: ``vertices``
    (total_vertices, 3), ``faces`` (total_faces, 3) indexing each mesh's
    own vertices. Returns (total_faces,)."""
    _check_triangles(faces, 'packed_face_areas')
    merged = _merged_faces(faces, first_idx_vertices, num_faces_per_mesh)
    v0, v1, v2 = (vertices[merged[:, k]] for k in range(3))
    return _base_face_areas(v0, v1, v2).reshape(-1)


def _barycentric(u, v):
    """Uniform barycentric weights over a triangle from two uniforms in
    [0, 1): ``s = sqrt(u)``, ``w = (1 - s, s(1 - v), sv)``."""
    s = torch.sqrt(u)
    return 1. - s, s * (1. - v), s * v


def _picks_from_cdf(cdf, q):
    """Inverse-CDF picks: for each ``q`` (B, S) in [0, total], the first
    face whose cumulative area ``cdf`` (B, F) exceeds it, clamped to the
    last face of positive area (a ``q`` that rounds up to the total would
    fall past the end), so faces of zero area are never picked. (B, S)
    int32."""
    pick = torch.searchsorted(cdf, q, right=True)
    last_pos = torch.searchsorted(cdf, cdf[:, -1:].contiguous())
    return torch.minimum(pick, last_pos).to(torch.int32)


def _face_choices(areas, u):
    """Area-weighted face picks from uniforms ``u`` (B, S) in [0, 1), by
    inverse CDF; the areas carry no gradient through the choice."""
    cdf = torch.cumsum(areas.detach().clamp(min=0.), dim=-1)
    return _picks_from_cdf(cdf, (u * cdf[:, -1:]).contiguous())


def _draws(batch_size, num_samples, dtype, device, generator):
    """The three uniform draws of a sampling call, in the JAX package's
    order: (face (B, S), barycentric u (B, S, 1), barycentric v (B, S,
    1))."""
    def rand(*shape):
        return torch.rand(shape, generator=generator, dtype=dtype,
                          device=device)
    return (rand(batch_size, num_samples), rand(batch_size, num_samples, 1),
            rand(batch_size, num_samples, 1))


def _sample_from_uniforms(vertices, faces, u_face, u_bary, v_bary,
                          areas=None, face_features=None):
    """:func:`sample_points` from its uniforms: ``u_face`` (B, S) picks the
    faces, ``u_bary`` and ``v_bary`` (B, S, 1) the barycentric weights."""
    v0, v1, v2 = _corners(vertices, faces)
    if areas is None:
        areas = _base_face_areas(v0, v1, v2)[..., 0]
    choices = _face_choices(areas, u_face)
    pick = choices.long()[..., None].expand(-1, -1, 3)
    sv0, sv1, sv2 = (torch.gather(v, 1, pick) for v in (v0, v1, v2))
    w0, w1, w2 = _barycentric(u_bary, v_bary)
    points = w0 * sv0 + w1 * sv1 + w2 * sv2
    if face_features is None:
        return points, choices
    feats = torch.gather(face_features, 1, choices.long()[..., None, None]
                         .expand(-1, -1, *face_features.shape[2:]))
    point_features = (w0 * feats[:, :, 0] + w1 * feats[:, :, 1]
                      + w2 * feats[:, :, 2])
    return points, choices, point_features


def sample_points(vertices, faces, num_samples, areas=None, face_features=None,
                  generator=None):
    """Uniformly samples points on the surface of batched triangle meshes:
    faces picked with probability proportional to area, then uniform
    barycentric coordinates. The draws come from ``generator`` (a
    ``torch.Generator`` on the vertices' device; PyTorch's default one when
    None).

    Returns:
        (points, face_choices[, point_features]): points (batch_size,
        num_samples, 3), face_choices (batch_size, num_samples) int32, and
        the interpolated features (batch_size, num_samples, feat_dim) when
        ``face_features`` (batch_size, num_faces, 3, feat_dim) is given.
    """
    _check_triangles(faces, 'sample_points')
    u_face, u_bary, v_bary = _draws(vertices.shape[0], num_samples,
                                    vertices.dtype, vertices.device,
                                    generator)
    return _sample_from_uniforms(vertices, faces, u_face, u_bary, v_bary,
                                 areas=areas, face_features=face_features)


def _packed_sample_from_uniforms(vertices, first_idx_vertices, faces,
                                 num_faces_per_mesh, u_face, u_bary, v_bary,
                                 areas=None):
    """:func:`packed_sample_points` from its uniforms, as
    :func:`_sample_from_uniforms`."""
    num_faces_per_mesh = np.asarray(num_faces_per_mesh)
    batch_size, num_samples = u_face.shape
    merged = _merged_faces(faces, first_idx_vertices, num_faces_per_mesh)
    v0, v1, v2 = (vertices[merged[:, k]] for k in range(3))
    if areas is None:
        areas = _base_face_areas(v0, v1, v2)[..., 0]
    first_idx_faces = get_first_idx(num_faces_per_mesh)
    max_faces = int(num_faces_per_mesh.max())
    # per-mesh areas padded to (batch, max_faces); pads have zero area and
    # are never picked
    idx = first_idx_faces[:-1, None] + np.arange(max_faces)[None, :]
    valid = np.arange(max_faces)[None, :] < num_faces_per_mesh[:, None]
    idx = torch.as_tensor(np.where(valid, idx, 0), device=vertices.device)
    padded = torch.where(torch.as_tensor(valid, device=vertices.device),
                         areas[idx], torch.zeros((), dtype=areas.dtype,
                                                 device=areas.device))
    choices = _face_choices(padded, u_face)
    merged_choices = (choices + torch.as_tensor(
        first_idx_faces[:-1, None], device=vertices.device)).reshape(-1)
    sv0, sv1, sv2 = (v[merged_choices].reshape(batch_size, num_samples, 3)
                     for v in (v0, v1, v2))
    w0, w1, w2 = _barycentric(u_bary, v_bary)
    points = w0 * sv0 + w1 * sv1 + w2 * sv2
    return points, merged_choices.reshape(batch_size, num_samples)


def packed_sample_points(vertices, first_idx_vertices, faces,
                         num_faces_per_mesh, num_samples, areas=None,
                         generator=None):
    """Uniformly samples points on the surface of packed triangle meshes.

    Returns:
        (points (batch_size, num_samples, 3), face choices into the packed
        faces (batch_size, num_samples)).
    """
    _check_triangles(faces, 'packed_sample_points')
    batch_size = np.asarray(num_faces_per_mesh).shape[0]
    u_face, u_bary, v_bary = _draws(batch_size, num_samples, vertices.dtype,
                                    vertices.device, generator)
    return _packed_sample_from_uniforms(
        vertices, first_idx_vertices, faces, num_faces_per_mesh, u_face,
        u_bary, v_bary, areas=areas)


def face_normals(face_vertices, unit=False):
    """Normals of triangle faces: ``cross(v1 - v0, v2 - v0)``.

    Args:
        face_vertices: (batch_size, num_faces, 3, 3).
        unit: normalize to unit length (with the reference's 1e-10 guard).

    Returns:
        (batch_size, num_faces, 3).
    """
    if face_vertices.shape[-2] != 3:
        raise NotImplementedError(
            "face_normals is only implemented for triangle meshes")
    edges0 = face_vertices[:, :, 1] - face_vertices[:, :, 0]
    edges1 = face_vertices[:, :, 2] - face_vertices[:, :, 0]
    normals = torch.linalg.cross(edges0, edges1, dim=-1)
    if unit:
        length = torch.linalg.norm(normals, dim=2, keepdim=True)
        normals = normals / (length + 1e-10)
    return normals


def _norm(x):
    """``jnp.linalg.norm(x, axis=-1)``: sqrt of the sum of squares, whose
    gradient at 0 is NaN as in JAX."""
    return torch.sqrt((x * x).sum(dim=-1))


def average_edge_length(vertices, faces):
    """Average edge length of each face: (batch_size, num_faces)."""
    p1, p2, p3 = _corners(vertices, faces)
    return (_norm(p2 - p1) + _norm(p3 - p1) + _norm(p2 - p3)) / 3.
