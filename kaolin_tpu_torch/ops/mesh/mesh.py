"""Mesh indexing ops. Port of ``kaolin_tpu/ops/mesh/mesh.py``."""

__all__ = ['index_vertices_by_faces']


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
