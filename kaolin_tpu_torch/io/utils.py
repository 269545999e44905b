"""I/O helpers: heterogeneous-mesh handlers.

Port of ``kaolin_tpu/io/utils.py`` (reference ``kaolin/io/utils.py:22-75``).
The handlers run on the host: the importers hand them CPU tensors and
numpy index lists.
"""

import numpy as np

__all__ = [
    'NonHomogeneousMeshError',
    'heterogeneous_mesh_handler_skip',
    'heterogeneous_mesh_handler_empty',
    'heterogeneous_mesh_handler_naive_homogenize',
]


class NonHomogeneousMeshError(Exception):
    """Raised when a mesh with varying face sizes is imported without a
    heterogeneous-mesh handler."""

    def __init__(self, message):
        self.message = message
        super().__init__(message)


def heterogeneous_mesh_handler_skip(*args):
    """Returns None so the importer skips the mesh."""
    return None


def heterogeneous_mesh_handler_empty(vertices, face_vertex_counts, *features):
    """Returns an empty mesh (its vertices of ``vertices``' type and
    device)."""
    empty = [np.zeros((0, 3), np.int64) for _ in features]
    return (vertices.new_zeros((0, 3)), np.zeros((0,), np.int64), *empty)


def heterogeneous_mesh_handler_naive_homogenize(vertices,
                                                face_vertex_counts,
                                                *features):
    """Triangulates n-gons with a naive fan (0,1,2), (0,2,3), ...

    Reference: ``kaolin/io/utils.py:45``.

    Example:
        >>> import numpy as np, torch
        >>> verts = torch.zeros((5, 3))
        >>> counts = np.array([4])  # one quad
        >>> idx = np.array([0, 1, 2, 3])
        >>> _, new_counts, faces = \\
        ...     heterogeneous_mesh_handler_naive_homogenize(verts, counts, idx)
        >>> print(faces)
        [[0 1 2]
         [0 2 3]]
        >>> print(new_counts)
        [3 3]
    """
    def _homogenize(attr, counts):
        if attr is None:
            return None
        attr = list(attr)
        out = []
        idx = 0
        for c in counts:
            c = int(c)
            face = attr[idx:idx + c]
            out.extend([[face[0], face[i], face[i + 1]]
                        for i in range(1, c - 1)])
            idx += c
        return np.asarray(out, np.int64)

    new_features = [_homogenize(f, face_vertex_counts) for f in features]
    new_counts = np.full((len(new_features[0]),), 3, np.int64) \
        if new_features and new_features[0] is not None else \
        np.zeros((0,), np.int64)
    return (vertices, new_counts, *new_features)
