"""OFF mesh importer.

Port of ``kaolin_tpu/io/off.py`` (reference ``kaolin/io/off.py:30-101``).
"""

from collections import namedtuple

import numpy as np
import torch

__all__ = ['import_mesh']

return_type = namedtuple('return_type', ['vertices', 'faces', 'face_colors'])


def _is_void(splitted):
    return len(splitted) == 0 or splitted[0].startswith('#')


def import_mesh(path, with_face_colors=False, device='cuda'):
    """Loads an .off file as a single mesh.

    Returns:
        namedtuple (vertices (V, 3) float32, faces (F, S) int64,
        face_colors (F, 3) int64 in [0, 255] or None), on ``device``.
    """
    vertices = []
    with open(path, 'r', encoding='utf-8') as f:
        lines = iter(f.readlines())
        num_vertices = num_faces = None
        for line in lines:
            data = line.split()
            if _is_void(data):
                continue
            if data[0].startswith('OFF'):
                if len(data[0][3:]) > 0:
                    num_vertices = int(data[0][3:])
                    num_faces = int(data[1])
                    break
                elif len(data) > 1:
                    num_vertices = int(data[1])
                    num_faces = int(data[2])
                    break
                continue
            num_vertices = int(data[0])
            num_faces = int(data[1])
            break
        for line in lines:
            data = line.split()
            if _is_void(data):
                continue
            vertices.append([float(d) for d in data[:3]])
            if len(vertices) == num_vertices:
                break
        faces = []
        face_colors = []
        for line in lines:
            data = line.split()
            if _is_void(data):
                continue
            face_size = int(data[0])
            faces.append([int(d) for d in data[1:face_size + 1]])
            if with_face_colors:
                face_colors.append(
                    [int(d) for d in data[face_size + 1:face_size + 4]])
            if len(faces) == num_faces:
                break
    vertices = torch.as_tensor(np.asarray(vertices, np.float32),
                               device=device)
    faces = torch.as_tensor(np.asarray(faces, np.int64), device=device)
    if with_face_colors:
        face_colors = torch.as_tensor(np.asarray(face_colors, np.int64),
                                      device=device)
    else:
        face_colors = None
    return return_type(vertices, faces, face_colors)
