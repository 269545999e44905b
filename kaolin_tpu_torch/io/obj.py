"""Wavefront OBJ importer (with MTL material support).

Port of ``kaolin_tpu/io/obj.py`` (reference ``kaolin/io/obj.py:62-277``).
Returns tensors on ``device``; semantics (1-based index handling,
material ordering, error handlers) match the reference. Plain geometry
goes through the host library's parser (:func:`kaolin_tpu_torch.native.
obj_parse_fast`). PIL is imported only where a texture image is read.
"""

import os
import warnings
from collections import namedtuple

import numpy as np
import torch

from . import utils
from .materials import (MaterialLoadError, MaterialFileError,
                        MaterialNotFoundError)

__all__ = [
    'flatten_feature',
    'ignore_error_handler',
    'skip_error_handler',
    'default_error_handler',
    'import_mesh',
    'load_mtl',
]

return_type = namedtuple('return_type',
                         ['vertices', 'faces', 'uvs', 'face_uvs_idx',
                          'materials', 'materials_order', 'vertex_normals',
                          'face_normals'])


def ignore_error_handler(error, **kwargs):
    """Ignores all errors."""
    pass


def skip_error_handler(error, **kwargs):
    """Logs errors as warnings."""
    warnings.warn(error.args[0], UserWarning)


def default_error_handler(error, **kwargs):
    """Raises all errors."""
    raise error


def flatten_feature(feature):
    """Flattens a nested list of features (reference
    ``kaolin/io/obj.py:52``; used by heterogeneous-mesh handlers)."""
    if feature is None or len(feature) == 0:
        return None
    return [item for sublist in feature for item in sublist]


def _corner_fields(corner):
    """Splits one face-corner token ``v[/vt[/vn]]`` into its three
    index fields ('' where absent)."""
    v, _, rest = corner.partition('/')
    vt, _, vn = rest.partition('/')
    return v, vt, vn


def _floats(rows, width):
    return np.asarray([[float(el) for el in r] for r in rows],
                      np.float32).reshape(-1, width)


def _indices(rows):
    """1-based index rows -> (N, S) int64, 0-based; (0, 3) if none."""
    return (np.asarray(rows, np.int64) - 1 if len(rows)
            else np.zeros((0, 3), np.int64))


def import_mesh(path, with_materials=False, with_normals=False,
                error_handler=None, heterogeneous_mesh_handler=None,
                device='cuda'):
    r"""Loads an .obj file as a single mesh.

    Args:
        path (str): path to the obj file.
        with_materials (bool): also load MTL materials and UVs.
        with_normals (bool): also load vertex normals.
        error_handler: callable handling material errors
            (default: raise).
        heterogeneous_mesh_handler: callable handling non-homogeneous
            meshes (default: raise NonHomogeneousMeshError); it gets CPU
            vertices and numpy index lists.
        device: where the tensors (and the materials' values) land.

    Returns:
        namedtuple (vertices, faces, uvs, face_uvs_idx, materials,
        materials_order, vertex_normals, face_normals).
    """
    if error_handler is None:
        error_handler = default_error_handler

    def _t(a):
        return torch.as_tensor(a, device=device)

    if not with_materials and not with_normals:
        # the host library's parser (csrc/core.cpp) for plain geometry
        from ..native import obj_parse_fast
        fast = obj_parse_fast(path)
        if fast is not None and fast[2] == 3:
            v, f, _ = fast
            return return_type(_t(v), _t(f), None, None, None, None, None,
                               None)
    # Phase 1: bucket raw record payloads by tag (no per-line conversion).
    vertices, uvs, vertex_normals = [], [], []
    corner_rows = []      # one entry per 'f' record: its corner tokens
    mtl_events = []       # (#faces seen so far, material name) per 'usemtl'
    mtl_libs = []
    with open(path, 'r', encoding='utf-8') as stream:
        for raw in stream:
            tokens = raw.split()
            if not tokens:
                continue
            tag = tokens[0]
            if tag == 'f':
                corner_rows.append(tokens[1:])
            elif tag == 'v':
                vertices.append(tokens[1:4])
            elif with_materials and tag == 'vt':
                uvs.append(tokens[1:3])
            elif with_normals and tag == 'vn':
                vertex_normals.append(tokens[1:])
            elif with_materials and tag == 'usemtl':
                mtl_events.append((len(corner_rows), tokens[1]))
            elif with_materials and tag == 'mtllib':
                mtl_libs.append(tokens[1])

    # Phase 2: the face corner tokens as index columns. A corner is 'v',
    # 'v/vt', 'v//vn' or 'v/vt/vn'; whether a face has the uv / normal
    # column is decided from its second corner (the reference's rule,
    # kaolin/io/obj.py:129-160).
    faces, face_uvs_idx, face_normals = [], [], []
    for corners in corner_rows:
        v_col, uv_col, n_col = zip(*(_corner_fields(c) for c in corners))
        faces.append([int(s) for s in v_col])
        probe = corners[1] if len(corners) > 1 else corners[0]
        if with_materials:
            if _corner_fields(probe)[1]:
                face_uvs_idx.append([int(s) for s in uv_col])
            else:
                face_uvs_idx.append([0] * len(corners))
        if with_normals:
            if probe.count('/') >= 2:
                face_normals.append([int(s) for s in n_col])
            else:
                face_normals.append([0] * len(corners))

    # Resolve material names: first-seen order defines the index space.
    materials_dict = {}
    for libname in mtl_libs:
        mtl_path = os.path.join(os.path.dirname(path), libname)
        materials_dict.update(load_mtl(mtl_path, error_handler,
                                       device=device))
    materials_idx = {}
    materials_order = []
    for face_pos, name in mtl_events:
        slot = materials_idx.setdefault(name, len(materials_idx))
        materials_order.append([slot, face_pos])

    materials = [{} for _ in materials_idx]
    for material_name, idx in materials_idx.items():
        if material_name not in materials_dict:
            error_handler(
                MaterialNotFoundError(f"'{material_name}' not found."),
                material_name=material_name, idx=idx, materials=materials,
                materials_order=materials_order)
        else:
            materials[idx] = materials_dict[material_name]

    vertices_np = _floats(vertices, 3)
    face_vertex_counts = np.asarray([len(f) for f in faces], np.int64)
    if len(faces) and not np.all(face_vertex_counts
                                 == face_vertex_counts[0]):
        if heterogeneous_mesh_handler is None:
            raise utils.NonHomogeneousMeshError(
                f'Mesh is non-homogeneous and cannot be imported from '
                f'{path}. User can set heterogeneous_mesh_handler. See '
                f'kaolin_tpu_torch.io.utils for the available options')
        all_features = [flatten_feature(f)
                        for f in (faces, face_uvs_idx, face_normals)]
        mesh = heterogeneous_mesh_handler(torch.from_numpy(vertices_np),
                                          face_vertex_counts,
                                          *all_features)
        if mesh is None:
            return None
        vertices_out, face_vertex_counts, faces, face_uvs_idx, \
            face_normals = mesh
        vertices_np = np.asarray(vertices_out.cpu() if torch.is_tensor(
            vertices_out) else vertices_out)

    uvs_out = face_uvs_idx_out = materials_order_out = None
    vertex_normals_out = face_normals_out = None
    if with_materials:
        uvs_out = _t(_floats(uvs, 2))
        face_uvs_idx_out = _t(_indices(face_uvs_idx))
        materials_order_out = _t(np.asarray(materials_order,
                                            np.int64).reshape(-1, 2))
    else:
        materials = None
    if with_normals:
        vertex_normals_out = _t(_floats(vertex_normals, 3))
        face_normals_out = _t(_indices(face_normals))
    return return_type(_t(vertices_np), _t(_indices(faces)), uvs_out,
                       face_uvs_idx_out, materials, materials_order_out,
                       vertex_normals_out, face_normals_out)


def _mtl_texture(root_dir, args, device):
    """Converter for ``map_K*`` records: texture image -> (H, W, 3) uint8."""
    from PIL import Image
    image = Image.open(os.path.join(root_dir, args[0]))
    return torch.as_tensor(np.array(image.convert('RGB')), device=device)


def _mtl_color(root_dir, args, device):
    """Converter for ``K*`` records: float triple."""
    return torch.as_tensor(np.array(args, np.float32), device=device)


# tag -> converter; every recognized record becomes one material property.
_MTL_RECORD_CONVERTERS = {
    'map_Kd': _mtl_texture, 'map_Ka': _mtl_texture, 'map_Ks': _mtl_texture,
    'Kd': _mtl_color, 'Ka': _mtl_color, 'Ks': _mtl_color,
}


def load_mtl(mtl_path, error_handler, device='cuda'):
    """Loads an .mtl material library as ``{name: {tag: tensor}}``.

    Two phases, as :func:`import_mesh`: first the recognized records are
    bucketed under their ``newmtl`` section, then each tag's converter runs
    (``_MTL_RECORD_CONVERTERS``), so one bad record costs one
    ``error_handler`` call and never corrupts the bucketing.

    Behavior of reference ``kaolin/io/obj.py:219``: an unreadable file
    gives MaterialFileError, a failed record MaterialLoadError; textures
    are decoded to RGB.
    """
    root_dir = os.path.dirname(mtl_path)
    sections = {}            # name -> [(tag, args), ...] in file order
    try:
        with open(mtl_path, 'r', encoding='utf-8') as stream:
            records = [line.split() for line in stream]
    except (OSError, UnicodeDecodeError) as exc:
        error_handler(MaterialFileError(
            f"Failed to load material at path '{mtl_path}':\n{exc}"),
            mtl_path=mtl_path, mtl_data=sections)
        return sections
    bucket = None
    for rec in records:
        if not rec:
            continue
        if rec[0] == 'newmtl':
            bucket = sections.setdefault(rec[1], [])
        elif rec[0] in _MTL_RECORD_CONVERTERS and bucket is not None:
            bucket.append((rec[0], rec[1:]))

    materials = {}
    for name, props in sections.items():
        materials[name] = {}
        for tag, args in props:
            try:
                materials[name][tag] = \
                    _MTL_RECORD_CONVERTERS[tag](root_dir, args, device)
            except Exception as exc:
                error_handler(MaterialLoadError(
                    f"Failed to load material at path '{mtl_path}':\n{exc}"),
                    data=[tag] + list(args), mtl_data=materials)
    return materials
