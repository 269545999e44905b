"""ctypes bindings for the native host-preprocessing library. Port of
``kaolin_tpu/native.py``.

``csrc/core.cpp`` is built with ``g++`` at first use by
:mod:`kaolin_tpu_torch.kernels._build` into ``kaolin_tpu_torch/_build/``,
under a name hashed from the source, through a file of the building
process's own name that is renamed into place: processes that build at
once each load a whole library. If the build fails, the call raises with
the compiler's log; nothing falls back to Python. The numpy versions of
these functions (``ops.spc.points._octree_bytes`` and ``_morton_np``,
``ops.conversions.mesh._voxelize_triangles_np``) are the plain versions
the tests hold the library against.
"""

import ctypes

import numpy as np

from .kernels import _build

__all__ = ['get_lib', 'obj_parse_fast', 'points_to_octree_fast',
           'points_to_morton_fast', 'morton_to_points_fast',
           'voxelize_triangles_fast']

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    'obj_count': [ctypes.c_char_p, ctypes.POINTER(_I64),
                  ctypes.POINTER(_I64)],
    'obj_parse': [ctypes.c_char_p, _P, _P, ctypes.POINTER(_I64)],
    'points_to_morton': [_P, _I64, _P],
    'morton_to_points': [_P, _I64, _P],
    'points_to_octree': [_P, _I64, ctypes.c_int, _P, _I64],
    'voxelize_triangles': [_P, _I64, _P, _I64, ctypes.c_int, _P, _I64],
}
_RESTYPES = {'points_to_morton': None, 'morton_to_points': None,
             'points_to_octree': _I64, 'voxelize_triangles': _I64}


def get_lib():
    """The loaded native library, built first if needed. Raises
    ``RuntimeError`` with the compiler's log if it cannot be built."""
    return _build.load('core', _SIGNATURES, _RESTYPES)


def _points(points):
    pts = np.ascontiguousarray(points, np.int16)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f'expected (N, 3) points, got shape {pts.shape}')
    return pts


def obj_parse_fast(path):
    """Parses the vertices and the triangulated faces of an OBJ natively.

    Returns:
        (vertices (V, 3) float32, faces (T, 3) int64, homogeneous_size),
        or None if the file cannot be read.
    """
    lib = get_lib()
    nv = _I64()
    nt = _I64()
    if lib.obj_count(str(path).encode(), ctypes.byref(nv), ctypes.byref(nt)):
        return None
    vertices = np.empty((nv.value, 3), np.float32)
    faces = np.empty((nt.value, 3), np.int64)
    homo = _I64()
    if lib.obj_parse(str(path).encode(), vertices.ctypes.data,
                     faces.ctypes.data, ctypes.byref(homo)):
        return None
    return vertices, faces, int(homo.value)


def points_to_morton_fast(points):
    """(N, 3) int16 points to (N,) int64 Morton codes."""
    pts = _points(points)
    out = np.empty(pts.shape[0], np.int64)
    get_lib().points_to_morton(pts.ctypes.data, pts.shape[0], out.ctypes.data)
    return out


def morton_to_points_fast(morton):
    """(N,) Morton codes to (N, 3) int16 points."""
    m = np.ascontiguousarray(morton, np.int64).reshape(-1)
    out = np.empty((m.shape[0], 3), np.int16)
    get_lib().morton_to_points(m.ctypes.data, m.shape[0], out.ctypes.data)
    return out


def voxelize_triangles_fast(vertices, faces, level):
    """Conservative triangle voxelization.

    Args:
        vertices: (V, 3) float grid-space coords (in [0, 2^level]).
        faces: (T, 3) int.
        level: octree depth (grid res = 2^level).

    Returns:
        (N, 3) int16 unique voxel coords in Morton order.
    """
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int64)
    if f.size and (f.min() < 0 or f.max() >= v.shape[0]):
        raise ValueError('face indices out of range of the vertices')
    lib = get_lib()
    cap = max(1024, 64 * f.shape[0])
    while True:
        out = np.empty((cap, 3), np.int16)
        n = lib.voxelize_triangles(v.ctypes.data, v.shape[0],
                                   f.ctypes.data, f.shape[0], int(level),
                                   out.ctypes.data, cap)
        if n >= 0:
            return out[:n].copy()
        cap *= 4


def points_to_octree_fast(points, level):
    """The octree byte stream (levels 0..level-1, breadth first) of (N, 3)
    int16 points, as uint8 numpy."""
    pts = _points(points)
    lib = get_lib()
    cap = max(64, 2 * pts.shape[0] * max(level, 1))
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.points_to_octree(pts.ctypes.data, pts.shape[0], int(level),
                                 out.ctypes.data, cap)
        if n >= 0:
            return out[:n].copy()
        cap *= 4
