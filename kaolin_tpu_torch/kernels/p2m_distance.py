"""Point-to-mesh closest face and distance type: the CUDA kernels of
``csrc/p2m_distance.cu`` and their plain PyTorch version.

Port of ``kaolin_tpu/kernels/p2m_distance.py``: ``p2m_select`` replaces
``p2m_select_pallas``. The wrapper follows its inputs: on CUDA tensors it
launches the kernel (float32 only) and counts the launch in its
``launches`` attribute; on CPU tensors it runs :func:`p2m_select_plain`,
which repeats the JAX package's XLA scan (``_classify_and_distance`` and
``_select_faces`` of ``kaolin_tpu/metrics/trianglemesh.py``) operation for
operation and takes float32 or float64. The kernel repeats the plain
version in turn, so face indices and types agree exactly, ties included
(the Pallas kernel's reciprocal products agree with XLA only up to float
ties). Any number of faces is taken.

On the card one call launches three kernels: one forms each face's
constants once into a scratch record, one scans the faces (a register tile
of points per thread, the faces split across blocks and merged with 64-bit
``atomicMin`` keys, pairs skipped whose plane lies farther than the running
best, the rest evaluated in their own lanes where a whole warp needs them,
else 32 at a time from a queue per warp), and one writes the winners and
their types. The source derives why the skips
change nothing.
"""

import ctypes

import torch

from . import _build
from .rasterize import _is_cuda

__all__ = ['p2m_select', 'p2m_select_plain', 'classify_and_distance']

# elements per (B, points, faces) intermediate of the plain version
_PLAIN_BUDGET = 1 << 22
_FACE_CHUNK = 256

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {'p2m_select_forward': [_P] * 6 + [_I] * 3 + [_P, _I, _P]}


def _dot(a, b):
    """``jnp.sum(a * b, axis=-1)`` over a size-3 axis, in the order
    (x + y) + z."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def _cross(a, b):
    """``jnp.cross(a, b)``, in its order of operations."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _unit_normal(normals):
    """``normals / jnp.linalg.norm(normals, axis=-1, keepdims=True)``."""
    return normals / torch.sqrt(_dot(normals, normals))[..., None]


def classify_and_distance(points, v1, v2, v3):
    """Squared distance and summed type code of each (point, face) pair:
    ``_classify_and_distance`` of the JAX package. ``points`` (..., 3)
    broadcasts against v1, v2, v3 (..., 3). Codes: 0 face, 1-3 vertex, 4-6
    edge, sums where region flags overlap (e.g. 10)."""
    e21 = v2 - v1
    e32 = v3 - v2
    e13 = v1 - v3
    normals = -_cross(e21, e13)
    uab = _dot(points - v1, e21) / _dot(e21, e21)
    ubc = _dot(points - v2, e32) / _dot(e32, e32)
    uca = _dot(points - v3, e13) / _dot(e13, e13)

    def not_above(vertex, edge):
        return _dot(_cross(normals, edge), points - vertex) <= 0

    is1 = (uca > 1.) & (uab < 0.)
    is2 = (uab > 1.) & (ubc < 0.)
    is3 = (ubc > 1.) & (uca < 0.)
    is4 = (uab >= 0.) & (uab <= 1.) & not_above(v1, e21)
    is5 = (ubc >= 0.) & (ubc <= 1.) & not_above(v2, e32)
    is6 = (uca >= 0.) & (uca <= 1.) & not_above(v3, e13)
    types = (is1 * 1 + is2 * 2 + is3 * 3 + is4 * 4 + is5 * 5
             + is6 * 6).to(torch.int32)

    unit_n = _unit_normal(normals)
    plane_pt = points - unit_n * _dot(points - v1, unit_n)[..., None]
    closest = torch.where(is1[..., None], v1,
              torch.where(is2[..., None], v2,
              torch.where(is3[..., None], v3,
              torch.where(is4[..., None], v1 + e21 * uab[..., None],
              torch.where(is5[..., None], v2 + e32 * ubc[..., None],
              torch.where(is6[..., None], v3 + e13 * uca[..., None],
                          plane_pt))))))
    return _dot(closest - points, closest - points), types


def p2m_select_plain(points, face_vertices):
    """Plain version of :func:`p2m_select`: the XLA scan over chunks of
    faces (first minimum within a chunk, strict ``<`` across chunks, a NaN
    distance counted as inf, face 0 and type 0 before any is taken), in
    point blocks that bound its memory."""
    B, N, _ = points.shape
    F = face_vertices.shape[1]
    dev = points.device
    idx = torch.zeros((B, N), dtype=torch.int32, device=dev)
    types = torch.zeros((B, N), dtype=torch.int32, device=dev)
    rows = max(1, _PLAIN_BUDGET // max(1, B * min(_FACE_CHUNK, max(F, 1))))
    for p0 in range(0, N, rows):
        p = points[:, p0:p0 + rows, None, :]
        best_d = torch.full(p.shape[:2], float('inf'), dtype=points.dtype,
                            device=dev)
        best_i = torch.zeros(p.shape[:2], dtype=torch.int32, device=dev)
        best_t = torch.zeros(p.shape[:2], dtype=torch.int32, device=dev)
        for base in range(0, F, _FACE_CHUNK):
            fv = face_vertices[:, None, base:base + _FACE_CHUNK]
            d, t = classify_and_distance(p, fv[..., 0, :], fv[..., 1, :],
                                         fv[..., 2, :])
            d = torch.where(torch.isnan(d), float('inf'), d)
            imin = torch.argmin(d, dim=-1, keepdim=True)
            dmin = torch.gather(d, -1, imin)[..., 0]
            tmin = torch.gather(t, -1, imin)[..., 0]
            take = dmin < best_d
            best_d = torch.where(take, dmin, best_d)
            best_i = torch.where(take, imin[..., 0].to(torch.int32) + base,
                                 best_i)
            best_t = torch.where(take, tmin, best_t)
        idx[:, p0:p0 + rows] = best_i
        types[:, p0:p0 + rows] = best_t
    return idx, types


def _lib():
    return _build.load('p2m_distance', _SIGNATURES)


def p2m_select(points, face_vertices):
    """Winner face and distance type per point. ``points`` (B, N, 3),
    ``face_vertices`` (B, F, 3, 3). Returns (face_idx (B, N) int32,
    dist_type (B, N) int32)."""
    if face_vertices.device != points.device:
        raise ValueError(f'p2m_select: points on {points.device}, faces on '
                         f'{face_vertices.device}')
    if points.ndim != 3 or points.shape[-1] != 3 \
            or tuple(face_vertices.shape[2:]) != (3, 3) \
            or face_vertices.shape[0] != points.shape[0]:
        raise ValueError(f'p2m_select: expected points (B, N, 3) and '
                         f'face_vertices (B, F, 3, 3), got '
                         f'{tuple(points.shape)} and '
                         f'{tuple(face_vertices.shape)}')
    if not _is_cuda(points):
        return p2m_select_plain(points, face_vertices)
    idx, types = select_cuda(points, face_vertices)
    p2m_select.launches += 1
    return idx, types


p2m_select.launches = 0


def select_cuda(points, face_vertices, scored=None):
    """The CUDA kernels of :func:`p2m_select` on checked CUDA inputs, not
    counted in its launches. ``scored``, a zeroed (1,) int64 tensor on the
    card, gains the number of (point, face) pairs evaluated in full (the
    rest the plane cull skipped)."""
    (p, fv), _, dev, stream = _build.cuda_inputs('p2m_select',
                                                 (points, face_vertices))
    B, N, _ = p.shape
    F = fv.shape[1]
    rec = torch.empty((B, F, 36), dtype=torch.float32, device=p.device)
    keys = torch.empty((B, N), dtype=torch.int64, device=p.device)
    idx = torch.empty((B, N), dtype=torch.int32, device=p.device)
    types = torch.empty((B, N), dtype=torch.int32, device=p.device)
    _build.launch(_lib(), 'p2m_select_forward', p.data_ptr(), fv.data_ptr(),
                  rec.data_ptr(), keys.data_ptr(), idx.data_ptr(),
                  types.data_ptr(), B, N, F,
                  None if scored is None else scored.data_ptr(), dev, stream)
    return idx, types
