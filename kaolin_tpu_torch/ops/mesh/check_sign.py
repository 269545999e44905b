"""Point-in-watertight-mesh test by the parity of +x ray crossings. Port
of ``kaolin_tpu/ops/mesh/check_sign.py``.

The JAX package runs it as an XLA scan over face chunks, with no Pallas
kernel; the port runs the same arithmetic in plain PyTorch over chunks of
faces and points, on the CPU and on the card alike. Each float operation
is written in the JAX package's order (sums over a size-3 axis as
(x + y) + z, cross products in ``jnp.cross``'s order), and the counts are
int32, so the booleans are the JAX package's.
"""

import torch

from ...kernels.p2m_distance import _cross

__all__ = ['check_sign']

# elements per (points, faces) intermediate
_BUDGET = 1 << 22
_FACE_CHUNK = 256


def _sum3(x):
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def _signed_volume(a, b, c, d):
    return _sum3(_cross(b - a, c - a) * (d - a))


def _signed_area(ax, ay, bx, by, cx, cy):
    """Direction-stable 2D signed area: the edge b-c is canonicalised so
    that the value does not depend on the winding."""
    flip = (cx > bx) | ((bx == cx) & (cy < by))
    pos = (cy - by) * (ax - bx) + (bx - cx) * (ay - by)
    neg = -((by - cy) * (ax - cx) + (cx - bx) * (ay - cy))
    return torch.where(flip, neg, pos)


def _is_point_above_line(vx, vy, lx, ly, rx, ry):
    return ((rx - lx) * (vy - ly) - (ry - ly) * (vx - lx)) > 0.


def _crossings_chunk(points, v1, v2, v3):
    """Crossing counts of the points (N, 1, 3) with a chunk of faces
    v1, v2, v3 (1, C, 3): (N,) int32. A ray of length 10 goes from each
    point along +x; a projection onto a vertex or an edge of a face's
    (y, z) silhouette counts only for the canonical face."""
    q1 = points
    q2 = torch.cat([points[..., :1] + 10., points[..., 1:] + 0.], dim=-1)

    y = torch.stack([v1[..., 1], v2[..., 1], v3[..., 1]], dim=-1)
    z = torch.stack([v1[..., 2], v2[..., 2], v3[..., 2]], dim=-1)
    in_bbox = ((q1[..., 1] >= y.amin(-1)) & (q1[..., 1] <= y.amax(-1))
               & (q1[..., 2] >= z.amin(-1)) & (q1[..., 2] <= z.amax(-1)))

    cond1 = _signed_volume(q1, v1, v2, v3) > 0.
    cond2 = _signed_volume(q2, v1, v2, v3) > 0.
    between = cond1 != cond2

    qx, qy = q1[..., 1], q1[..., 2]
    p1x, p1y = v1[..., 1], v1[..., 2]
    p2x, p2y = v2[..., 1], v2[..., 2]
    p3x, p3y = v3[..., 1], v3[..., 2]
    d1 = _signed_area(qx, qy, p1x, p1y, p2x, p2y)
    d2 = _signed_area(qx, qy, p2x, p2y, p3x, p3y)
    d3 = _signed_area(qx, qy, p3x, p3y, p1x, p1y)
    inside2d = (d1 * d2 >= 0) & (d3 * d1 >= 0) & (d2 * d3 >= 0)

    on_v1 = (qx == p1x) & (qy == p1y)
    on_v2 = (qx == p2x) & (qy == p2y)
    on_v3 = (qx == p3x) & (qy == p3y)
    on_vert = on_v1 | on_v2 | on_v3
    on_e1 = (~on_vert) & (d1 == 0.)
    on_e2 = (~on_vert) & (~on_e1) & (d2 == 0.)
    on_e3 = (~on_vert) & (~on_e1) & (~on_e2) & (d3 == 0.)

    def pick(c1, a1, c2, a2, a3):
        return torch.where(c1, a1, torch.where(c2, a2, a3))

    # the (v1', v2') pair of the vertex or edge case; 'other' for edges
    vax = pick(on_v1, p2x, on_v2, p1x, torch.where(
        on_v3, p1x, pick(on_e1, p1x, on_e2, p2x, p3x)))
    vay = pick(on_v1, p2y, on_v2, p1y, torch.where(
        on_v3, p1y, pick(on_e1, p1y, on_e2, p2y, p3y)))
    vbx = pick(on_v1, p3x, on_v2, p3x, torch.where(
        on_v3, p2x, pick(on_e1, p2x, on_e2, p3x, p1x)))
    vby = pick(on_v1, p3y, on_v2, p3y, torch.where(
        on_v3, p2y, pick(on_e1, p2y, on_e2, p3y, p1y)))
    otx = pick(on_e1, p3x, on_e2, p1x, p2x)
    oty = pick(on_e1, p3y, on_e2, p1y, p2y)

    swap = (vax > vbx) | ((vax == vbx) & (vay > vby))
    lx = torch.where(swap, vbx, vax)
    ly = torch.where(swap, vby, vay)
    rx = torch.where(swap, vax, vbx)
    ry = torch.where(swap, vay, vby)

    on_edge = on_e1 | on_e2 | on_e3
    edge_invalid = on_edge & _is_point_above_line(otx, oty, lx, ly, rx, ry)
    vert_valid = (_is_point_above_line(qx, qy, lx, ly, rx, ry)
                  & (lx < qx) & (rx >= qx))
    vert_invalid = on_vert & ~vert_valid

    valid = in_bbox & between & inside2d & ~edge_invalid & ~vert_invalid
    return valid.sum(dim=-1, dtype=torch.int32)


def _count_intersections(points, v1, v2, v3):
    """Crossing counts (N,) int32 of points (N, 3) with faces (F, 3)
    each, over chunks of faces and points."""
    N, F = points.shape[0], v1.shape[0]
    count = torch.zeros((N,), dtype=torch.int32, device=points.device)
    rows = max(1, _BUDGET // max(1, min(_FACE_CHUNK, F)))
    for p0 in range(0, N, rows):
        pts = points[p0:p0 + rows, None, :]
        for f0 in range(0, F, _FACE_CHUNK):
            sl = slice(f0, f0 + _FACE_CHUNK)
            count[p0:p0 + rows] += _crossings_chunk(pts, v1[None, sl],
                                                    v2[None, sl],
                                                    v3[None, sl])
    return count


def check_sign(verts, faces, points, hash_resolution=512):
    """True for points inside a watertight triangle mesh.

    ``hash_resolution`` is accepted for the JAX package's signature and not
    used.

    Args:
        verts: (batch_size, num_vertices, 3).
        faces: (num_faces, 3) integer tensor.
        points: (batch_size, num_points, 3).

    Returns:
        (batch_size, num_points) bool.
    """
    if verts.ndim != 3:
        raise ValueError(f"Expected verts to have 3 dimensions "
                         f"but got {verts.ndim} dimensions.")
    if faces.ndim != 2:
        raise ValueError(f"Expected faces to have 2 dimensions "
                         f"but got {faces.ndim} dimensions.")
    if points.ndim != 3:
        raise ValueError(f"Expected points to have 3 dimensions "
                         f"but got {points.ndim} dimensions.")
    if verts.shape[2] != 3 or faces.shape[1] != 3 or points.shape[2] != 3:
        raise ValueError("verts/faces/points must have 3 coordinates")

    # normalise by the largest extent of each mesh's box
    maxlen = (verts.amax(dim=1) - verts.amin(dim=1)).amax(dim=-1)
    verts = verts / maxlen[:, None, None]
    points = points / maxlen[:, None, None]
    faces = faces.long()
    out = []
    for v, p in zip(verts, points):
        count = _count_intersections(p, v[faces[:, 0]], v[faces[:, 1]],
                                     v[faces[:, 2]])
        out.append(count % 2 == 1)
    return torch.stack(out)
