"""SPC octree ray tracing and the "pack" stream ops. Port of
``kaolin_tpu/render/spc/raytrace.py`` (reference
``kaolin/render/spc/raytrace.py:31-296``, CUDA
``kaolin/csrc/render/spc/raytrace_cuda.cu``).

The trace runs in :func:`kaolin_tpu_torch.kernels.spc_traverse.traverse`:
the CUDA traversal on CUDA tensors, its plain version on CPU tensors. Both
give the hits in the reference's order (ray-major, near to far in
``VOXEL_ORDER``), with the true count. The card sizes each level's
buffers from the shapes and reads the host once a trace (sizing the
levels exactly where a budget binds), so the JAX package's per-level
capacities (``cap_schedule``) and table ranges (``level_offsets``) are
accepted and not needed. The trace is not differentiable, as in JAX.

The pack ops (segmented scans and reductions over runs of equal ray ids)
are plain tensor operations, differentiable by autograd.
"""

import warnings

import numpy as np
import torch

from ...kernels import _build
from ...kernels.spc_traverse import VOXEL_ORDER, traverse
from ...ops.spc.uint8 import POPCOUNT8

__all__ = [
    'VOXEL_ORDER',
    'unbatched_raytrace',
    'unbatched_raytrace_fixed',
    'plan_raytrace',
    'level_offsets_from_octree',
    'mark_pack_boundaries',
    'mark_first_hit',
    'diff',
    'sum_reduce',
    'cumsum',
    'cumprod',
    'exponential_integration',
    'generate_primary_rays',
    'primary_rays_fn',
    'primary_rays_fn_cols',
    'generate_shadow_rays',
]

# the backend values of kaolin_tpu's traces
_TRAVERSALS = ('auto', 'xla', 'banded')


def level_offsets_from_octree(octree):
    """Per-level node offsets of an SPC octree byte array (host):
    ``offsets[l]`` is the row where level ``l`` starts in the byte and
    exsum tables, ``offsets[-1] == num_bytes``."""
    octree = octree.detach().cpu().numpy() if torch.is_tensor(octree) \
        else np.asarray(octree)
    counts = [1]
    off = 0
    while off + counts[-1] < octree.shape[0]:
        nxt = int(POPCOUNT8[octree[off:off + counts[-1]]].sum())
        off += counts[-1]
        counts.append(nxt)
    return tuple(np.concatenate([[0], np.cumsum(counts)]).tolist())


def _rays(origin, direction, ray_fn):
    if ray_fn is None:
        return origin, direction
    # by ray_fn's contract, the same rows as the arrays, made once
    return ray_fn(torch.arange(origin.shape[0], dtype=torch.int32,
                               device=origin.device))


def unbatched_raytrace_fixed(octree, point_hierarchy, exsum, origin,
                             direction, level, cap, with_exit=False,
                             cap_schedule=None, return_level_counts=False,
                             ray_fn=None, level_offsets=None, backend='auto',
                             banded_raw_rows=None):
    """SPC ray trace into buffers of ``cap`` rows.

    Args:
        octree: (num_bytes,) uint8.
        point_hierarchy: (num_points, 3) int16 (all levels).
        exsum: (num_bytes + 1,) int32.
        origin, direction: (num_rays, 3) float.
        level (int): target octree level.
        cap (int): rows of the outputs, at least ``num_rays``.
        with_exit: also compute exit depths.
        cap_schedule, level_offsets, banded_raw_rows: accepted for
            ``kaolin_tpu``'s signature; the traversal sizes each level's
            buffers itself, and no hit is lost before ``cap``.
        return_level_counts: also return the hits at each level.
        ray_fn: optional ``ray_fn(ridx) -> (origin rows, direction rows)``
            that reproduces the arrays bit for bit (e.g.
            :func:`primary_rays_fn`); called once for every ray.
        backend: ``kaolin_tpu``'s choice of traversal, 'auto', 'xla' or
            'banded'; checked, and otherwise unused: the inputs' device
            picks the route ('banded' forces nothing on the CPU).

    Returns:
        (ray_index (cap,) int32, point_index (cap,) int32, depth (cap, 1
        or 2), count () int32 -- the true number of hits, which may
        exceed ``cap``[, level_counts (level,) int32]); entries past
        ``min(count, cap)`` hold index -1 and depth 0.
    """
    _build.check_backend('unbatched_raytrace_fixed', backend, _TRAVERSALS)
    num_rays = origin.shape[0]
    assert num_rays <= cap, (num_rays, cap)
    o, d = _rays(origin, direction, ray_fn)
    ridx, pidx, depth, count, counts = traverse(
        octree, exsum, point_hierarchy, o, d, int(level), bool(with_exit),
        int(cap))
    count = torch.tensor(count, dtype=torch.int32, device=origin.device)
    out = (ridx, pidx, depth, count)
    if return_level_counts:
        counts = counts if level > 0 else []
        return out + (torch.tensor(counts, dtype=torch.int32,
                                   device=origin.device),)
    return out


def plan_raytrace(octree, point_hierarchy, exsum, origin, direction,
                  level, cap=None, margin=1.25, ray_fn=None,
                  level_offsets=None, return_counts=False):
    """Per-level buffer sizes of a trace: each level's hits times
    ``margin``, rounded up to 1024 (``kaolin_tpu``'s ``cap_schedule``).
    With ``return_counts`` also returns the raw counts."""
    num_rays = origin.shape[0]
    if cap is None:
        cap = 64 * num_rays
    *_, counts = unbatched_raytrace_fixed(
        octree, point_hierarchy, exsum, origin, direction, int(level), cap,
        return_level_counts=True, ray_fn=ray_fn, level_offsets=level_offsets)
    counts = counts.cpu().numpy()
    sched = tuple(int(-(-int(c * margin) // 1024) * 1024) for c in counts)
    if return_counts:
        return sched, tuple(int(c) for c in counts)
    return sched


def unbatched_raytrace(octree, point_hierarchy, pyramid, exsum, origin,
                       direction, level, return_depth=True, with_exit=False,
                       max_nuggets=None, backend='auto'):
    """Ray-traces an unbatched SPC, returning every hit.

    Behavior matches ``kaolin.render.spc.unbatched_raytrace``: hits
    sorted by ray, then near to far. ``max_nuggets`` is accepted for the
    reference's signature; the buffers always fit the hits. ``backend`` is
    ``kaolin_tpu``'s choice of traversal ('auto', 'xla' or 'banded'):
    checked, and otherwise unused, since the inputs' device picks the
    route.

    Returns:
        (ray_index (N,) int32, point_index (N,) int32[, depth (N, 1 or
        2)]).
    """
    _build.check_backend('unbatched_raytrace', backend, _TRAVERSALS)
    ridx, pidx, depth, _, _ = traverse(octree, exsum, point_hierarchy,
                                       origin, direction, int(level),
                                       bool(with_exit))
    if return_depth:
        return ridx, pidx, depth
    return ridx, pidx


def mark_pack_boundaries(pack_ids):
    """True at the first element of each pack (run of equal ids)."""
    first = torch.ones((1,), dtype=torch.bool, device=pack_ids.device)
    return torch.cat([first, pack_ids[1:] != pack_ids[:-1]])


def _seg_ids(boundaries):
    return torch.cumsum(boundaries.to(torch.int64), dim=0) - 1


def _is_last(boundaries):
    return torch.cat([boundaries[1:], torch.ones((1,), dtype=torch.bool,
                                                 device=boundaries.device)])


def _rows(mask, feats):
    """``mask`` (N,) shaped to broadcast against ``feats`` (N, ...)."""
    return mask.reshape((-1,) + (1,) * (feats.ndim - 1))


def diff(feats, boundaries):
    """Per-pack forward difference, 0 at each pack's last element."""
    nxt = torch.cat([feats[1:], torch.zeros_like(feats[:1])], dim=0)
    return torch.where(_rows(_is_last(boundaries), feats),
                       torch.zeros_like(feats), nxt - feats)


def _segment_sum(feats, seg, n):
    keep = seg < n
    out = torch.zeros((n,) + tuple(feats.shape[1:]), dtype=feats.dtype,
                      device=feats.device)
    return out.index_add(0, seg[keep], feats[keep])


def sum_reduce(feats, boundaries, num_packs=None):
    """Sums features within each pack: ``num_packs`` rows if given, else
    one row per element, zero past the pack count."""
    n = num_packs if num_packs is not None else feats.shape[0]
    return _segment_sum(feats, _seg_ids(boundaries), n)


def _segmented_scan(feats, boundaries, op, identity, exclusive, reverse):
    """Inclusive scan of ``op`` within each pack (a log-step scan that
    restarts at pack boundaries), then shifted for ``exclusive``."""
    seg = _seg_ids(boundaries)
    v, s = (feats.flip(0), seg.flip(0)) if reverse else (feats, seg)
    k = 1
    while k < v.shape[0]:
        same = _rows(s[k:] == s[:-k], v)
        v = torch.cat([v[:k], torch.where(same, op(v[:-k], v[k:]), v[k:])])
        k *= 2
    incl = v.flip(0) if reverse else v
    if not exclusive:
        return incl
    ident = torch.full_like(feats[:1], identity)
    if not reverse:
        shifted = torch.cat([ident, incl[:-1]], dim=0)
        return torch.where(_rows(boundaries, feats), identity, shifted)
    shifted = torch.cat([incl[1:], ident], dim=0)
    return torch.where(_rows(_is_last(boundaries), feats), identity, shifted)


def cumsum(feats, boundaries, exclusive=False, reverse=False):
    """Segmented cumulative sum (tf.math.cumsum options)."""
    return _segmented_scan(feats, boundaries, torch.add, 0., exclusive,
                           reverse)


def cumprod(feats, boundaries, exclusive=False, reverse=False):
    """Segmented cumulative product (tf.math.cumprod options)."""
    return _segmented_scan(feats, boundaries, torch.mul, 1., exclusive,
                           reverse)


def exponential_integration(feats, tau, boundaries, exclusive=True):
    """Beer-Lambert transmittance integration over packs.

    Returns:
        (integrated feats (num_elems, feat_dim), one row per pack in the
        first rows and zeros after; transmittance (num_elems, 1)).
    """
    alpha = 1.0 - torch.exp(-tau)
    transmittance = torch.exp(-1.0 * cumsum(tau, boundaries,
                                            exclusive=exclusive))
    transmittance = transmittance * alpha
    feats_out = _segment_sum(transmittance * feats, _seg_ids(boundaries),
                             feats.shape[0])
    return feats_out, transmittance


def mark_first_hit(ridx):
    """Deprecated alias of :func:`mark_pack_boundaries`."""
    warnings.warn('mark_first_hit is deprecated, '
                  'use mark_pack_boundaries instead', DeprecationWarning)
    return mark_pack_boundaries(ridx)


def _norm3(v):
    """sqrt((v0*v0 + v1*v1) + v2*v2) over the last axis."""
    sq = v * v
    return torch.sqrt((sq[..., 0] + sq[..., 1]) + sq[..., 2])


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _camera(eye, at, up, fov, dtype, device):
    """(eye, x, y, z, tan(fov / 2)) of a lookat camera."""
    eye, at, up = (torch.as_tensor(v, dtype=dtype, device=device)
                   for v in (eye, at, up))
    z = eye - at
    z = z / _norm3(z)
    x = _cross(up, z)
    x = x / _norm3(x)
    y = _cross(z, x)
    tan = torch.tan(torch.as_tensor(fov, dtype=dtype, device=device) / 2.)
    return eye, x, y, z, tan


def _pixel(ridx, height, width, dtype):
    """Pixel centres in [-1, 1] of ray ids (division by 0-dim tensors: on
    the card, division by a Python number multiplies by its reciprocal)."""
    w = torch.tensor(width, dtype=dtype, device=ridx.device)
    h = torch.tensor(height, dtype=dtype, device=ridx.device)
    px = ((ridx % width).to(dtype) + 0.5) / w * 2. - 1.
    py = ((ridx // width).to(dtype) + 0.5) / h * 2. - 1.
    return px, py


def primary_rays_fn(height, width, eye, at, up, fov, dtype=torch.float32,
                    device='cuda'):
    """Index-to-ray closure for pinhole lookat primary rays.

    Returns ``fn`` with ``fn(ridx (N,) int) -> (origin (N, 3), direction
    (N, 3))``, the rows :func:`generate_primary_rays` makes; pass it as
    ``ray_fn`` to :func:`unbatched_raytrace_fixed`.
    """
    eye, x, y, z, tan = _camera(eye, at, up, fov, dtype, device)

    def fn(ridx):
        px, py = _pixel(ridx, height, width, dtype)
        t1 = px[:, None] * x[None] * tan * (width / height)
        t2 = py[:, None] * y[None] * tan
        dirs = (t1 - t2) - z[None]
        dirs = dirs / _norm3(dirs)[:, None]
        return eye.expand(dirs.shape), dirs

    return fn


def primary_rays_fn_cols(height, width, eye, at, up, fov,
                         dtype=torch.float32, device='cuda'):
    """Componentwise variant of :func:`primary_rays_fn`: ``fn(ridx) ->
    (ox, oy, oz, dx, dy, dz)``, each of ``ridx``'s shape; the camera's
    vectors enter as host floats, the association order is
    :func:`primary_rays_fn`'s."""
    eye, x, y, z, tan = (v.cpu().numpy() for v in _camera(
        eye, at, up, fov, dtype, device))
    aspect = width / height

    def fn(ridx):
        px, py = _pixel(ridx, height, width, dtype)
        dcols = []
        for a in range(3):
            t1 = ((px * float(x[a])) * float(tan)) * aspect
            t2 = (py * float(y[a])) * float(tan)
            dcols.append(t1 - t2 - float(z[a]))
        nrm = torch.sqrt(dcols[0] * dcols[0] + dcols[1] * dcols[1]
                         + dcols[2] * dcols[2])
        d = [c / nrm for c in dcols]
        o = [torch.full(ridx.shape, float(eye[a]), dtype=dtype,
                        device=ridx.device) for a in range(3)]
        return o[0], o[1], o[2], d[0], d[1], d[2]

    return fn


def generate_primary_rays(height, width, eye, at, up, fov,
                          dtype=torch.float32, device='cuda'):
    """Pinhole primary rays from a lookat camera (the reference's
    deprecated ``generate_primary_rays_cuda``).

    Returns:
        (origin (H*W, 3), direction (H*W, 3)) on ``device``.
    """
    fn = primary_rays_fn(height, width, eye, at, up, fov, dtype, device)
    return fn(torch.arange(height * width, dtype=torch.int32, device=device))


def generate_shadow_rays(ray_o, ray_d, light, plane):
    """Shadow rays toward a light for rays hitting a ground plane (the
    reference's deprecated ``generate_shadow_rays_cuda``,
    ``raytrace_cuda.cu:799-897``).

    Args:
        ray_o, ray_d: (num_rays, 3) primary rays.
        light: (3,) light position.
        plane: (4,) plane coefficients (a, b, c, d).

    Returns:
        (src (N, 3) = light origin, dst (N, 3) = direction light->point,
        map (N,) int32 indices of the originating primary rays) for the N
        rays that hit the plane.
    """
    n = plane[:3]
    ao = ray_o * n
    ad = ray_d * n
    a = ((ao[:, 0] + ao[:, 1]) + ao[:, 2]) + plane[3]
    b = (ad[:, 0] + ad[:, 1]) + ad[:, 2]
    t = -a / b
    hit = (b.abs() > 1e-3) & (t > 0.)
    pts = ray_o + t[:, None] * ray_d
    idx = torch.nonzero(hit)[:, 0]
    dst = pts[idx] - light[None]
    dst = dst / _norm3(dst)[:, None]
    src = light.expand(dst.shape)
    return src, dst, idx.to(torch.int32)
