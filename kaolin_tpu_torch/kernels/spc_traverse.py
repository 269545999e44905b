"""SPC ray traversal: the CUDA kernels of ``csrc/spc_traverse.cu`` and
their plain PyTorch version.

Port of ``kaolin_tpu/kernels/spc_traverse.py``: :func:`traverse` replaces
both ``traverse_banded_cc`` and ``traverse_banded``, which meet one
contract: every (ray, leaf point) hit of the octree at the target level,
ray-major and near to far in ``VOXEL_ORDER``, with entry (and exit)
depths and the true count. The wrapper follows its inputs: on CUDA tensors
it runs the CUDA traversal (float32 rays) and counts each traversal in its
``launches`` attribute; on CPU tensors it runs :func:`traverse_plain`,
which takes float32 or float64.

Both walk the octree level by level as the reference CUDA does (and as
the JAX package's XLA path ``unbatched_raytrace_fixed`` does with fixed
buffers): per level, each (ray, node) nugget tests its node's existing
children in near-to-far rank with the slab test, and the hits are
compacted in (parent, rank) order into the next level's nuggets. Each
level's buffers are sized from its total, read once on the host, so
nothing is cut before the final ``cap``. A node's coords come from the
point hierarchy.
"""

import ctypes

import torch

from . import _build
from .rasterize import _is_cuda
from ..ops.spc.uint8 import popcount8

__all__ = ['traverse', 'traverse_plain', 'VOXEL_ORDER']

# Near-to-far octant order for origin-octant code c: octants sorted by
# (popcount(o ^ c), o) -- the reference's VOXEL_ORDER
# (raytrace_cuda.cu:48-57), the table of csrc/spc_traverse.cu.
VOXEL_ORDER = tuple(
    tuple(sorted(range(8), key=lambda o, c=c: (bin(o ^ c).count('1'), o)))
    for c in range(8))

SCAN_BLOCK = 1024    # the CUDA scan's entries per block

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    'spc_traverse_decide': [_P] * 6 + [_I] * 5 + [_P] * 4 + [_I, _P],
    'spc_traverse_emit': [_P] * 7 + [_I] * 5 + [_P] * 5 + [_I, _I, _P],
}


def _sgn(d):
    """``signbit(d) ? 1 : -1`` in ``d``'s dtype (spc_render_utils.cuh)."""
    return torch.where(torch.signbit(d), torch.ones_like(d),
                       -torch.ones_like(d))


def _ray_aabb(o, d, inv, s, vc, r):
    """The slab test (``spc_render_utils.cuh ray_aabb``, Majercik et al.
    2018) of the cells centred at ``vc`` with half-size ``r``: 0 = miss,
    > 0 = entry distance, < 0 = the origin inside. The XLA path's
    operations in its order; ``inside`` is ``max(|oc|) < r``, false on
    NaN as the max would propagate it."""
    oc = o - vc
    inside = (oc.abs() < r).all(dim=-1)
    rt = torch.full_like(oc[..., 0], r)
    winding = torch.where(inside, -rt, rt)
    d0 = (winding * s[..., 0] - oc[..., 0]) * inv[..., 0]
    d1 = (winding * s[..., 1] - oc[..., 1]) * inv[..., 1]
    d2 = (winding * s[..., 2] - oc[..., 2]) * inv[..., 2]
    ltxy = d[..., 1] * d0 + oc[..., 1]
    ltxz = d[..., 2] * d0 + oc[..., 2]
    ltyx = d[..., 0] * d1 + oc[..., 0]
    ltyz = d[..., 2] * d1 + oc[..., 2]
    ltzx = d[..., 0] * d2 + oc[..., 0]
    ltzy = d[..., 1] * d2 + oc[..., 1]
    test0 = (d0 >= 0.) & (ltxy.abs() <= r) & (ltxz.abs() <= r)
    test1 = (d1 >= 0.) & (ltyx.abs() <= r) & (ltyz.abs() <= r)
    test2 = (d2 >= 0.) & (ltzx.abs() <= r) & (ltzy.abs() <= r)
    dist = torch.where(test0, d0, torch.where(test1, d1, torch.where(
        test2, d2, torch.zeros_like(d0))))
    return torch.where(inside, winding, dist)


def _finish(ridx, pidx, cols, cap):
    """(ridx (cap,), pidx (cap,), depth (cap, len(cols)), count): the hits
    cut or padded to ``cap`` (-1 and 0 past the count); ``cap=None`` keeps
    them all."""
    count = ridx.shape[0]
    depth = torch.stack(cols, dim=-1)
    if cap is None or cap == count:
        return ridx, pidx, depth, count
    if cap < count:
        return ridx[:cap], pidx[:cap], depth[:cap], count
    pad = cap - count
    return (torch.cat([ridx, ridx.new_full((pad,), -1)]),
            torch.cat([pidx, pidx.new_full((pad,), -1)]),
            torch.cat([depth, depth.new_zeros((pad, depth.shape[1]))]),
            count)


def traverse_plain(octree, exsum, point_hierarchy, origin, direction, level,
                   with_exit=False, cap=None):
    """Plain version of :func:`traverse`: per level an (nuggets, 8)
    candidate test in rank order, then a mask select in (parent, rank)
    order."""
    dev, dtype = origin.device, origin.dtype
    R = origin.shape[0]
    ridx = torch.arange(R, dtype=torch.int32, device=dev)
    if level == 0:
        o, d = origin, direction
        inv = 1.0 / d
        zero = torch.zeros((1, 3), dtype=dtype, device=dev)
        entry = _ray_aabb(o, d, inv, _sgn(d), zero, 1.0)
        keep = entry > 0.
        cols = [entry]
        if with_exit:
            exit_ = _ray_aabb(o, d, inv, _sgn(-d), zero, 1.0)
            keep &= exit_ > 0.
            cols.append(exit_)
        ridx = ridx[keep]
        out = _finish(ridx, torch.zeros_like(ridx), [c[keep] for c in cols],
                      cap)
        return out + ([out[3]],)
    order = torch.tensor(VOXEL_ORDER, dtype=torch.int64, device=dev)
    pidx = torch.zeros(R, dtype=torch.int64, device=dev)
    level_counts = []
    for l in range(level):
        last = l == level - 1
        o = origin[ridx.long()][:, None]                    # (n, 1, 3)
        d = direction[ridx.long()][:, None]
        inv = 1.0 / d
        bits = octree[pidx].to(torch.int64)
        base = exsum[pidx].to(torch.int64)
        p = point_hierarchy[pidx].to(dtype)                # (n, 3)
        r = 1.0 / (1 << l)
        rc = r * 0.5
        vc = r * (2. * p + 1.) - 1.
        frac = (0.5 * o[:, 0] + 0.5) - r * (p + 0.5)
        code = ((frac[:, 0] > 0).long() * 4 + (frac[:, 1] > 0).long() * 2
                + (frac[:, 2] > 0).long())
        octant = order[code]                                # (n, 8)
        exists = ((bits[:, None] >> octant) & 1) > 0
        off = torch.stack([(octant >> 2) & 1, (octant >> 1) & 1, octant & 1],
                          dim=-1).to(dtype)                 # (n, 8, 3)
        vc_child = (vc[:, None, :] - rc) + r * off
        entry = _ray_aabb(o, d, inv, _sgn(d), vc_child, rc)  # (n, 8)
        cols = []
        if last:
            hit = entry > 0.
            cols.append(entry)
            if with_exit:
                exit_ = _ray_aabb(o, d, inv, _sgn(-d), vc_child, rc)
                hit &= exit_ > 0.
                cols.append(exit_)
        else:
            hit = entry != 0.                # an origin inside counts
        keep = exists & hit
        child = base[:, None] + popcount8(bits[:, None]
                                          & ((2 << octant) - 1))
        ridx = ridx[:, None].expand(keep.shape)[keep]
        pidx = child[keep]
        level_counts.append(int(ridx.shape[0]))
    out = _finish(ridx, pidx.to(torch.int32), [c[keep] for c in cols], cap)
    return out + (level_counts,)


def _lib():
    return _build.load('spc_traverse', _SIGNATURES)


def traverse(octree, exsum, point_hierarchy, origin, direction, level,
             with_exit=False, cap=None):
    """Every (ray, point) hit of the octree at ``level``.

    Args:
        octree: (num_bytes,) uint8.
        exsum: (num_bytes + 1,) int32 exclusive popcount prefix sum.
        point_hierarchy: (num_points, 3) int16 (all levels).
        origin, direction: (num_rays, 3) float.
        level (int): target level; 0 tests the root cell alone.
        with_exit (bool): also the exit depths.
        cap (int or None): rows of the outputs; None gives exactly the
            hits.

    Returns:
        (ray_index (cap,) int32, point_index (cap,) int32, depth (cap, 1
        or 2), count (int, the true number of hits), level_counts (list of
        ints, the hits at each level)); past ``min(count, cap)`` the
        indices hold -1 and the depths 0.
    """
    level = int(level)
    if not _is_cuda(origin):
        return traverse_plain(octree, exsum, point_hierarchy, origin,
                              direction, level, with_exit, cap)
    for t, dtype in ((octree, torch.uint8), (exsum, torch.int32),
                     (point_hierarchy, torch.int16)):
        if t.device != origin.device:
            raise ValueError(f'traverse: tensors on {origin.device} and '
                             f'{t.device}')
        if t.dtype != dtype:
            raise TypeError(f'traverse: the CUDA kernel takes {dtype}, '
                            f'got {t.dtype}')
    (o, d), _, dev, stream = _build.cuda_inputs('traverse',
                                                (origin, direction))
    octree, exsum = octree.contiguous(), exsum.contiguous()
    ph = point_hierarchy.contiguous()
    lib = _lib()
    R = o.shape[0]
    ncols = 2 if with_exit else 1
    ridx = torch.arange(R, dtype=torch.int32, device=o.device)
    pidx = torch.zeros(R, dtype=torch.int32, device=o.device)
    depth = None
    level_counts = []
    root = level == 0
    for l in range(max(level, 1)):
        last = root or l == level - 1
        n = ridx.shape[0]
        counts = torch.empty(n, dtype=torch.int32, device=o.device)
        hits = torch.empty(n, dtype=torch.int16, device=o.device)
        offsets = torch.empty(n + 1, dtype=torch.int32, device=o.device)
        sums = torch.empty(n // SCAN_BLOCK + 1, dtype=torch.int32,
                           device=o.device)
        _build.launch(lib, 'spc_traverse_decide', octree.data_ptr(),
                      ph.data_ptr(), o.data_ptr(), d.data_ptr(),
                      ridx.data_ptr(), pidx.data_ptr(), n, l, int(last),
                      int(with_exit), int(root), counts.data_ptr(),
                      hits.data_ptr(), offsets.data_ptr(), sums.data_ptr(),
                      dev, stream)
        total = int(offsets[n])               # one host read per level
        level_counts.append(total)
        rows = total if cap is None or not last else int(cap)
        out_r = torch.full((rows,), -1, dtype=torch.int32, device=o.device)
        out_p = torch.full((rows,), -1, dtype=torch.int32, device=o.device)
        depth = torch.zeros((rows, ncols) if last else (0, ncols),
                            dtype=torch.float32, device=o.device)
        _build.launch(lib, 'spc_traverse_emit', octree.data_ptr(),
                      exsum.data_ptr(), ph.data_ptr(), o.data_ptr(),
                      d.data_ptr(), ridx.data_ptr(), pidx.data_ptr(), n, l,
                      int(last), int(with_exit), int(root), hits.data_ptr(),
                      offsets.data_ptr(), out_r.data_ptr(), out_p.data_ptr(),
                      depth.data_ptr(), rows, dev, stream)
        ridx, pidx = out_r, out_p
    traverse.launches += 1
    return ridx, pidx, depth, level_counts[-1], level_counts


traverse.launches = 0
