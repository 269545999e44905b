"""SPC ray traversal: the CUDA kernel of ``csrc/spc_traverse.cu`` and its
plain PyTorch version.

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
compacted in (parent, rank) order into the next level's nuggets. A node's
coords come from the point hierarchy.

On the card each level is one launch (test, scan, look-back, write), and
the frontier's size stays on the card, so a trace reads the host once, at
its end: the levels' true totals. The buffers are sized from the shapes
(:func:`capacities`): level l holds at most min(8 C_{l-1}, R (3 * 2^l -
2), budget) nuggets, since a ray crosses at most 3 * 2^k - 2 cells of a
2^k grid (the JAX package's bound), and the last level ``cap`` rows where
the caller gives ``cap``. Where a total passed its level's capacity (the
budget binds), the trace runs again with each level sized exactly from
its total, read level by level, with the same kernel; ``traverse.resized``
counts those traces. :func:`_traverse_scheduled` is that host logic,
shared with :func:`_level_plain`, a plain model of the kernel that the
tests drive on the CPU (through :func:`_levels_plain`).
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

TILE = 256             # nuggets a tile of the CUDA kernel's look-back
# a level's budget on the card: max(BUDGET_PER_RAY * rays, BUDGET_MIN)
# nuggets
BUDGET_PER_RAY = 16
BUDGET_MIN = 1 << 16

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    'spc_traverse_level': [_P] * 8 + [_I] * 6 + [_P] * 2 + [_I] + [_P] * 3
                          + [_I] * 3 + [_P],
    'spc_traverse_levels': [_P] * 5 + [_I] * 3 + [_P, _P, _I, _I, _P, _I,
                                                  _P, _P, _I, _I, _P],
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


def _level_hits(octree, exsum, point_hierarchy, origin, direction, ridx,
                pidx, l, last, with_exit, root):
    """One level's hits of the nuggets (ridx, pidx) at node level ``l``, in
    (nugget, rank) order: (ray ids, child ids, depth columns at the last
    level). ``root``: the target level is 0, the root cell alone."""
    dtype = origin.dtype
    o = origin[ridx.long()]
    d = direction[ridx.long()]
    inv = 1.0 / d
    if root:
        zero = torch.zeros((1, 3), dtype=dtype, device=o.device)
        entry = _ray_aabb(o, d, inv, _sgn(d), zero, 1.0)
        keep = entry > 0.
        cols = [entry]
        if with_exit:
            exit_ = _ray_aabb(o, d, inv, _sgn(-d), zero, 1.0)
            keep &= exit_ > 0.
            cols.append(exit_)
        return ridx[keep], torch.zeros_like(ridx[keep]), \
            [c[keep] for c in cols]
    o, d, inv = o[:, None], d[:, None], inv[:, None]      # (n, 1, 3)
    pidx = pidx.long()
    order = torch.tensor(VOXEL_ORDER, dtype=torch.int64, device=o.device)
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
    child = base[:, None] + popcount8(bits[:, None] & ((2 << octant) - 1))
    return (ridx[:, None].expand(keep.shape)[keep],
            child[keep].to(torch.int32), [c[keep] for c in cols])


def traverse_plain(octree, exsum, point_hierarchy, origin, direction, level,
                   with_exit=False, cap=None):
    """Plain version of :func:`traverse`: per level an (nuggets, 8)
    candidate test in rank order, then a mask select in (parent, rank)
    order."""
    R = origin.shape[0]
    ridx = torch.arange(R, dtype=torch.int32, device=origin.device)
    pidx = torch.zeros_like(ridx)
    level_counts, cols = [], []
    for l in range(max(level, 1)):
        ridx, pidx, cols = _level_hits(
            octree, exsum, point_hierarchy, origin, direction, ridx, pidx, l,
            level == 0 or l == level - 1, with_exit, level == 0)
        level_counts.append(int(ridx.shape[0]))
    return _finish(ridx, pidx, cols, cap) + (level_counts,)


def capacities(num_rays, level, cap=None):
    """The rows of each frontier of a trace on the card, from the shapes:
    [R, C_1, ..., C_L] (L = max(level, 1)), C_l = min(8 C_{l-1}, R (3 *
    2^l - 2), budget) (R at level 0's root test), the last ``cap`` where
    given; the budget is max(BUDGET_PER_RAY * R, BUDGET_MIN)."""
    R = int(num_rays)
    budget = max(BUDGET_PER_RAY * R, BUDGET_MIN)
    caps = [R]
    for l in range(1, max(level, 1) + 1):
        bound = R if level == 0 else R * (3 * 2 ** l - 2)
        caps.append(min(8 * caps[-1], bound, budget))
    if cap is not None:
        caps[-1] = int(cap)
    return caps


def _state_ints(cap_in):
    """int32 words of one level's look-back state: a ticket (two words) and
    a 64-bit status word a tile."""
    return 2 + 2 * -(-cap_in // TILE)


def _levels_plain(level_fn):
    """All levels of a trace, one ``level_fn`` call a level, over the
    buffers :func:`_traverse_scheduled` lays out (``spc_traverse_levels``
    of the CUDA source, written out)."""
    def run(caps, meta, head, front, out, depth, pad):
        nlev = len(caps) - 1
        meta.zero_()
        off = head
        for l in range(nlev):
            last = l == nlev - 1
            size = _state_ints(caps[l])
            level_fn(None if l == 0 else front[(l - 1) % 2],
                     None if l == 0 else meta[l:l + 1], caps[0], caps[l], l,
                     last, meta[l + 1:l + 2], meta[off:off + size],
                     out if last else front[l % 2], depth if last else None,
                     caps[l + 1], last and pad)
            off += size
    return run


def _traverse_scheduled(run_levels, level_fn, origin, level, with_exit,
                        cap):
    """The host side of the traversal on the card: buffers sized by
    :func:`capacities`, all levels by ``run_levels`` (one C call on the
    card), one read of the levels' totals at the end, and, where a total
    passed its capacity, the trace again with each level sized exactly by
    ``level_fn`` (``traverse.resized``). Returns :func:`traverse`'s
    tuple."""
    dev = origin.device
    nlev = max(level, 1)
    caps = capacities(origin.shape[0], level, cap)
    head = nlev + 1 + (nlev + 1) % 2     # totals, then 8-byte state words
    meta = torch.empty(head + sum(_state_ints(c) for c in caps[:nlev]),
                       dtype=torch.int32, device=dev)
    front = torch.empty((2, 2, max(caps[1:nlev], default=0)),
                        dtype=torch.int32, device=dev)
    out = torch.empty((2, caps[nlev]), dtype=torch.int32, device=dev)
    depth = torch.empty((caps[nlev], 2 if with_exit else 1),
                        dtype=torch.float32, device=dev)
    run_levels(caps, meta, head, front, out, depth, cap is not None)
    counts = meta[1:nlev + 1].tolist()          # the one host read
    over = [n > c for n, c in zip(counts, caps[1:])]
    if any(over[:-1]) or (cap is None and over[-1]):
        traverse.resized += 1
        return _traverse_exact(level_fn, origin, level, with_exit, cap)
    count = counts[-1]
    if cap is None:
        return out[0, :count], out[1, :count], depth[:count], count, counts
    return out[0], out[1], depth, count, counts


def _traverse_exact(level_fn, origin, level, with_exit, cap):
    """The trace with each level sized exactly: a level's total first (its
    kernel writing nothing), read on the host, then the level into
    buffers of that size."""
    dev = origin.device
    nlev = max(level, 1)
    ncols = 2 if with_exit else 1
    src, n, counts, depth = None, origin.shape[0], [], None
    for l in range(nlev):
        last = l == nlev - 1
        meta = torch.zeros(2 + _state_ints(n), dtype=torch.int32, device=dev)
        level_fn(src, None, n, n, l, last, meta[0:1], meta[2:], None, None,
                 0, False)
        total = int(meta[0])
        rows = cap if last and cap is not None else total
        dst = torch.empty((2, rows), dtype=torch.int32, device=dev)
        depth = torch.empty((rows, ncols), dtype=torch.float32, device=dev) \
            if last else None
        meta.zero_()
        level_fn(src, None, n, n, l, last, meta[0:1], meta[2:], dst, depth,
                 rows, last and cap is not None)
        counts.append(total)
        src, n = dst, total
    return src[0], src[1], depth, counts[-1], counts


def _level_plain(octree, exsum, point_hierarchy, origin, direction,
                 with_exit, root):
    """A plain model of ``spc_level_kernel`` for :func:`_traverse_scheduled`
    on CPU tensors: the same arguments, the same writes (at most
    ``cap_out`` hits, the true total, -1 / 0 past the count with
    ``pad``)."""
    def level_fn(src, n_dev, n_host, cap_in, l, last, total, state, dst,
                 depth, cap_out, pad):
        n = n_host if n_dev is None else min(int(n_dev[0]), cap_in)
        if src is None:
            ridx = torch.arange(n, dtype=torch.int32)
            pidx = torch.zeros_like(ridx)
        else:
            ridx, pidx = src[0, :n], src[1, :n]
        r, p, cols = _level_hits(octree, exsum, point_hierarchy, origin,
                                 direction, ridx, pidx, l, last, with_exit,
                                 root)
        total[0] = r.shape[0]
        k = min(r.shape[0], cap_out)
        if dst is None:
            return
        dst[0, :k], dst[1, :k] = r[:k], p[:k]
        if last:
            depth[:k] = torch.stack(cols, -1)[:k].to(depth.dtype)
        if pad:
            dst[:, k:] = -1
            depth[k:] = 0.
    return level_fn


def _lib():
    return _build.load('spc_traverse', _SIGNATURES)


def _cuda_trace(lib, octree, exsum, ph, o, d, with_exit, root, dev,
                stream):
    """(run_levels, level_fn) for :func:`_traverse_scheduled` on the card:
    ``spc_traverse_levels`` (every level in one call) and
    ``spc_traverse_level``."""
    consts = (octree.data_ptr(), exsum.data_ptr(), ph.data_ptr(),
              o.data_ptr(), d.data_ptr())

    def ptr(t):
        return None if t is None else t.data_ptr()

    def run_levels(caps, meta, head, front, out, depth, pad):
        nlev = len(caps) - 1
        _build.launch(lib, 'spc_traverse_levels', *consts, nlev,
                      int(with_exit), int(root),
                      (ctypes.c_int * len(caps))(*caps), meta.data_ptr(),
                      meta.numel(), head, front.data_ptr(), front.shape[-1],
                      out.data_ptr(), depth.data_ptr(), int(pad), dev,
                      stream)

    def level_fn(src, n_dev, n_host, cap_in, l, last, total, state, dst,
                 depth, cap_out, pad):
        _build.launch(lib, 'spc_traverse_level', *consts,
                      None if src is None else src[0].data_ptr(),
                      None if src is None else src[1].data_ptr(),
                      ptr(n_dev), n_host, cap_in, l, int(last),
                      int(with_exit), int(root), total.data_ptr(),
                      state.data_ptr(), state.numel(),
                      None if dst is None else dst[0].data_ptr(),
                      None if dst is None else dst[1].data_ptr(),
                      ptr(depth), cap_out, int(pad), dev, stream)
    return run_levels, level_fn


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
        indices hold -1 and the depths 0. With ``cap=None`` the card's
        outputs are views of buffers sized by :func:`capacities`.
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
    run_levels, level_fn = _cuda_trace(
        _lib(), octree.contiguous(), exsum.contiguous(),
        point_hierarchy.contiguous(), o, d, with_exit, level == 0, dev,
        stream)
    out = _traverse_scheduled(run_levels, level_fn, o, level, with_exit, cap)
    traverse.launches += 1
    return out


traverse.launches = 0
traverse.resized = 0
