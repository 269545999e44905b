"""Nearest-neighbour indices: the CUDA kernels of ``csrc/nn_distance.cu``,
the pruned scan's prepass, and their plain PyTorch version.

Port of ``kaolin_tpu/kernels/nn_distance.py``: ``nearest_idx`` replaces
``nearest_idx_pallas`` (brute force) and ``nearest_idx_pruned`` replaces
``nearest_idx_pruned`` (a scan over chunk ranges of Morton-sorted
references). Each wrapper follows its inputs: on CUDA tensors it launches
its kernel (float32 only) and counts the launch in its ``launches``
attribute; on CPU tensors it runs :func:`nearest_idx_plain`, which follows
the JAX package's XLA scan (``_nearest_idx`` of
``kaolin_tpu/metrics/pointcloud.py``) and takes float32 or float64. All
three give the same indices: the distance is ``(dx*dx + dy*dy) + dz*dz``
of ``d = p1 - p2``, with no fused multiply-add, and ties keep the lowest
index. The Pallas kernels' limit of 640k reference points does not apply.

The pruned prepass runs in PyTorch on the inputs' device, with no copy to
the host: Morton-sort both clouds on one shared grid, cut the queries into
tiles of ``T1`` and the references into chunks of ``T2``, bound each
(tile, chunk) pair's distances from below by the squared gap of their
boxes and each tile's winners from above by the distances to a probe of
``PROBE`` references (the window of sorted references around the tile's
middle Morton code, so spatially close to it), and give each tile the
contiguous chunk range that holds every chunk the bounds cannot rule out,
with a flag per chunk of the range: the kernel skips a chunk the bounds
rule out. The upper bound is formed in the kernel's own distance form, so
it bounds the kernel's winner exactly; the lower bound is formed in
float64 and then lowered by 2^-20 of itself and by 2^-120, more than
float32 rounding of the kernel's distances can take from it, so no chunk
that holds a winner or a tie is skipped.
"""

import ctypes

import torch

from . import _build
from .rasterize import _is_cuda

__all__ = ['nearest_idx', 'nearest_idx_pruned', 'nearest_idx_plain',
           'T1', 'T2', 'PROBE']

T1 = 128        # queries per tile (the kernel's block)
T2 = 512        # references per chunk (the kernel's shared-memory stage)
PROBE = 128     # references probed per tile for its upper bound
_PAD_ORIG = 1 << 29     # original index of a pad: loses every tie
# the plain version's chunk of references (the XLA scan's) and its budget
# of elements per (B, queries, references) intermediate
_PLAIN_CHUNK = 1024
_PLAIN_BUDGET = 1 << 24

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    'nearest_idx_forward': [_P] * 3 + [_I] * 4 + [_P],
    'nearest_idx_pruned_forward': [_P] * 8 + [_I] * 8 + [_P],
}


def _sq_dist(q, r):
    """(dx*dx + dy*dy) + dz*dz of d = q - r, written out term by term (a
    sum over a size-3 axis promises no order)."""
    dx = q[..., 0] - r[..., 0]
    dy = q[..., 1] - r[..., 1]
    dz = q[..., 2] - r[..., 2]
    return (dx * dx + dy * dy) + dz * dz


def nearest_idx_plain(p1, p2):
    """For each point of ``p1`` (B, N1, 3), the index of the closest point
    of ``p2`` (B, N2, 3): (B, N1) int32. Plain version of
    :func:`nearest_idx` and :func:`nearest_idx_pruned`: the XLA scan over
    chunks of ``p2`` (first minimum within a chunk, strict ``<`` across
    chunks, index 0 before any distance is taken), in query blocks that
    bound its memory."""
    B, N1, _ = p1.shape
    N2 = p2.shape[1]
    idx = torch.zeros((B, N1), dtype=torch.int32, device=p1.device)
    chunk = _PLAIN_CHUNK
    rows = max(1, _PLAIN_BUDGET // max(1, B * min(chunk, max(N2, 1))))
    for q0 in range(0, N1, rows):
        q = p1[:, q0:q0 + rows, None, :]
        best_d = torch.full(q.shape[:2], float('inf'), dtype=p1.dtype,
                            device=p1.device)
        best_i = torch.zeros(q.shape[:2], dtype=torch.int32, device=p1.device)
        for base in range(0, N2, chunk):
            d = _sq_dist(q, p2[:, None, base:base + chunk, :])
            imin = torch.argmin(d, dim=-1, keepdim=True)
            dmin = torch.gather(d, -1, imin)[..., 0]
            take = dmin < best_d
            best_d = torch.where(take, dmin, best_d)
            best_i = torch.where(take, imin[..., 0].to(torch.int32) + base,
                                 best_i)
        idx[:, q0:q0 + rows] = best_i
    return idx


def _lib():
    return _build.load('nn_distance', _SIGNATURES)


def _check(fn, p1, p2):
    if p2.device != p1.device:
        raise ValueError(f'{fn}: p1 on {p1.device}, p2 on {p2.device}')
    if p1.ndim != 3 or p2.ndim != 3 or p1.shape[-1] != 3 \
            or p2.shape[-1] != 3 or p1.shape[0] != p2.shape[0]:
        raise ValueError(f'{fn}: expected p1 (B, N1, 3) and p2 (B, N2, 3), '
                         f'got {tuple(p1.shape)} and {tuple(p2.shape)}')


def nearest_idx(p1, p2):
    """For each point of ``p1`` (B, N1, 3), the index of the closest point
    of ``p2`` (B, N2, 3), by brute force: (B, N1) int32."""
    _check('nearest_idx', p1, p2)
    if not _is_cuda(p1):
        return nearest_idx_plain(p1, p2)
    (a, b), _, dev, stream = _build.cuda_inputs('nearest_idx', (p1, p2))
    B, N1, _ = a.shape
    idx = torch.empty((B, N1), dtype=torch.int32, device=a.device)
    _build.launch(_lib(), 'nearest_idx_forward', a.data_ptr(), b.data_ptr(),
                  idx.data_ptr(), B, N1, b.shape[1], dev, stream)
    nearest_idx.launches += 1
    return idx


def _spread3(v):
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def _morton(p, lo, span):
    """(B, N, 3) -> (B, N) int32 Morton codes on the 1024^3 grid of the
    box ``lo`` + [0, ``span``] (B, 1, 3)."""
    q = ((p - lo) / span * 1024.).clamp(0., 1023.).to(torch.int32)
    return ((_spread3(q[..., 0]) << 2) | (_spread3(q[..., 1]) << 1)
            | _spread3(q[..., 2]))


def _msort(p, pad_to, lo, span):
    """Morton-sorts a cloud and pads it to ``pad_to`` points by repeating
    the last sorted point. Returns (sorted (B, pad_to, 3), original index
    (B, pad_to) int32, pads ``_PAD_ORIG``, sorted codes (B, pad_to)). The
    sort is stable; the scan's result does not depend on the order within
    equal codes."""
    B, N, _ = p.shape
    codes, order = torch.sort(_morton(p, lo, span), dim=1, stable=True)
    ps = torch.gather(p, 1, order[..., None].expand(B, N, 3))
    orig = order.to(torch.int32)
    pad = pad_to - N
    if pad:
        ps = torch.cat([ps, ps[:, -1:].expand(B, pad, 3)], dim=1)
        orig = torch.cat([orig, torch.full((B, pad), _PAD_ORIG,
                                           dtype=torch.int32,
                                           device=p.device)], dim=1)
        codes = torch.cat([codes, codes[:, -1:].expand(B, pad)], dim=1)
    return ps.contiguous(), orig.contiguous(), codes.contiguous()


def _pruned_ranges(p1, p2):
    """The prepass of :func:`nearest_idx_pruned`, on the inputs' device.

    Returns (sorted queries (B, C1*T1, 3), their original indices, sorted
    references (B, C2*T2, 3), theirs, starts (B, C1) int32, nums (B, C1)
    int32, keep (B, C1, C2) uint8): tile ``i`` of the sorted queries scans
    the reference chunks ``c`` of ``starts[i] .. starts[i] + nums[i] - 1``
    with ``keep[i, c]`` set."""
    B, N1, _ = p1.shape
    N2 = p2.shape[1]
    C1, C2 = -(-N1 // T1), -(-N2 // T2)
    # one grid for both clouds, so that their codes compare
    lo = torch.minimum(p1.amin(dim=1, keepdim=True),
                       p2.amin(dim=1, keepdim=True))
    span = (torch.maximum(p1.amax(dim=1, keepdim=True),
                          p2.amax(dim=1, keepdim=True)) - lo).clamp(min=1e-12)
    p1s, orig1, codes1 = _msort(p1, C1 * T1, lo, span)
    p2s, orig2, codes2 = _msort(p2, C2 * T2, lo, span)
    q = p1s.reshape(B, C1, T1, 3)
    r = p2s.reshape(B, C2, T2, 3)
    qlo, qhi = q.amin(dim=2).double(), q.amax(dim=2).double()
    rlo, rhi = r.amin(dim=2).double(), r.amax(dim=2).double()
    # lower bound of every (tile, chunk) distance: the squared gap of the
    # boxes, in float64, then lowered past float32 rounding
    gap = torch.maximum(rlo[:, None] - qhi[:, :, None],
                        qlo[:, :, None] - rhi[:, None]).clamp(min=0.)
    lb = (gap * gap).sum(dim=-1) * (1. - 2. ** -20) - 2. ** -120
    # upper bound of each tile's winners: the largest over its queries of
    # the nearest of the PROBE sorted references around the tile's middle
    # code, in the kernel's distance form
    mid = torch.searchsorted(codes2, codes1[:, T1 // 2::T1].contiguous())
    pidx = ((mid - PROBE // 2).clamp(0, C2 * T2 - PROBE)[..., None]
            + torch.arange(PROBE, device=p1.device))              # (B,C1,P)
    ppts = torch.gather(p2s, 1, pidx.reshape(B, -1, 1).expand(-1, -1, 3))
    ppts = ppts.reshape(B, C1, 1, PROBE, 3)
    ub = _sq_dist(q[:, :, :, None, :], ppts).amin(dim=-1).amax(dim=-1)
    keep = (lb <= ub.double()[..., None]).to(torch.uint8)         # (B,C1,C2)
    first = torch.argmax(keep, dim=-1)
    last = C2 - 1 - torch.argmax(keep.flip(-1), dim=-1)
    return (p1s, orig1, p2s, orig2, first.to(torch.int32).contiguous(),
            (last - first + 1).to(torch.int32).contiguous(),
            keep.contiguous())


def nearest_idx_pruned(p1, p2):
    """:func:`nearest_idx` by a pruned scan: the same (B, N1) int32
    indices, ties included, with each tile of Morton-sorted queries
    scanning only the chunks of Morton-sorted references that the prepass
    leaves it."""
    _check('nearest_idx_pruned', p1, p2)
    if not _is_cuda(p1):
        return nearest_idx_plain(p1, p2)
    (p1, p2), _, dev, stream = _build.cuda_inputs('nearest_idx_pruned',
                                                  (p1, p2))
    B, N1, _ = p1.shape
    N2 = p2.shape[1]
    if N1 == 0 or N2 == 0:
        return torch.zeros((B, N1), dtype=torch.int32, device=p1.device)
    p1s, orig1, p2s, orig2, starts, nums, keep = _pruned_ranges(p1, p2)
    out = torch.empty((B, N1), dtype=torch.int32, device=p1.device)
    _build.launch(_lib(), 'nearest_idx_pruned_forward', p1s.data_ptr(),
                  orig1.data_ptr(), p2s.data_ptr(), orig2.data_ptr(),
                  starts.data_ptr(), nums.data_ptr(), keep.data_ptr(),
                  out.data_ptr(), B, N1, N2, starts.shape[1],
                  p2s.shape[1] // T2, T1, T2, dev, stream)
    nearest_idx_pruned.launches += 1
    return out


nearest_idx.launches = 0
nearest_idx_pruned.launches = 0
