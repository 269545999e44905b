"""Nearest-neighbour indices: the CUDA kernels of ``csrc/nn_distance.cu``
and their plain PyTorch versions.

Port of ``kaolin_tpu/kernels/nn_distance.py``: ``nearest_idx`` replaces
``nearest_idx_pallas`` (brute force) and ``nearest_idx_pruned`` replaces
``nearest_idx_pruned`` (a scan of Morton-sorted references that skips
those no box test leaves). Each wrapper follows its inputs: on CUDA tensors
it launches its kernels (float32 only) and counts one launch per call in
its ``launches`` attribute; on CPU tensors it runs
:func:`nearest_idx_plain`, which follows the JAX package's XLA scan
(``_nearest_idx`` of ``kaolin_tpu/metrics/pointcloud.py``) and takes
float32 or float64. All three give the same indices: the distance is
``(dx*dx + dy*dy) + dz*dz`` of ``d = p1 - p2``, with no fused
multiply-add, ties keep the lowest index, the index is 0 when no distance
is taken, and no reference is taken from a chunk of ``CHUNK`` (1024)
original indices that holds a NaN coordinate (the XLA scan's chunk
minimum is then NaN, and it passes the chunk over). The Pallas kernels'
limit of 640k reference points does not apply.

The brute-force kernel gives a block ``QB`` queries and a slice of the
references; :func:`brute_plan` cuts the references into slices so that
the blocks fill the card, and a second kernel merges the slices' partial
results when there are several.

The pruned scan's prepass (:func:`prepass`) runs on the card with no copy
to the host and no wait for it: one kernel reduces both clouds' box and
writes each point's 32-bit key (its batch entry and cloud, then its
Morton code on that box), ``torch.sort`` sorts all keys at once, and one
kernel writes both sorted clouds as float4 records and each chunk of
``CH`` references' box. :func:`_prepass_plain` is its plain version, bit
for bit. The scan then gives each warp a tile of ``TQ`` sorted queries,
visits the chunks nearest first in Morton order, skips a chunk whose box
lies farther from every query of the warp than its best distance so far,
and stops once no chunk left has a sort key that a point that near could
have; ``csrc/nn_distance.cu`` derives why no winner or tie is skipped.
A reference of a chunk that holds a NaN coordinate gets NaN coordinates in
its record, so that the scan never takes it.
``TQ``, ``CH``, ``_EXT_BLOCKS``, ``_PAD_ORIG``, ``QB``, ``CHUNK`` and
``_MIN_SLICE`` are the kernel's own (``nearest_idx_layout``): loading the
library checks that they agree.
"""

import ctypes
import functools

import torch

from . import _build
from .rasterize import _is_cuda

__all__ = ['nearest_idx', 'nearest_idx_pruned', 'nearest_idx_plain',
           'prepass', 'brute_plan', 'TQ', 'CH', 'QB', 'CHUNK']

TQ = 64         # queries per warp tile of the pruned scan (R = 2 a lane)
CH = 32         # references per chunk of the pruned scan
_EXT_BLOCKS = 64    # blocks of the card's box reduction per batch entry
_PAD_ORIG = 0x7fffffff  # original index of a pad: loses every tie
QB = 384        # queries per block of the brute-force kernel
# the XLA scan's chunk of references: the plain version's, and the NaN
# rule's
CHUNK = 1024
_MIN_SLICE = 32     # fewest references in a brute-force slice
_MAX_SLICES = 64    # most slices (partials a query) of a brute-force call
# brute_plan's costs, in references scanned by a block: a block's own
# (loading its queries, its first chunk, its lookups and writes) and the
# merge's launch
_BLOCK_COST = 32
_MERGE_COST = 128
# the plain version's budget of elements per (B, queries, references)
# intermediate
_PLAIN_BUDGET = 1 << 24

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    'nearest_idx_forward': [_P] * 4 + [_I] * 6 + [_P],
    'nearest_idx_layout': [_P],
    'nearest_idx_keys': [_P] * 6 + [_I] * 4 + [_P],
    'nearest_idx_pack': [_P] * 8 + [_I] * 4 + [_P],
    'nearest_idx_pruned_forward': [_P] * 6 + [_I] * 3 + [_P, _I, _P],
}
_LAYOUT = (TQ, CH, _EXT_BLOCKS, _PAD_ORIG, QB, CHUNK, _MIN_SLICE)


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
    chunks, index 0 before any distance is taken; a chunk whose minimum is
    NaN is passed over), in query blocks that bound its memory."""
    B, N1, _ = p1.shape
    N2 = p2.shape[1]
    idx = torch.zeros((B, N1), dtype=torch.int32, device=p1.device)
    chunk = CHUNK
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


@functools.cache
def _lib():
    lib = _build.load('nn_distance', _SIGNATURES)
    layout = (ctypes.c_int * len(_LAYOUT))()
    _build.launch(lib, 'nearest_idx_layout', ctypes.addressof(layout))
    if tuple(layout) != _LAYOUT:
        raise RuntimeError(f'csrc/nn_distance.cu lays the kernels out as '
                           f'{tuple(layout)} (TQ, CH, EXT_BLOCKS, PAD_ORIG, '
                           f'QB, CHUNK, MIN_SLICE), this module as {_LAYOUT}')
    return lib


@functools.cache
def _sms(device):
    """The SM count of CUDA device ``device`` (an index)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _slice_len(n):
    """The least slice length of at least ``n`` references that the
    brute-force kernel takes: a power of two from ``_MIN_SLICE`` up to 512
    (a chunk is whole slices), else a multiple of ``CHUNK`` (a slice is
    whole chunks)."""
    if n > CHUNK // 2:
        return -(-n // CHUNK) * CHUNK
    return max(_MIN_SLICE, 1 << (n - 1).bit_length())


@functools.lru_cache(maxsize=256)
def brute_plan(B, N1, N2, sms):
    """(S, L): the brute-force kernel's S slices of L references each
    (S = ceil(N2 / L); one slice is L = N2 rounded up to ``CHUNK``) for B
    entries of N1 queries and N2 >= 1 references on ``sms`` SMs.

    The blocks are the ceil(N1 / QB) query tiles of each entry times the
    slices, and an SM takes its share of them in turn, so the call lasts
    about as long as the SM with the most blocks: the plan takes the S, up
    to ``_MAX_SLICES``, that makes ceil(blocks / sms) * (L +
    ``_BLOCK_COST``) least, counting at least two blocks an SM (one block
    of four warps leaves an SM half idle) and ``_MERGE_COST`` for the
    merge's launch when S > 1; ties go to fewer slices. When the tiles
    alone give every SM the same number of blocks, two or more, that is
    S = 1."""
    tiles = B * -(-N1 // QB)
    best = None
    for want in range(1, _MAX_SLICES + 1):
        L = _slice_len(-(-N2 // want))
        S = -(-N2 // L)
        cost = (max(2, -(-tiles * S // sms)) * (min(L, N2) + _BLOCK_COST)
                + (_MERGE_COST if S > 1 else 0))
        if best is None or cost < best[0]:
            best = (cost, S, L)
    _, S, L = best
    return (1, -(-N2 // CHUNK) * CHUNK) if S == 1 else (S, L)


def _check(fn, p1, p2):
    if p2.device != p1.device:
        raise ValueError(f'{fn}: p1 on {p1.device}, p2 on {p2.device}')
    if p1.ndim != 3 or p2.ndim != 3 or p1.shape[-1] != 3 \
            or p2.shape[-1] != 3 or p1.shape[0] != p2.shape[0]:
        raise ValueError(f'{fn}: expected p1 (B, N1, 3) and p2 (B, N2, 3), '
                         f'got {tuple(p1.shape)} and {tuple(p2.shape)}')


def nearest_idx(p1, p2):
    """For each point of ``p1`` (B, N1, 3), the index of the closest point
    of ``p2`` (B, N2, 3), by brute force: (B, N1) int32. On the card one
    kernel, and a second that merges the slices of :func:`brute_plan`
    when it cuts the references."""
    _check('nearest_idx', p1, p2)
    if not _is_cuda(p1):
        return nearest_idx_plain(p1, p2)
    (a, b), _, dev, stream = _build.cuda_inputs('nearest_idx', (p1, p2))
    B, N1, _ = a.shape
    N2 = b.shape[1]
    if B * N1 * N2 == 0:
        return torch.zeros((B, N1), dtype=torch.int32, device=a.device)
    S, L = brute_plan(B, N1, N2, _sms(dev))
    idx = torch.empty((B, N1), dtype=torch.int32, device=a.device)
    part = (torch.empty((B, N1, S, 2), dtype=torch.float32, device=a.device)
            if S > 1 else None)
    _build.launch(_lib(), 'nearest_idx_forward', a.data_ptr(), b.data_ptr(),
                  idx.data_ptr(), None if part is None else part.data_ptr(),
                  B, N1, N2, L, S, dev, stream)
    nearest_idx.launches += 1
    return idx


def _spread3(v):
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def _key_bits(B):
    """(segment bits, Morton bits per axis) of the 32-bit sort keys of
    ``B`` batch entries: 2B segments (entry, cloud), and as many Morton bits
    as fit below them, at most 10 an axis."""
    sb = max(1, (2 * B - 1).bit_length())
    return sb, min(10, (32 - sb) // 3)


def _nan_amin(x, dim):
    """``amin`` over ``dim`` that drops NaN as ``fminf`` does: NaN only
    where every element is."""
    nan = x.isnan()
    return torch.where(nan.all(dim=dim), float('nan'),
                       torch.where(nan, float('inf'), x).amin(dim=dim))


def _nan_amax(x, dim):
    """``amax`` over ``dim`` that drops NaN as ``fmaxf`` does."""
    return -_nan_amin(-x, dim)


def _frame(p1, p2):
    """(B, 1, 3) lo and span of the box around both clouds of each batch
    entry, on which the sort keys are formed (NaN coordinates left out, as
    the card's ``fminf`` and ``fmaxf`` leave them; inf and -inf where an
    axis has none but NaN)."""
    def lo_of(p):
        return torch.where(p.isnan(), float('inf'), p).amin(dim=1,
                                                            keepdim=True)

    def hi_of(p):
        return torch.where(p.isnan(), float('-inf'), p).amax(dim=1,
                                                             keepdim=True)
    lo = torch.minimum(lo_of(p1), lo_of(p2))
    return lo, (torch.maximum(hi_of(p1), hi_of(p2)) - lo).clamp(min=1e-12)


def _keys(p, lo, span, B, cloud):
    """int64 sort keys of points ``p`` (B, n, 3) of one cloud (0 queries,
    1 references) on the box (lo, span): the point's Morton code on a 2^m
    grid of the box below its segment (2 b + cloud), the top bit flipped
    so that signed order is unsigned order."""
    sb, m = _key_bits(B)
    v = (p - lo) / span * float(1 << m)
    # NaN to cell 0, as the card's fmaxf(v, 0) makes it
    q = torch.where(v.isnan(), 0., v).clamp(0., float((1 << m) - 1)).to(
        torch.int64)
    code = ((_spread3(q[..., 0]) << 2) | (_spread3(q[..., 1]) << 1)
            | _spread3(q[..., 2]))
    seg = 2 * torch.arange(B, device=p.device)[:, None] + cloud
    return ((seg << (32 - sb)) | code) - (1 << 31)


def _sort_keys(p1, p2):
    """(B * (N1 + N2),) int32 sort keys of both clouds, as the card's
    prepass forms them, on one box around both clouds per batch entry."""
    B = p1.shape[0]
    lo, span = _frame(p1, p2)
    return torch.cat([_keys(p, lo, span, B, cloud)
                      for cloud, p in enumerate((p1, p2))],
                     dim=1).to(torch.int32).reshape(-1)


def _nan_chunks(p):
    """(B, ceil(n / CHUNK)) bool: the chunks of ``CHUNK`` points of ``p``
    (B, n, 3) that hold a NaN coordinate."""
    B, n, _ = p.shape
    nan = p.isnan().any(dim=-1)
    pad = torch.zeros((B, (-n) % CHUNK), dtype=torch.bool, device=p.device)
    return torch.cat([nan, pad], dim=1).reshape(B, -1, CHUNK).any(dim=-1)


def _records(p, order, n, pad_to, flags=None):
    """(B, pad_to, 4) float32 records (x, y, z, original index's bits) of
    one cloud in sorted order, padded by repeating the last sorted point
    with the index ``_PAD_ORIG``; ``order`` (B, n) holds the original
    indices. With ``flags`` (B, ceil(n / CHUNK)), the records of the
    points of a flagged chunk get NaN coordinates."""
    B = p.shape[0]
    idx = torch.cat([order, order[:, -1:].expand(B, pad_to - n)], dim=1)
    pts = torch.gather(p, 1, idx[..., None].expand(B, pad_to, 3))
    if flags is not None:
        marked = torch.gather(flags, 1, idx // CHUNK)
        pts = torch.where(marked[..., None], float('nan'), pts)
    orig = idx.to(torch.int32)
    orig[:, n:] = _PAD_ORIG
    return torch.cat([pts, orig.view(torch.float32)[..., None]], dim=-1)


def _prepass_plain(p1, p2):
    """Plain version of the pruned scan's prepass on the card (float32):
    see :func:`prepass`."""
    B, N1, _ = p1.shape
    N2 = p2.shape[1]
    C1, C2 = -(-N1 // TQ), -(-N2 // CH)
    skeys, order = torch.sort(_sort_keys(p1, p2), stable=True)
    seg = order.reshape(B, N1 + N2) - (N1 + N2) * torch.arange(
        B, device=p1.device)[:, None]
    qrec = _records(p1, seg[:, :N1], N1, C1 * TQ)
    rrec = _records(p2, seg[:, N1:] - N1, N2, C2 * CH, _nan_chunks(p2))
    r = rrec[..., :3].reshape(B, C2, CH, 3)
    rkeys = skeys.reshape(B, N1 + N2)[:, N1:]
    rkeys = torch.cat([rkeys, rkeys[:, -1:].expand(B, C2 * CH - N2)], dim=1)
    rkeys = rkeys.reshape(B, C2, CH).view(torch.float32)
    rbox = torch.stack([torch.cat([_nan_amin(r, 2), rkeys[..., :1]], -1),
                        torch.cat([_nan_amax(r, 2), rkeys[..., -1:]], -1)],
                       dim=2)
    zero = torch.zeros((B, 2, 1), dtype=p1.dtype, device=p1.device)
    frame = torch.cat([torch.cat(_frame(p1, p2), dim=1), zero], -1)
    return skeys, order, qrec, rrec, rbox, frame


def _prepass_cuda(p1, p2):
    """The card's prepass on contiguous float32 CUDA clouds."""
    B, N1, _ = p1.shape
    N2 = p2.shape[1]
    C1, C2 = -(-N1 // TQ), -(-N2 // CH)
    dev, stream = p1.device.index, _build.stream(p1.device)
    ext = torch.empty((B, _EXT_BLOCKS, 6), dtype=torch.float32,
                      device=p1.device)
    keys = torch.empty(B * (N1 + N2), dtype=torch.int32, device=p1.device)
    frame = torch.empty((B, 2, 4), dtype=torch.float32, device=p1.device)
    flags = torch.empty((B, -(-N2 // CHUNK)), dtype=torch.int32,
                        device=p1.device)
    _build.launch(_lib(), 'nearest_idx_keys', p1.data_ptr(), p2.data_ptr(),
                  ext.data_ptr(), keys.data_ptr(), frame.data_ptr(),
                  flags.data_ptr(), B, N1, N2, dev, stream)
    skeys, order = torch.sort(keys, stable=True)
    qrec = torch.empty((B, C1 * TQ, 4), dtype=torch.float32, device=p1.device)
    rrec = torch.empty((B, C2 * CH, 4), dtype=torch.float32, device=p1.device)
    rbox = torch.empty((B, C2, 2, 4), dtype=torch.float32, device=p1.device)
    _build.launch(_lib(), 'nearest_idx_pack', p1.data_ptr(), p2.data_ptr(),
                  skeys.data_ptr(), order.data_ptr(), flags.data_ptr(),
                  qrec.data_ptr(),
                  rrec.data_ptr(), rbox.data_ptr(), B, N1, N2, dev, stream)
    return skeys, order, qrec, rrec, rbox, frame


def prepass(p1, p2):
    """The prepass of :func:`nearest_idx_pruned` on float32 clouds of at
    least one point each, on their device: on the card two kernels and a
    ``torch.sort``, then a third kernel; on the CPU its plain version, with
    the same bits.

    Returns (sorted keys (B * (N1 + N2),) int32 -- per entry its queries'
    run, then its references' --, the sort's order (B * (N1 + N2),) int64,
    query records (B, C1 * TQ, 4), reference records (B, C2 * CH, 4) and
    the reference chunks' boxes (B, C2, 2, 4) as (lo, hi), w the bits of
    the chunk's first and last sorted key, and
    each entry's box of both clouds (B, 2, 4) as (lo, span) with w = 0, on
    which the keys are formed), C1 = ceil(N1 / TQ), C2 = ceil(N2 / CH).
    A record is (x, y, z, the
    original index's int32 bits), in Morton order, padded by repeating the
    last sorted point with the index ``_PAD_ORIG``; a reference's x, y, z
    are NaN when its chunk of ``CHUNK`` original indices holds a NaN
    coordinate, and the chunk boxes leave NaN out (NaN where a chunk holds
    nothing else)."""
    if _is_cuda(p1):
        return _prepass_cuda(*_build.cuda_inputs('prepass', (p1, p2))[0])
    return _prepass_plain(p1, p2)


def scan_cuda(p1, p2, scanned=None):
    """The prepass and the scan of :func:`nearest_idx_pruned` on checked
    CUDA inputs of at least one point each, not counted in its launches.
    ``scanned``, a zeroed (1,) int64 tensor on the card, gains the number
    of chunks scanned, each of ``TQ`` x ``CH`` pairs (the rest the box
    tests skipped)."""
    (p1, p2), _, dev, stream = _build.cuda_inputs('nearest_idx_pruned',
                                                  (p1, p2))
    B, N1, _ = p1.shape
    N2 = p2.shape[1]
    skeys, _, qrec, rrec, rbox, frame = _prepass_cuda(p1, p2)
    out = torch.empty((B, N1), dtype=torch.int32, device=p1.device)
    _build.launch(_lib(), 'nearest_idx_pruned_forward', skeys.data_ptr(),
                  frame.data_ptr(), qrec.data_ptr(), rrec.data_ptr(),
                  rbox.data_ptr(), out.data_ptr(), B, N1, N2,
                  None if scanned is None else scanned.data_ptr(), dev,
                  stream)
    return out


def nearest_idx_pruned(p1, p2):
    """:func:`nearest_idx` by a pruned scan: the same (B, N1) int32
    indices, ties included, with each warp's tile of Morton-sorted queries
    visiting the chunks of Morton-sorted references nearest first and
    skipping each chunk whose box lies farther from every query than its
    best distance so far."""
    _check('nearest_idx_pruned', p1, p2)
    if not _is_cuda(p1):
        return nearest_idx_plain(p1, p2)
    if p1.shape[0] * p1.shape[1] * p2.shape[1] == 0:
        return torch.zeros(p1.shape[:2], dtype=torch.int32, device=p1.device)
    out = scan_cuda(p1, p2)
    nearest_idx_pruned.launches += 1
    return out


nearest_idx.launches = 0
nearest_idx_pruned.launches = 0
