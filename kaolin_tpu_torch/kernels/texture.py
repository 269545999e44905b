"""Texture sampling (``grid_sample``), forward and backward: the CUDA
kernels of ``csrc/grid_sample.cu`` and their plain PyTorch versions.

Port of ``grid_sample_pallas``, ``_grid_sample_bwd_pallas`` and the custom
VJP ``grid_sample_coords`` (``kaolin_tpu/kernels/texture.py``). Each
wrapper follows its inputs: on CUDA tensors it launches its kernels
(float32 only) and counts the call in its ``launches`` attribute; on CPU
tensors it runs the plain version, which follows the JAX package's XLA
gather path (``grid_sample_2d`` and ``_gather_pixels`` of
``kaolin_tpu/render/mesh/utils.py``) operation for operation and takes
float32 or float64. The Pallas kernels' one-hot matrix products are not
carried over, nor is their 128 x 128 limit: any texture size is taken.

The backward's texture gradient is a scatter, which on the card is bound
by where its terms land (on the DIB-R textured step ~117,000 points a
batch element sample one texel under a cotangent that is nonzero off the
mesh). The kernels bin the points with a nonzero cotangent by the 32 x 32
texel tiles their taps touch, into a list a tile in point order, and sum
each tile's terms in shared memory in a fixed order, a list cut into
chunks of ``LIST_CHUNK`` entries where it is longer; no float atomics, so
the gradient is the same bits at every launch. The buffers are sized from
the shapes; nothing is read back to the host. :func:`tile_lists_plain` and
:func:`texture_grad_tiled_plain` write that binning and that order out in
PyTorch (the latter gives the kernels' bits). The Pallas backward, too,
sums in a fixed order (the grid's), so both are deterministic.

Coordinates are the sampler's: ``ix`` in [0, W - 1] and ``iy`` in
[0, H - 1], unnormalised and clipped by the caller
(``render.mesh.grid_sample_2d``). :func:`grid_sample_uv` and
:func:`grid_sample_uv_backward` take OpenGL UVs instead, on the card only:
the same kernels, compiled in their UV mode, convert each point in its
thread with the operations of ``render.mesh.texture_mapping``'s PyTorch
composition in their order (``clip(u, 0, 1) * 2 - 1``, for v also ``* -1``,
then ``clip(((. + 1) * W - 1) / 2, 0, W - 1)``), and the backward takes
each point's dix, diy through that composition's backward in autograd's
order (each clip's min factor, then its max factor, as ``_balanced`` gives
them; ``/ 2``; ``* W``; for v ``* -1``; ``+ 0`` where the two selects'
gradients are summed; ``* 2``) to the UVs' gradient. No coordinate array
is stored, and samples, the texture gradient and the UVs' gradient are the
composition's bits (``grid_sample_coords`` on ``_uv_coords``).
"""

import ctypes
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .rasterize import _is_cuda
from ..casts import to_int

__all__ = ['grid_sample', 'grid_sample_plain', 'grid_sample_backward',
           'grid_sample_backward_plain', 'grid_sample_coords',
           'grid_sample_uv', 'grid_sample_uv_backward',
           'tile_lists_plain', 'texture_grad_tiled_plain']

_MODES = ('bilinear', 'nearest')
_F32 = torch.float32
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    'grid_sample_forward': [_P] * 5 + [_I] * 7 + [_P],
    'grid_sample_uv_forward': [_P] * 2 + [_L] * 2 + [_P] * 2 + [_I] * 7
    + [_P],
    'grid_sample_backward_layout': [_I] * 7 + [_P],
    'grid_sample_backward': [_P] * 9 + [_I] * 7 + [_P],
    'grid_sample_uv_backward': [_P] * 3 + [_L] * 2 + [_P] * 4 + [_I] * 7
    + [_P],
}
# the backward kernels' constants (csrc/grid_sample.cu): the texel tiles'
# side, the list entries a block sums, the warps of that block, each with
# its own copy of the tile, and the rule of the partial tiles' slots
TILE = 32
LIST_CHUNK = 4096
SUM_WARPS = 8
SLOTS_PER_TILE, SLOTS_EXTRA, SLOTS_MAX = 2, 512, 4096


def _check_mode(mode):
    if mode not in _MODES:
        raise ValueError(f'unsupported mode {mode!r}; expected one of '
                         f'{_MODES}')


def _bilinear_taps(ix, iy, H, W):
    """The four taps' flat texel indices (B, P) int64 and the fractions
    (wx, wy), as the XLA path forms them."""
    x0f, y0f = torch.floor(ix), torch.floor(iy)
    wx, wy = ix - x0f, iy - y0f
    x0, y0 = to_int(x0f, torch.int64), to_int(y0f, torch.int64)
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    return (y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1), wx, wy


def _nearest_tap(ix, iy, W):
    return (to_int(torch.round(iy), torch.int64) * W
            + to_int(torch.round(ix), torch.int64))


def _gather(maps, idx):
    """(B, P, C) texels of (B, C, H, W) ``maps`` at flat indices (B, P)."""
    B, C = maps.shape[:2]
    flat = maps.flatten(2)
    out = torch.gather(flat, 2, idx[:, None, :].expand(B, C, idx.shape[1]))
    return out.transpose(1, 2)


def _scatter(dmaps, idx, vals):
    """Adds (B, P, C) ``vals`` into flat (B, C, H*W) ``dmaps`` at (B, P)."""
    B, C = dmaps.shape[:2]
    dmaps.scatter_add_(2, idx[:, None, :].expand(B, C, idx.shape[1]),
                       vals.transpose(1, 2))


def grid_sample_plain(maps, ix, iy, mode='bilinear'):
    """Plain version of :func:`grid_sample`."""
    _check_mode(mode)
    _, _, H, W = maps.shape
    if mode == 'nearest':
        return _gather(maps, _nearest_tap(ix, iy, W))
    (i00, i01, i10, i11), wx, wy = _bilinear_taps(ix, iy, H, W)
    wx, wy = wx[..., None], wy[..., None]
    return (_gather(maps, i00) * (1 - wy) * (1 - wx)
            + _gather(maps, i01) * (1 - wy) * wx
            + _gather(maps, i10) * wy * (1 - wx)
            + _gather(maps, i11) * wy * wx)


def grid_sample_backward_plain(maps, ix, iy, cot, mode='bilinear'):
    """Plain version of :func:`grid_sample_backward`. The coordinate
    gradients sum over channels in channel order, as the kernel does."""
    _check_mode(mode)
    B, C, H, W = maps.shape
    dmaps = maps.new_zeros((B, C, H * W))
    if mode == 'nearest':
        _scatter(dmaps, _nearest_tap(ix, iy, W), cot)
        return (dmaps.reshape(maps.shape), torch.zeros_like(ix),
                torch.zeros_like(iy))
    taps, wx, wy = _bilinear_taps(ix, iy, H, W)
    v00, v01, v10, v11 = (_gather(maps, i) for i in taps)
    ax, ay = 1 - wx, 1 - wy
    dix, diy = torch.zeros_like(ix), torch.zeros_like(iy)
    for c in range(C):
        g = cot[..., c]
        dix = dix + g * ((v01[..., c] - v00[..., c]) * ay
                         + (v11[..., c] - v10[..., c]) * wy)
        diy = diy + g * ((v10[..., c] - v00[..., c]) * ax
                         + (v11[..., c] - v01[..., c]) * wx)
    ax, ay, wx, wy = ax[..., None], ay[..., None], wx[..., None], wy[..., None]
    for idx, w1, w2 in zip(taps, (ax, wx, ax, wx), (ay, ay, wy, wy)):
        _scatter(dmaps, idx, cot * w1 * w2)
    return dmaps.reshape(maps.shape), dix, diy


def _tile_taps(ix, iy, H, W, mode):
    """The taps the kernels take, clamped to the texture: (x, y) int64
    (B, P, k) and, bilinear, the weights' factors (w1, w2) (B, P, 4) of
    each tap's term ``cot * w1 * w2``; k = 4 bilinear, 1 nearest."""
    if mode == 'nearest':
        x = to_int(torch.round(ix), torch.int64).clamp(0, W - 1)
        y = to_int(torch.round(iy), torch.int64).clamp(0, H - 1)
        return x[..., None], y[..., None], None
    x0f, y0f = torch.floor(ix), torch.floor(iy)
    wx, wy = ix - x0f, iy - y0f
    x0 = to_int(x0f, torch.int64).clamp(0, W - 1)
    y0 = to_int(y0f, torch.int64).clamp(0, H - 1)
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    ax, ay = 1 - wx, 1 - wy
    return (torch.stack([x0, x1, x0, x1], -1),
            torch.stack([y0, y0, y1, y1], -1),
            (torch.stack([ax, wx, ax, wx], -1),
             torch.stack([ay, ay, wy, wy], -1)))


def tile_lists_plain(ix, iy, cot, H, W, mode='bilinear'):
    """The backward kernels' lists, written out: for each (batch element,
    TILE x TILE texel tile), row-major within an element, the points whose
    cotangent is nonzero in some channel and one of whose taps lies in the
    tile, as ``b * P + p``, in the order the kernels place them: by step
    of 32 points (p // 32), then by the tile's rank among the point's
    tiles (ascending), then by lane (p % 32).

    Returns (lists (E,) int64, starts (B * T,) int64, counts (B * T,)
    int64): tile ``b * T + t``'s list is ``lists[starts:starts + counts]``.
    """
    _check_mode(mode)
    B, P = ix.shape
    tiles_x = -(-W // TILE)
    ntiles = tiles_x * -(-H // TILE)
    xs, ys, _ = _tile_taps(ix, iy, H, W, mode)
    keys = ((ys // TILE) * tiles_x + xs // TILE).sort(-1).values
    first = torch.ones_like(keys, dtype=torch.bool)
    first[..., 1:] = keys[..., 1:] != keys[..., :-1]
    rank = torch.cumsum(first.long(), -1) - 1
    sel = first & (cot != 0).any(-1)[..., None]
    p = torch.arange(P, device=ix.device)[:, None]
    order = ((p // 32) * 4 + rank) * 32 + p % 32          # (B, P, k)
    b = torch.arange(B, device=ix.device)[:, None, None]
    tile = (b * ntiles + keys)[sel]
    point = (b * P + p).expand(keys.shape)[sel]
    _, idx = torch.sort(tile * (4 * P + 128) + order[sel])
    counts = torch.bincount(tile, minlength=B * ntiles)
    return point[idx], torch.cumsum(counts, 0) - counts, counts


def partial_slots(B, P, H, W, mode='bilinear', list_chunk=LIST_CHUNK):
    """The slots of partial tiles the backward kernels share out (their
    layout's rule, which the card's layout reports): SLOTS_PER_TILE a tile
    and SLOTS_EXTRA, at most SLOTS_MAX and no more than the chunks the
    lists can hold."""
    ntiles = -(-W // TILE) * -(-H // TILE)
    emax = (1 if mode == 'nearest' else 4) * B * P
    return min(SLOTS_PER_TILE * B * ntiles + SLOTS_EXTRA, SLOTS_MAX,
               2 * emax // list_chunk)


def _chunks(start, n, total, slots, list_chunk):
    """How the kernels cut a tile's list: (chunks, the first slot of its
    partial tiles). Tile [start, start + n) of ``total`` entries owns slots
    [slots * start // total, slots * (start + n) // total) and takes
    ceil(n / list_chunk) chunks, at most that many; one below 2."""
    first = slots * start // total if total else 0
    region = (slots * (start + n) // total if total else 0) - first
    items = min(-(-n // list_chunk), region)
    return (items if items >= 2 else 1), first


def texture_grad_tiled_plain(ix, iy, cot, H, W, mode='bilinear',
                             list_chunk=LIST_CHUNK, slots=None):
    """The texture gradient as the backward kernels sum it, order for
    order, from :func:`tile_lists_plain`'s lists: a tile's list is cut
    into chunks (``_chunks``: at most ``list_chunk`` entries a chunk where
    the tile's share of the ``slots`` partial tiles allows, of equal
    length ceil(n / chunks)); each chunk is summed by SUM_WARPS copies
    of the tile, copy ``w`` taking the steps of 32 entries ``w, w +
    SUM_WARPS, ...``; in a step, tap by tap, the terms of the lanes that
    add into one texel are summed in lane order (all 32 lanes: by an xor
    butterfly, 16, 8, 4, 2, 1) and the sum added to the copy; the copies
    are added in warp order, and the chunks' sums in chunk order. A loop
    in Python: for small inputs. Returns (B, C, H, W)."""
    B, P, C = cot.shape
    if slots is None:
        slots = partial_slots(B, P, H, W, mode, list_chunk)
    lists, starts, counts = tile_lists_plain(ix, iy, cot, H, W, mode)
    total = int(counts.sum())
    xs, ys, wts = _tile_taps(ix, iy, H, W, mode)
    xs, ys = xs.reshape(B * P, -1), ys.reshape(B * P, -1)
    flat_cot = cot.reshape(B * P, C)
    if wts is not None:
        w1, w2 = (w.reshape(B * P, -1) for w in wts)
    tiles_x = -(-W // TILE)
    ntiles = tiles_x * -(-H // TILE)
    out = cot.new_zeros((B, C, H, W))
    for tt in range(B * ntiles):
        b, t = divmod(tt, ntiles)
        ty0, tx0 = (t // tiles_x) * TILE, (t % tiles_x) * TILE
        n, s0 = int(counts[tt]), int(starts[tt])
        items = _chunks(s0, n, total, slots, list_chunk)[0]
        size = -(-n // items) if items > 1 else n
        acc = None
        for j in range(items):
            ent = lists[s0 + min(j * size, n):s0 + min((j + 1) * size, n)]
            copies = cot.new_zeros((SUM_WARPS, C, TILE * TILE))
            for q in range(-(-ent.numel() // 32)):
                step = ent[q * 32:(q + 1) * 32]
                for k in range(xs.shape[1]):
                    lx, ly = xs[step, k] - tx0, ys[step, k] - ty0
                    inside = (lx >= 0) & (lx < TILE) & (ly >= 0) & (ly < TILE)
                    local = ly * TILE + lx
                    terms = flat_cot[step] if wts is None else (
                        flat_cot[step] * w1[step, k, None] * w2[step, k, None])
                    hit = torch.unique(local[inside])
                    if step.numel() == 32 and hit.numel() == 1 and \
                            bool(inside.all()):
                        # one texel for all 32 lanes: an xor butterfly
                        for o in (16, 8, 4, 2, 1):
                            terms = terms + terms[torch.arange(32) ^ o]
                        copies[q % SUM_WARPS][:, hit[0]] += terms[0]
                        continue
                    group = cot.new_zeros((C, TILE * TILE))
                    for lane in torch.nonzero(inside).flatten().tolist():
                        group[:, local[lane]] += terms[lane]
                    copies[q % SUM_WARPS][:, hit] += group[:, hit]
            part = copies[0]
            for w in range(1, SUM_WARPS):
                part = part + copies[w]
            acc = part if acc is None else acc + part
        h, w = min(TILE, H - ty0), min(TILE, W - tx0)
        out[b, :, ty0:ty0 + h, tx0:tx0 + w] = acc.reshape(
            C, TILE, TILE)[:, :h, :w]
    return out


def _lib():
    return _build.load('grid_sample', _SIGNATURES)


def _check_devices(fn, maps, *coords):
    for t in coords:
        if t.device != maps.device:
            raise ValueError(f'{fn}: texture on {maps.device}, coordinates '
                             f'on {t.device}')


def grid_sample(maps, ix, iy, mode='bilinear'):
    """Samples (B, C, H, W) ``maps`` at sampler coordinates ``ix``, ``iy``
    (B, P), clipped to [0, W - 1] and [0, H - 1]. Bilinear or nearest (half
    to even). Returns (B, P, C).

    On the card the texture is first copied to a (B, H, W, C4) scratch,
    channels interleaved and padded to a multiple of 4, so that each tap's
    channels come in 16-byte loads; both launches go through one C call.
    The wrapper's checks are inline: at config 2's size the kernel takes
    tens of microseconds, comparable with the host's cost of a call.
    """
    return _grid_sample(maps, ix, iy, mode)[0]


def _grid_sample(maps, ix, iy, mode):
    """:func:`grid_sample` and, on the card, its interleaved copy of the
    texture (None on the CPU)."""
    _check_mode(mode)
    _check_devices('grid_sample', maps, ix, iy)
    if not _is_cuda(maps):
        return grid_sample_plain(maps, ix, iy, mode), None
    if maps.dtype != _F32 or ix.dtype != _F32 or iy.dtype != _F32:
        raise TypeError(f'grid_sample: the CUDA kernel takes float32, got '
                        f'{maps.dtype}, {ix.dtype}, {iy.dtype}')
    B, C, H, W = maps.shape
    P = ix.shape[1]
    _build.check_shapes('grid_sample', ix, (B, P), iy, (B, P))
    out, tex = _sample_cuda(maps, ix, iy, mode)
    grid_sample.launches += 1
    return out, tex


def _sample_cuda(maps, ix, iy, mode):
    """The CUDA kernels of :func:`grid_sample` on checked CUDA inputs: the
    samples and the interleaved copy of the texture."""
    B, C, H, W = maps.shape
    P = ix.shape[1]
    maps, ix, iy = maps.contiguous(), ix.contiguous(), iy.contiguous()
    dev = maps.device
    tex = torch.empty((B, H, W, -(-C // 4) * 4), dtype=_F32, device=dev)
    out = torch.empty((B, P, C), dtype=_F32, device=dev)
    _build.launch(_lib(), 'grid_sample_forward', maps.data_ptr(),
                  ix.data_ptr(), iy.data_ptr(), tex.data_ptr(),
                  out.data_ptr(), B, C, H, W, P, int(mode == 'nearest'),
                  dev.index, _build.stream(dev))
    return out, tex


@functools.lru_cache(maxsize=64)
def _backward_layout(B, C, H, W, P, nearest, have_tex):
    """(scratch bytes, byte offsets of the tiles' list starts, their
    lengths and the lists, tiles a batch element, slots of partial tiles)
    of the backward."""
    out = (ctypes.c_longlong * 6)()
    _build.launch(_lib(), 'grid_sample_backward_layout', B, C, H, W, P,
                  int(nearest), int(have_tex), out)
    return tuple(out)


def grid_sample_backward(maps, ix, iy, cot, mode='bilinear',
                         interleaved=None):
    """Gradients of :func:`grid_sample` for the cotangent ``cot`` (B, P, C).

    Returns (dmaps (B, C, H, W), dix (B, P), diy (B, P)). On the card all
    three are the same bits at every launch, dix and diy the plain
    version's. ``interleaved``: the forward's (B, H, W, C4) copy of the
    texture on the card, which spares the backward its own.
    """
    return _backward(maps, ix, iy, cot, mode, interleaved)[:3]


def _backward(maps, ix, iy, cot, mode, interleaved=None, lists=False):
    """:func:`grid_sample_backward`; with ``lists`` (on the card) also the
    kernels' (lists, starts, counts) as :func:`tile_lists_plain` gives
    them (int32)."""
    _check_mode(mode)
    _check_devices('grid_sample_backward', maps, ix, iy, cot)
    if not _is_cuda(maps):
        return grid_sample_backward_plain(maps, ix, iy, cot, mode)
    (tex, x, y, g), _, dev, stream = _build.cuda_inputs(
        'grid_sample_backward', (maps, ix, iy, cot))
    B, C, H, W = tex.shape
    P = x.shape[1]
    _build.check_shapes('grid_sample_backward', x, (B, P), y, (B, P), g,
                        (B, P, C))
    nearest, inter, scratch, layout = _backward_scratch(
        'grid_sample_backward', tex, P, mode, interleaved)
    dmaps = torch.empty_like(tex)
    dix, diy = x.new_empty((B, P)), y.new_empty((B, P))
    _build.launch(_lib(), 'grid_sample_backward', tex.data_ptr(),
                  None if inter is None else inter.data_ptr(),
                  x.data_ptr(), y.data_ptr(), g.data_ptr(), dmaps.data_ptr(),
                  dix.data_ptr(), diy.data_ptr(), scratch.data_ptr(), B, C,
                  H, W, P, int(nearest), dev, stream)
    grid_sample_backward.launches += 1
    if not lists:
        return dmaps, dix, diy
    _, o_start, o_n, o_list, ntiles, _ = layout

    def ints(offset, n):
        return scratch[offset:offset + 4 * n].view(torch.int32)
    starts, counts = ints(o_start, B * ntiles), ints(o_n, B * ntiles)
    return dmaps, dix, diy, (ints(o_list, int(counts.sum())), starts,
                             counts)


def _backward_scratch(fn, tex, P, mode, interleaved):
    """The backward's checked interleaved copy (None in nearest mode or
    where not given), its scratch and its layout, for checked CUDA
    ``tex`` (B, C, H, W) and P points a batch element."""
    B, C, H, W = tex.shape
    if 4 * B * P >= 2 ** 31:
        raise ValueError(f'{fn}: {B} x {P} points; the kernels take fewer '
                         'than 2^29')
    nearest = mode == 'nearest'
    inter = None if nearest else interleaved
    if inter is not None:
        _build.check_shapes(fn, inter, (B, H, W, -(-C // 4) * 4))
        inter = _build.cuda_inputs(fn, (inter,))[0][0]
    layout = _backward_layout(B, C, H, W, P, nearest, inter is not None)
    scratch = torch.empty(layout[0], dtype=torch.uint8, device=tex.device)
    return nearest, inter, scratch, layout


grid_sample.launches = 0
grid_sample_backward.launches = 0


class _GridSampleCoords(torch.autograd.Function):

    @staticmethod
    def forward(ctx, maps, ix, iy, mode):
        ctx.save_for_backward(maps, ix, iy)
        ctx.mode = mode
        out, ctx.interleaved = _grid_sample(maps, ix, iy, mode)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, cot):
        maps, ix, iy = ctx.saved_tensors
        dmaps, dix, diy = grid_sample_backward(maps, ix, iy, cot, ctx.mode,
                                               ctx.interleaved)
        ctx.interleaved = None
        return dmaps, dix, diy, None


def grid_sample_coords(input_maps, ix, iy, mode='bilinear'):
    """Differentiable :func:`grid_sample`: gradients to the maps and to
    both coordinates through :func:`grid_sample_backward`."""
    return _GridSampleCoords.apply(input_maps, ix, iy, mode)


def _uv_points(uv):
    """(B, P, batch stride, point stride), strides in floats, of UVs (B,
    ..., 2) whose last dimension has stride 1 and whose points flatten to
    (B, P) with one stride (a contiguous map, the rasterizer's view of
    its feature map); None for any other layout."""
    if uv.dim() < 2 or uv.shape[-1] != 2 or uv.stride(-1) != 1:
        return None
    dims = [(n, st) for n, st in zip(uv.shape[1:-1], uv.stride()[1:-1])
            if n != 1]
    sp = dims[-1][1] if dims else 2
    want = sp
    for n, st in reversed(dims):
        if st != want:
            return None
        want = st * n
    return uv.shape[0], math.prod(uv.shape[1:-1]), uv.stride(0), sp


def _uv_inputs(fn, maps, uv, mode):
    """Checked inputs of the UV route: (contiguous maps, (B, P, batch
    stride, point stride) of ``uv``, device index, stream). ``uv`` must be
    read where it lies (:func:`_uv_points`); :func:`grid_sample_uv` copies
    any other layout before it gets here."""
    _check_mode(mode)
    _check_devices(fn, maps, uv)
    if not _is_cuda(maps) or maps.dtype != _F32 or uv.dtype != _F32:
        raise TypeError(f'{fn}: the UV route takes CUDA float32 tensors, got '
                        f'{maps.dtype} on {maps.device}, {uv.dtype}')
    if maps.dim() != 4 or uv.dim() < 2 or uv.shape[0] != maps.shape[0] \
            or uv.shape[-1] != 2:
        raise ValueError(f'{fn}: maps (B, C, H, W) and UVs (B, ..., 2), '
                         f'got {tuple(maps.shape)} and {tuple(uv.shape)}')
    pts = _uv_points(uv)
    if pts is None:
        raise ValueError(f'{fn}: UVs of strides {uv.stride()} do not '
                         'flatten to (B, P) points with one stride')
    if 4 * pts[0] * pts[1] >= 2 ** 31:
        raise ValueError(f'{fn}: {pts[0]} x {pts[1]} points; the kernels '
                         'take fewer than 2^29')
    return maps.contiguous(), pts, maps.device.index, _build.stream(
        maps.device)


def _sample_uv(maps, uv, mode):
    """:func:`grid_sample_uv`'s samples (B, P, C) and interleaved copy."""
    maps, (B, P, sb, sp), dev, stream = _uv_inputs('grid_sample_uv', maps,
                                                   uv, mode)
    _, C, H, W = maps.shape
    tex = torch.empty((B, H, W, -(-C // 4) * 4), dtype=_F32,
                      device=maps.device)
    out = torch.empty((B, P, C), dtype=_F32, device=maps.device)
    _build.launch(_lib(), 'grid_sample_uv_forward', maps.data_ptr(),
                  uv.data_ptr(), sb, sp, tex.data_ptr(), out.data_ptr(), B,
                  C, H, W, P, int(mode == 'nearest'), dev, stream)
    grid_sample_uv.launches += 1
    return out, tex


def grid_sample_uv_backward(maps, uv, cot, mode='bilinear',
                            interleaved=None):
    """Gradients of :func:`grid_sample_uv` for the cotangent ``cot`` (B, P,
    C): (dmaps (B, C, H, W), duv in ``uv``'s shape), the bits of
    ``grid_sample_coords`` on ``render.mesh.utils._uv_coords`` (the
    module's docstring). ``uv`` as :func:`grid_sample_uv` reads it (its
    points flatten to (B, P) with one stride); ``interleaved``: the
    forward's (B, H, W, C4) copy of the texture. CUDA float32 only."""
    fn = 'grid_sample_uv_backward'
    maps, (B, P, sb, sp), dev, stream = _uv_inputs(fn, maps, uv, mode)
    _check_devices(fn, maps, cot)
    _, C, H, W = maps.shape
    if cot.dtype != _F32:
        raise TypeError(f'{fn}: the cotangent is {cot.dtype}, not float32')
    _build.check_shapes(fn, cot, (B, P, C))
    cot = cot.contiguous()
    nearest, inter, scratch, _ = _backward_scratch(fn, maps, P, mode,
                                                   interleaved)
    dmaps = torch.empty_like(maps)
    duv = uv.new_empty((B, P, 2))
    _build.launch(_lib(), fn, maps.data_ptr(),
                  None if inter is None else inter.data_ptr(), uv.data_ptr(),
                  sb, sp, cot.data_ptr(), dmaps.data_ptr(), duv.data_ptr(),
                  scratch.data_ptr(), B, C, H, W, P, int(nearest), dev,
                  stream)
    grid_sample_uv_backward.launches += 1
    return dmaps, duv.reshape(uv.shape)


class _GridSampleUv(torch.autograd.Function):

    @staticmethod
    def forward(ctx, maps, uv, mode):
        ctx.save_for_backward(maps, uv)
        ctx.mode = mode
        out, ctx.interleaved = _sample_uv(maps, uv, mode)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, cot):
        maps, uv = ctx.saved_tensors
        dmaps, duv = grid_sample_uv_backward(maps, uv, cot, ctx.mode,
                                             ctx.interleaved)
        ctx.interleaved = None
        return dmaps, duv, None


def grid_sample_uv(input_maps, uv, mode='bilinear'):
    """Differentiable sampling of (B, C, H, W) ``input_maps`` at OpenGL UVs
    ``uv`` (B, ..., 2) in [0, 1], v bottom to top (``align_corners=False``,
    border padding); returns (B, P, C), P the points of ``uv``. Gradients
    to the maps and the UVs by :func:`grid_sample_uv_backward`.

    CUDA float32 only (``render.mesh.texture_mapping`` takes the PyTorch
    composition elsewhere). UVs whose last dimension has stride 1 and whose
    points flatten to (B, P) with one stride are read where they lie (the
    rasterizer's stride-3 view of its feature map, a contiguous map); any
    other layout is copied first. Fewer than 2^29 points in all. Saves the
    maps, ``uv`` and the forward's interleaved copy for the backward, and
    no coordinate array.
    """
    if _uv_points(uv) is None:
        uv = uv.contiguous()
    return _GridSampleUv.apply(input_maps, uv, mode)


grid_sample_uv.launches = 0
grid_sample_uv_backward.launches = 0
