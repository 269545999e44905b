"""Texture sampling (``grid_sample``), forward and backward: the CUDA
kernels of ``csrc/grid_sample.cu`` and their plain PyTorch versions.

Port of ``grid_sample_pallas``, ``_grid_sample_bwd_pallas`` and the custom
VJP ``grid_sample_coords`` (``kaolin_tpu/kernels/texture.py``). Each
wrapper follows its inputs: on CUDA tensors it launches its kernel
(float32 only) and counts the launch in its ``launches`` attribute; on CPU
tensors it runs the plain version, which follows the JAX package's XLA
gather path (``grid_sample_2d`` and ``_gather_pixels`` of
``kaolin_tpu/render/mesh/utils.py``) operation for operation and takes
float32 or float64. The Pallas kernels' one-hot matrix products are not
carried over, nor is their 128 x 128 limit: any texture size is taken.

Coordinates are the sampler's: ``ix`` in [0, W - 1] and ``iy`` in
[0, H - 1], unnormalised and clipped by the caller
(``render.mesh.grid_sample_2d``).
"""

import ctypes

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .rasterize import _is_cuda

__all__ = ['grid_sample', 'grid_sample_plain', 'grid_sample_backward',
           'grid_sample_backward_plain', 'grid_sample_coords']

_MODES = ('bilinear', 'nearest')
_F32 = torch.float32
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    'grid_sample_forward': [_P] * 5 + [_I] * 7 + [_P],
    'grid_sample_backward': [_P] * 7 + [_I] * 7 + [_P],
}


def _check_mode(mode):
    if mode not in _MODES:
        raise ValueError(f'unsupported mode {mode!r}; expected one of '
                         f'{_MODES}')


def _bilinear_taps(ix, iy, H, W):
    """The four taps' flat texel indices (B, P) int64 and the fractions
    (wx, wy), as the XLA path forms them."""
    x0f, y0f = torch.floor(ix), torch.floor(iy)
    wx, wy = ix - x0f, iy - y0f
    x0, y0 = x0f.long(), y0f.long()
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    return (y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1), wx, wy


def _nearest_tap(ix, iy, W):
    return torch.round(iy).long() * W + torch.round(ix).long()


def _gather(maps, idx):
    """(B, P, C) texels of (B, C, H, W) ``maps`` at flat indices (B, P)."""
    B, C = maps.shape[:2]
    flat = maps.reshape(B, C, -1)
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
    _check_mode(mode)
    _check_devices('grid_sample', maps, ix, iy)
    if not _is_cuda(maps):
        return grid_sample_plain(maps, ix, iy, mode)
    if maps.dtype != _F32 or ix.dtype != _F32 or iy.dtype != _F32:
        raise TypeError(f'grid_sample: the CUDA kernel takes float32, got '
                        f'{maps.dtype}, {ix.dtype}, {iy.dtype}')
    B, C, H, W = maps.shape
    P = ix.shape[1]
    _build.check_shapes('grid_sample', ix, (B, P), iy, (B, P))
    out = sample_cuda(maps, ix, iy, mode)
    grid_sample.launches += 1
    return out


def sample_cuda(maps, ix, iy, mode='bilinear'):
    """The CUDA kernels of :func:`grid_sample` on checked CUDA inputs, not
    counted in its launches."""
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
    return out


def grid_sample_backward(maps, ix, iy, cot, mode='bilinear'):
    """Gradients of :func:`grid_sample` for the cotangent ``cot`` (B, P, C).

    Returns (dmaps (B, C, H, W), dix (B, P), diy (B, P)). On the card dix
    and diy are the same bits at every launch; dmaps sums with atomics, so
    its last bits vary between launches.
    """
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
    dmaps = torch.zeros_like(tex)
    dix, diy = x.new_empty((B, P)), y.new_empty((B, P))
    _build.launch(_lib(), 'grid_sample_backward', tex.data_ptr(),
                  x.data_ptr(), y.data_ptr(), g.data_ptr(), dmaps.data_ptr(),
                  dix.data_ptr(), diy.data_ptr(), B, C, H, W, P,
                  int(mode == 'nearest'), dev, stream)
    grid_sample_backward.launches += 1
    return dmaps, dix, diy


grid_sample.launches = 0
grid_sample_backward.launches = 0


class _GridSampleCoords(torch.autograd.Function):

    @staticmethod
    def forward(ctx, maps, ix, iy, mode):
        ctx.save_for_backward(maps, ix, iy)
        ctx.mode = mode
        return grid_sample(maps, ix, iy, mode)

    @staticmethod
    @once_differentiable
    def backward(ctx, cot):
        maps, ix, iy = ctx.saved_tensors
        dmaps, dix, diy = grid_sample_backward(maps, ix, iy, cot, ctx.mode)
        return dmaps, dix, diy, None


def grid_sample_coords(input_maps, ix, iy, mode='bilinear'):
    """Differentiable :func:`grid_sample`: gradients to the maps and to
    both coordinates through :func:`grid_sample_backward`."""
    return _GridSampleCoords.apply(input_maps, ix, iy, mode)
