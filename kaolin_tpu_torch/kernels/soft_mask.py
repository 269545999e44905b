"""DIB-R soft silhouette mask, forward and backward: the CUDA kernels of
``csrc/soft_mask.cu`` and their plain PyTorch versions.

Port of ``soft_mask_forward_pallas`` and ``soft_mask_backward_pallas``
(``kaolin_tpu/kernels/soft_mask.py``). Each wrapper follows its inputs: on
CUDA tensors it launches its kernel (float32 only) and counts the launch in
its ``launches`` attribute; on CPU tensors it runs the plain version, which
mirrors the JAX package's order-exact XLA path (``_soft_mask_forward``,
``_dibr_soft_mask_bwd`` and ``_min6`` of ``kaolin_tpu/render/mesh/dibr.py``)
and takes float32 or float64.

Both record, per uncovered pixel, the first ``knum`` faces in ORIGINAL
order whose enlarged bbox contains the pixel. The Pallas kernels record
them in a spatially sorted order instead and so differ where ``knum``
binds; the port has no such case. The Pallas backward's moment form is not
carried over: the backward follows the XLA formulas per pixel.

On the card the forward walks per-tile face lists in id order
(``rasterize.tile_bins``): its own bboxes', or those ``bins`` it is
given.

For the backward the forward also returns the cut: per uncovered pixel the
id of its ``knum``-th recorded face, or F where it recorded fewer, and -1
on covered pixels. Face f was recorded at pixel p iff its enlarged bbox
holds p and ``f <= cut[p]``.
"""

import ctypes

import torch

from . import _build
from .rasterize import _bins, _pixel_coords, _is_cuda

__all__ = ['soft_mask_forward', 'soft_mask_forward_plain',
           'soft_mask_backward', 'soft_mask_backward_plain']

_EPS = 1e-7
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    'soft_mask_forward': ([_P] * 4 + [_I] + [_P] * 2 + [_I] * 7 + [_F] * 5
                          + [_I, _P]),
    'soft_mask_backward': [_P] * 7 + [_I] * 6 + [_F] * 5 + [_I, _P],
}
_PLAIN_BUDGET = 1 << 24


def _min6(px, py, img, multiplier):
    """Least of the 6 squared pixel-face distances and which it is: the 3
    edges (0-2) where the foot of the perpendicular falls inside the edge
    (else ``4 m^2``), and the 3 vertices (3-5); the first wins ties.
    Returns (dissquare, edgeid)."""
    bad = 4. * multiplier * multiplier
    dmin = edgeid = None
    for i in range(3):
        x1 = img[..., i * 2]
        y1 = img[..., i * 2 + 1]
        j = (i + 1) % 3
        x2 = img[..., j * 2]
        y2 = img[..., j * 2 + 1]
        A = y2 - y1
        B = x1 - x2
        C = x2 * y1 - x1 * y2
        up = A * px + B * py + C
        down = A * A + B * B
        x3 = (B * B * px - A * B * py - A * C) / (down + _EPS)
        y3 = (A * A * py - A * B * px - B * C) / (down + _EPS)
        direct = (x3 - x1) * (x3 - x2) + (y3 - y1) * (y3 - y2)
        perp = up * up / (down + _EPS)
        d = torch.where(direct > 0, bad, perp)
        if dmin is None:
            dmin, edgeid = d, torch.zeros(d.shape, dtype=torch.int8,
                                          device=d.device)
        else:
            dmin, edgeid = _take_less(d, i, dmin, edgeid)
    for i in range(3):
        dx = px - img[..., i * 2]
        dy = py - img[..., i * 2 + 1]
        dmin, edgeid = _take_less(dx * dx + dy * dy, 3 + i, dmin, edgeid)
    return dmin, edgeid


def _take_less(d, i, dmin, edgeid):
    less = d < dmin
    return torch.where(less, d, dmin), torch.where(less, i, edgeid)


def _chunks(B, F, H, W):
    """Slices of faces, in order, sized to the plain versions' budget."""
    chunk = max(1, min(32, _PLAIN_BUDGET // max(1, B * H * W)))
    return [slice(start, min(start + chunk, F))
            for start in range(0, F, chunk)]


def _hit(bboxes, sl, px, py):
    """(B, C, H, W) bool: the enlarged bbox of each face of ``sl`` holds the
    pixel centre."""
    bb = bboxes[:, sl, :, None, None]
    return ((px >= bb[:, :, 0]) & (px < bb[:, :, 2])
            & (py >= bb[:, :, 1]) & (py < bb[:, :, 3]))


def soft_mask_forward_plain(img_scaled, bboxes, selected_face_idx,
                            row_start=0, *, height, width, total_height=None,
                            knum, sigmainv, multiplier, return_cut=False):
    """Plain version of :func:`soft_mask_forward`, over face chunks carrying
    each pixel's bbox-hit count and running product; within a chunk the
    product is taken face by face, in the kernel's order."""
    B, F, _ = img_scaled.shape
    dtype, device = img_scaled.dtype, img_scaled.device
    x0, y0 = _pixel_coords(height, width, multiplier, dtype, row_start,
                           total_height, device)
    px = x0[None, None, None, :]
    py = y0[None, None, :, None]
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which the kernel does not
    m = img_scaled.new_tensor(multiplier)
    uncovered = selected_face_idx < 0
    prod = torch.ones((B, height, width), dtype=dtype, device=device)
    count = torch.zeros((B, 1, height, width), dtype=torch.int32,
                        device=device)
    cut = torch.where(uncovered & (knum > 0), F, -1).to(torch.int32)
    for sl in _chunks(B, F, height, width):
        hit = _hit(bboxes, sl, px, py) & uncovered[:, None]
        hit_i = hit.to(torch.int32)
        before = count + torch.cumsum(hit_i, dim=1, dtype=torch.int32) - hit_i
        count = count + hit_i.sum(dim=1, keepdim=True, dtype=torch.int32)
        dissquare, _ = _min6(px, py, img_scaled[:, sl, None, None, :],
                             multiplier)
        z = sigmainv * dissquare / m / m
        factor = torch.where(hit & (before < knum), 1. - torch.exp(-z), 1.)
        for k in range(factor.shape[1]):
            prod = prod * factor[:, k]
        if return_cut:
            last = hit & (before == knum - 1)
            ids = torch.arange(sl.start, sl.stop, dtype=torch.int32,
                               device=device)[None, :, None, None]
            cut = torch.where(last.any(dim=1),
                              torch.where(last, ids, 0).sum(dim=1,
                                                             dtype=torch.int32),
                              cut)
    mask = torch.where(uncovered, 1. - prod, 1.)
    return (mask, cut) if return_cut else mask


def soft_mask_backward_plain(img_scaled, bboxes, cut, soft_mask,
                             grad_soft_mask, row_start=0, *, height, width,
                             total_height=None, sigmainv, multiplier):
    """Plain version of :func:`soft_mask_backward`: per face chunk, the
    per-pixel terms of the recorded (pixel, face) pairs, summed over the
    pixels case by case (the vertex or the edge that is nearest) in the JAX
    package's order."""
    B, F, _ = img_scaled.shape
    x0, y0 = _pixel_coords(height, width, multiplier, img_scaled.dtype,
                           row_start, total_height, img_scaled.device)
    px = x0[None, None, None, :]
    py = y0[None, None, :, None]
    m = img_scaled.new_tensor(multiplier)
    dLdp = grad_soft_mask[:, None]
    allprob = soft_mask[:, None]
    grad = img_scaled.new_zeros((B, F, 6))
    for sl in _chunks(B, F, height, width):
        ids = torch.arange(sl.start, sl.stop,
                           device=cut.device)[None, :, None, None]
        recorded = _hit(bboxes, sl, px, py) & (ids <= cut[:, None])
        img = img_scaled[:, sl, None, None, :]
        dissquare, edgeid = _min6(px, py, img, multiplier)
        z = sigmainv * dissquare / m / m
        prob = torch.exp(-z)
        dLdz = (-1. * sigmainv * dLdp * (1. - allprob)
                / (1. - prob + _EPS) * prob)
        dLdz = torch.where(recorded, dLdz, 0.)
        g = grad[:, sl]

        def add(col, term):
            g[..., col] += term.sum(dim=(2, 3)) / m

        for v in range(3):
            m_v = torch.where(edgeid == 3 + v, dLdz, 0.)
            add(v * 2, m_v * 2. * (img[..., v * 2] - px))
            add(v * 2 + 1, m_v * 2. * (img[..., v * 2 + 1] - py))
        for e in range(3):
            j = (e + 1) % 3
            x1, y1 = img[..., e * 2], img[..., e * 2 + 1]
            x2, y2 = img[..., j * 2], img[..., j * 2 + 1]
            A = y2 - y1
            B_ = x1 - x2
            C_ = x2 * y1 - x1 * y2
            up = A * px + B_ * py + C_
            down = A * A + B_ * B_
            dsq = up * up / (down + _EPS)
            dzdA = 2. * (px * up - dsq * A) / (down + _EPS)
            dzdB = 2. * (py * up - dsq * B_) / (down + _EPS)
            dzdC = 2. * up / (down + _EPS)
            m_e = torch.where(edgeid == e, dLdz, 0.)
            add(e * 2, m_e * (dzdB - y2 * dzdC))
            add(e * 2 + 1, m_e * (x2 * dzdC - dzdA))
            add(j * 2, m_e * (y1 * dzdC - dzdB))
            add(j * 2 + 1, m_e * (dzdA - x1 * dzdC))
    return grad


def _lib():
    return _build.load('soft_mask', _SIGNATURES)


def soft_mask_forward(img_scaled, bboxes, selected_face_idx, row_start=0, *,
                      height, width, total_height=None, knum, sigmainv,
                      multiplier, return_cut=False, bins=None):
    """Soft mask: 1 on covered pixels, ``1 - prod(1 - p)`` over the first
    ``knum`` enlarged-bbox hits on uncovered ones.

    Args:
        img_scaled: (B, F, 6) image verts scaled by ``multiplier``.
        bboxes: (B, F, 4) their bboxes enlarged by ``boxlen*multiplier``.
        selected_face_idx: (B, H, W) int32 from the rasterizer.
        return_cut (bool): also return the cut that
            :func:`soft_mask_backward` takes.
        bins: on the card, the per-tile face lists the kernel walks
            (:func:`~kaolin_tpu_torch.kernels.rasterize.tile_bins` of
            bboxes that hold ``bboxes``); by default those of ``bboxes``.
            CPU tensors take none.

    Returns:
        (B, H, W) soft mask, and with ``return_cut`` the (B, H, W) int32
        cut.
    """
    if total_height is None:
        total_height = height
    if not _is_cuda(img_scaled):
        return soft_mask_forward_plain(
            img_scaled, bboxes, selected_face_idx, row_start, height=height,
            width=width, total_height=total_height, knum=knum,
            sigmainv=sigmainv, multiplier=multiplier, return_cut=return_cut)
    (img, bbox), (idx,), dev, stream = _build.cuda_inputs(
        'soft_mask_forward', (img_scaled, bboxes), (selected_face_idx,))
    B, F, _ = img.shape
    _build.check_shapes('soft_mask_forward', img, (B, F, 6), bbox, (B, F, 4),
                        idx, (B, height, width))
    if B * height * width == 0:         # no pixel: nothing to launch
        mask = img.new_zeros((B, height, width))
        return (mask, idx.clone()) if return_cut else mask
    lists, bin_first = _bins(bins, B, F, height, width, img.device)
    mask = img.new_empty((B, height, width))
    cut = (torch.empty((B, height, width), dtype=torch.int32,
                       device=img.device) if return_cut else None)
    _build.launch(
        _lib(), 'soft_mask_forward', img.data_ptr(), bbox.data_ptr(),
        idx.data_ptr(), lists.data_ptr(), bin_first, mask.data_ptr(),
        cut.data_ptr() if return_cut else None, B, F, height, width,
        int(row_start), int(total_height), int(knum),
        _build.pixel_scale(multiplier, width),
        _build.pixel_scale(multiplier, total_height), sigmainv, multiplier,
        4. * multiplier * multiplier, dev, stream)
    soft_mask_forward.launches += 1
    return (mask, cut) if return_cut else mask


soft_mask_forward.launches = 0


def soft_mask_backward(img_scaled, bboxes, cut, soft_mask, grad_soft_mask,
                       row_start=0, *, height, width, total_height=None,
                       sigmainv, multiplier):
    """Gradient of the soft mask with respect to the UNSCALED image verts.

    Args:
        img_scaled, bboxes: as for :func:`soft_mask_forward`.
        cut: (B, H, W) int32, from ``soft_mask_forward(...,
            return_cut=True)``.
        soft_mask: (B, H, W) the forward's output.
        grad_soft_mask: (B, H, W) its cotangent.

    Returns:
        (B, F, 6) gradient.
    """
    if total_height is None:
        total_height = height
    if not _is_cuda(img_scaled):
        return soft_mask_backward_plain(
            img_scaled, bboxes, cut, soft_mask, grad_soft_mask, row_start,
            height=height, width=width, total_height=total_height,
            sigmainv=sigmainv, multiplier=multiplier)
    (img, bbox, mask, grad), (cut,), dev, stream = _build.cuda_inputs(
        'soft_mask_backward', (img_scaled, bboxes, soft_mask, grad_soft_mask),
        (cut,))
    B, F, _ = img.shape
    _build.check_shapes('soft_mask_backward', img, (B, F, 6), bbox,
                        (B, F, 4), cut, (B, height, width), mask,
                        (B, height, width), grad, (B, height, width))
    grad_img = img.new_empty((B, F, 6))
    if B * F == 0:
        return grad_img
    # the kernel's live bitmap: a bit a pixel, 32 a word along the row
    live = torch.empty((B, height, (width + 31) // 32), dtype=torch.int32,
                       device=img.device)
    _build.launch(
        _lib(), 'soft_mask_backward', img.data_ptr(), bbox.data_ptr(),
        cut.data_ptr(), mask.data_ptr(), grad.data_ptr(), live.data_ptr(),
        grad_img.data_ptr(), B, F, height, width, int(row_start),
        int(total_height),
        _build.pixel_scale(multiplier, width),
        _build.pixel_scale(multiplier, total_height), sigmainv, multiplier,
        4. * multiplier * multiplier, dev, stream)
    soft_mask_backward.launches += 1
    return grad_img


soft_mask_backward.launches = 0
