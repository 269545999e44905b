"""DIB-R soft silhouette mask, forward: the CUDA kernel of
``csrc/soft_mask.cu`` and its plain PyTorch version.

Port of ``soft_mask_forward_pallas`` (``kaolin_tpu/kernels/soft_mask.py``).
The wrapper follows its inputs: on CUDA tensors it launches the kernel
(float32 only) and counts the launch in ``soft_mask_forward.launches``; on
CPU tensors it runs the plain version, which mirrors the JAX package's
order-exact XLA path (``_soft_mask_forward`` and ``_min6`` of
``kaolin_tpu/render/mesh/dibr.py``) and takes float32 or float64.

Both record, per uncovered pixel, the first ``knum`` faces in ORIGINAL
order whose enlarged bbox contains the pixel. The Pallas kernel records
them in a spatially sorted order instead and so differs where ``knum``
binds; the port has no such case.
"""

import ctypes

import torch

from . import _build
from .rasterize import _pixel_coords, _is_cuda

__all__ = ['soft_mask_forward', 'soft_mask_forward_plain']

_EPS = 1e-7
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    'soft_mask_forward': [_P] * 4 + [_I] * 7 + [_F] * 5 + [_I, _P],
}
_PLAIN_BUDGET = 1 << 24


def _min6(px, py, img, multiplier):
    """Least of the 6 squared pixel-face distances: the 3 edges where the
    foot of the perpendicular falls inside the edge (else ``4 m^2``), and
    the 3 vertices."""
    bad = 4. * multiplier * multiplier
    dmin = None
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
        dmin = d if dmin is None else torch.minimum(dmin, d)
    for i in range(3):
        dx = px - img[..., i * 2]
        dy = py - img[..., i * 2 + 1]
        dmin = torch.minimum(dmin, dx * dx + dy * dy)
    return dmin


def soft_mask_forward_plain(img_scaled, bboxes, selected_face_idx,
                            row_start=0, *, height, width, total_height=None,
                            knum, sigmainv, multiplier):
    """Plain version of :func:`soft_mask_forward`, over face chunks carrying
    each pixel's bbox-hit count and running product; within a chunk the
    product is taken face by face, in the kernel's order."""
    B, F, _ = img_scaled.shape
    dtype, device = img_scaled.dtype, img_scaled.device
    x0, y0 = _pixel_coords(height, width, multiplier, dtype, row_start,
                           total_height, device)
    px = x0[None, None, None, :]
    py = y0[None, None, :, None]
    chunk = max(1, min(32, _PLAIN_BUDGET // max(1, B * height * width)))
    uncovered = (selected_face_idx < 0)[:, None]
    count = torch.zeros((B, 1, height, width), dtype=torch.int32,
                        device=device)
    prod = torch.ones((B, height, width), dtype=dtype, device=device)
    for start in range(0, F, chunk):
        sl = slice(start, min(start + chunk, F))
        bb = bboxes[:, sl, :, None, None]
        hit = ((px >= bb[:, :, 0]) & (px < bb[:, :, 2])
               & (py >= bb[:, :, 1]) & (py < bb[:, :, 3]) & uncovered)
        hit_i = hit.to(torch.int32)
        cum_before = count + torch.cumsum(hit_i, dim=1,
                                          dtype=torch.int32) - hit_i
        recorded = hit & (cum_before < knum)
        dissquare = _min6(px, py, img_scaled[:, sl, None, None, :],
                          multiplier)
        # a tensor divisor: PyTorch's CUDA division by a Python scalar
        # multiplies by its reciprocal, which the kernel does not
        m = dissquare.new_tensor(multiplier)
        z = sigmainv * dissquare / m / m
        factor = torch.where(recorded, 1. - torch.exp(-z), 1.)
        for k in range(factor.shape[1]):
            prod = prod * factor[:, k]
        count = count + hit_i.sum(dim=1, keepdim=True, dtype=torch.int32)
    return torch.where(selected_face_idx < 0, 1. - prod, 1.)


def _lib():
    return _build.load('soft_mask', _SIGNATURES)


def soft_mask_forward(img_scaled, bboxes, selected_face_idx, row_start=0, *,
                      height, width, total_height=None, knum, sigmainv,
                      multiplier):
    """Soft mask: 1 on covered pixels, ``1 - prod(1 - p)`` over the first
    ``knum`` enlarged-bbox hits on uncovered ones.

    Args:
        img_scaled: (B, F, 6) image verts scaled by ``multiplier``.
        bboxes: (B, F, 4) their bboxes enlarged by ``boxlen*multiplier``.
        selected_face_idx: (B, H, W) int32 from the rasterizer.

    Returns:
        (B, H, W) soft mask.
    """
    if total_height is None:
        total_height = height
    if not _is_cuda(img_scaled):
        return soft_mask_forward_plain(
            img_scaled, bboxes, selected_face_idx, row_start, height=height,
            width=width, total_height=total_height, knum=knum,
            sigmainv=sigmainv, multiplier=multiplier)
    (img, bbox), (idx,), dev, stream = _build.cuda_inputs(
        'soft_mask_forward', (img_scaled, bboxes), (selected_face_idx,))
    B, F, _ = img.shape
    _build.check_shapes('soft_mask_forward', img, (B, F, 6), bbox, (B, F, 4),
                        idx, (B, height, width))
    mask = img.new_empty((B, height, width))
    _build.launch(
        _lib(), 'soft_mask_forward', img.data_ptr(), bbox.data_ptr(),
        idx.data_ptr(), mask.data_ptr(), B, F, height, width,
        int(row_start), int(total_height), int(knum),
        _build.pixel_scale(multiplier, width),
        _build.pixel_scale(multiplier, total_height), sigmainv, multiplier,
        4. * multiplier * multiplier, dev, stream)
    soft_mask_forward.launches += 1
    return mask


soft_mask_forward.launches = 0
