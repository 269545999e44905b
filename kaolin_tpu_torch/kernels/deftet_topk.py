"""DefTet's per-pixel top-``knum`` face selection: the CUDA kernel of
``csrc/deftet_topk.cu`` and its plain PyTorch version.

Port of ``kaolin_tpu/kernels/deftet_topk.py``: ``deftet_topk`` replaces
``deftet_topk_pallas``. The wrapper follows its inputs: on CUDA tensors it
launches the kernel (float32 only) and counts the launch in its
``launches`` attribute; on CPU tensors it runs :func:`deftet_topk_plain`,
which follows the JAX package's XLA path (``_select_topk`` of
``kaolin_tpu/render/mesh/deftet.py``) and takes float32 or float64.

Both score a (pixel, face) pair with the XLA path's operations in their
order, and both rank as ``lax.top_k`` does: by depth descending in the
float's total order (``+0.0`` above ``-0.0``), then by face id ascending.
Any ``knum`` works, ``knum > num_faces`` included; the Pallas kernel's
limit of 64 does not apply.

On the card one call launches three kernels: one forms each face's record
(bbox, image coords, z), one scans the faces in contiguous ranges, each
(pixel, range) keeping its own sorted list of 64-bit keys (the depth's
total-order key above the complemented face id), and one merges each
pixel's lists into its first ``knum`` ids. ``csrc/deftet_topk.cu`` picks
the ranges and sizes the scratch they take.
"""

import ctypes

import torch

from . import _build
from .rasterize import _is_cuda

__all__ = ['deftet_topk', 'deftet_topk_plain', 'face_bboxes']

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    'deftet_topk_scratch': [_I] * 4 + [_P],
    'deftet_topk_forward': [_P] * 7 + [_I] * 4 + [_F, _I, _P],
}
# elements per (B, pixels, faces) score block of the plain version
_PLAIN_BUDGET = 1 << 24


def face_bboxes(face_vertices_image, valid_mask):
    """(B, F, 4) (xmin, ymin, xmax, ymax) of each face's image coords, with
    ``xmin = +inf`` on invalid faces so that no pixel passes their bbox
    test (``px >= +inf`` holds only at ``+inf``, which fails ``px <
    xmax``)."""
    fmin = face_vertices_image.amin(dim=2)
    fmax = face_vertices_image.amax(dim=2)
    xmin = torch.where(valid_mask, fmin[..., 0], float('inf'))
    return torch.stack([xmin, fmin[..., 1], fmax[..., 0], fmax[..., 1]], -1)


def _order_key(x):
    """Integers that order ``x`` as the float's total order does."""
    if x.dtype == torch.float64:
        bits = x.view(torch.int64)
        return torch.where(bits >= 0, bits, bits ^ 0x7fffffffffffffff)
    bits = x.view(torch.int32)
    return torch.where(bits >= 0, bits, bits ^ 0x7fffffff)


def _scores(pc, rr, z, img, bbox, eps):
    """(B, p, F) depths of the pairs that pass every test, -inf
    elsewhere: the XLA path's ``score``."""
    px = pc[..., 0][:, :, None]
    py = pc[..., 1][:, :, None]
    in_bbox = ((px >= bbox[:, None, :, 0]) & (px < bbox[:, None, :, 2])
               & (py >= bbox[:, None, :, 1]) & (py < bbox[:, None, :, 3]))
    ax = img[:, None, :, 0] - px
    ay = img[:, None, :, 1] - py
    bx = img[:, None, :, 2] - px
    by = img[:, None, :, 3] - py
    cx = img[:, None, :, 4] - px
    cy = img[:, None, :, 5] - py
    w0 = bx * cy - by * cx
    w1 = cx * ay - cy * ax
    w2 = ax * by - ay * bx
    norm = (w0 + w1) + w2
    norm = norm + eps * torch.sign(norm)
    w0, w1, w2 = w0 / norm, w1 / norm, w2 / norm
    inside = (w0 >= 0.) & (w1 >= 0.) & (w2 >= 0.)
    depth = ((w0 * z[:, None, :, 0] + w1 * z[:, None, :, 1])
             + w2 * z[:, None, :, 2])
    in_range = ((depth > rr[..., 0][:, :, None])
                & (depth < rr[..., 1][:, :, None]))
    return torch.where(in_bbox & inside & in_range, depth,
                       torch.tensor(float('-inf'), dtype=depth.dtype,
                                    device=depth.device))


def deftet_topk_plain(pixel_coords, render_ranges, face_vertices_z,
                      face_vertices_image, valid_mask, knum, eps):
    """Plain version of :func:`deftet_topk`: the scores of every pair, in
    pixel blocks that bound its memory, then a stable descending sort on
    the scores' total-order keys (``torch.topk`` promises no order among
    equal values)."""
    B, P, _ = pixel_coords.shape
    F = face_vertices_z.shape[1]
    dev = pixel_coords.device
    img = face_vertices_image.reshape(B, F, 6)
    bbox = face_bboxes(face_vertices_image, valid_mask)
    out = torch.full((B, P, knum), -1, dtype=torch.int32, device=dev)
    take = min(knum, F)
    if take <= 0:
        return out
    miss = _order_key(torch.tensor(float('-inf'),
                                   dtype=face_vertices_z.dtype, device=dev))
    rows = max(1, _PLAIN_BUDGET // max(1, B * F))
    for p0 in range(0, P, rows):
        score = _scores(pixel_coords[:, p0:p0 + rows],
                        render_ranges[:, p0:p0 + rows], face_vertices_z,
                        img, bbox, eps)
        key, order = torch.sort(_order_key(score), dim=-1, descending=True,
                                stable=True)
        key, order = key[..., :take], order[..., :take]
        out[:, p0:p0 + rows, :take] = torch.where(
            key > miss, order, -1).to(torch.int32)
    return out


def _lib():
    return _build.load('deftet_topk', _SIGNATURES)


def deftet_topk(pixel_coords, render_ranges, face_vertices_z,
                face_vertices_image, valid_mask, knum, eps):
    """Per pixel, the ids of the first ``knum`` faces by (depth desc, id
    asc) among those whose half-open bbox holds the pixel, whose
    barycentric inside test holds and whose depth lies in the pixel's open
    render range.

    Args:
        pixel_coords: (B, P, 2).
        render_ranges: (B, P, 2) (min, max) depth.
        face_vertices_z: (B, F, 3).
        face_vertices_image: (B, F, 3, 2).
        valid_mask: (B, F) bool.
        knum (int): faces kept per pixel.
        eps (float): the barycentric normalisation's epsilon.

    Returns:
        (B, P, knum) int32 face ids, -1 in empty slots.
    """
    B, P, _ = pixel_coords.shape
    F = face_vertices_z.shape[1]
    _build.check_shapes('deftet_topk', pixel_coords, (B, P, 2),
                        render_ranges, (B, P, 2), face_vertices_z, (B, F, 3),
                        face_vertices_image, (B, F, 3, 2), valid_mask,
                        (B, F))
    knum = int(knum)
    if not _is_cuda(pixel_coords):
        return deftet_topk_plain(pixel_coords, render_ranges,
                                 face_vertices_z, face_vertices_image,
                                 valid_mask, knum, eps)
    if valid_mask.device != pixel_coords.device:
        raise ValueError(f'deftet_topk: valid_mask on {valid_mask.device}, '
                         f'pixel_coords on {pixel_coords.device}')
    if valid_mask.dtype != torch.bool:
        raise TypeError(f'deftet_topk: valid_mask must be bool, got '
                        f'{valid_mask.dtype}')
    (pc, rr, z, img), _, dev, stream = _build.cuda_inputs(
        'deftet_topk', (pixel_coords, render_ranges, face_vertices_z,
                        face_vertices_image.reshape(B, F, 6)))
    out = torch.empty((B, P, knum), dtype=torch.int32, device=pc.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    nbytes = ctypes.c_longlong()
    _build.launch(lib, 'deftet_topk_scratch', B, P, F, knum,
                  ctypes.addressof(nbytes))
    scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=pc.device)
    _build.launch(lib, 'deftet_topk_forward', pc.data_ptr(), rr.data_ptr(),
                  z.data_ptr(), img.data_ptr(),
                  valid_mask.contiguous().data_ptr(), scratch.data_ptr(),
                  out.data_ptr(), B, P, F, knum, ctypes.c_float(eps), dev,
                  stream)
    deftet_topk.launches += 1
    return out


deftet_topk.launches = 0
