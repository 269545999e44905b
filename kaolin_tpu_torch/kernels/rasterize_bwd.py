"""Rasterization backward: the CUDA kernel of ``csrc/rasterize_bwd.cu`` and
its plain PyTorch version.

Port of ``rasterize_backward_pallas`` (``kaolin_tpu/kernels/rasterize_bwd.py``).
The wrapper follows its inputs: on CUDA tensors it launches the kernel
(float32 only) and counts the launch in ``rasterize_backward.launches``; on
CPU tensors it runs the plain version, which mirrors the JAX package's XLA
backward (``_rasterize_bwd`` of ``kaolin_tpu/render/mesh/rasterization.py``):
per covered pixel, the closed-form (Cramer) derivative of the barycentric
weights with respect to the winner's 6 image coordinates, chained with the
feature deltas, and ``w_i * g`` for its features, summed per face. The
Pallas kernel's ``k1 = bw*k3`` rewrite is not carried over.

Both take any feature width ``D``; the JAX package's Pallas backward takes
``7 + 3*D <= 128`` only.
"""

import ctypes

import torch

from . import _build
from .rasterize import _is_cuda

__all__ = ['rasterize_backward', 'rasterize_backward_plain']

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    'rasterize_backward': [_P] * 8 + [_I] * 7 + [_F, _I, _P],
}


def rasterize_backward_plain(grad_features, face_idx, weights,
                             face_vertices_image_flat, face_features_flat,
                             eps):
    """Plain version of :func:`rasterize_backward`, over the covered
    pixels; per-face sums with ``index_add_``."""
    img, feats = face_vertices_image_flat, face_features_flat
    B, F, _ = img.shape
    D = feats.shape[-1] // 3
    seg, grad_img_pix, grad_feat_pix = _pixel_terms(
        grad_features, face_idx, weights, img, feats, eps)
    grad_img = img.new_zeros((B * F, 6)).index_add_(0, seg, grad_img_pix)
    grad_feat = feats.new_zeros((B * F, 3 * D)).index_add_(
        0, seg, grad_feat_pix)
    return grad_img.reshape(B, F, 6), grad_feat.reshape(B, F, 3 * D)


def _pixel_terms(grad_features, face_idx, weights, img, feats, eps):
    """Each covered pixel's terms, in (batch, pixel) order: (its face's
    row b * F + f of the flat gradients, (N, 6) image-vert terms, (N, 3D)
    feature terms)."""
    B, F, _ = img.shape
    D = feats.shape[-1] // 3
    b, pix = (face_idx.reshape(B, -1) >= 0).nonzero(as_tuple=True)
    seg = b * F + face_idx.reshape(B, -1)[b, pix].long()
    g = grad_features.reshape(B, -1, D)[b, pix]                  # (N, D)
    aw, bw, cw = weights.reshape(B, -1, 3)[b, pix].unbind(-1)
    ax, ay, bx, by, cx, cy = img.reshape(B * F, 6)[seg].unbind(-1)
    c0, c1, c2 = feats.reshape(B * F, 3, D)[seg].unbind(1)      # (N, D)

    x0 = aw * ax + bw * bx + cw * cx
    y0 = aw * ay + bw * by + cw * cy
    m = bx - ax
    p = by - ay
    n = cx - ax
    q = cy - ay
    s = x0 - ax
    t = y0 - ay
    k1 = s * q - n * t
    k2 = m * t - s * p
    k3 = m * q - n * p
    k3 = k3 + torch.copysign(k3.new_tensor(eps), k3)

    zero = torch.zeros_like(k1)
    # dk1/d{m,n,p,q,s,t} = 0, -t, 0, s, q, -n; dk2/d{..} = t, 0, -s, 0,
    # -p, m; dk3/d{m,n,p,q} = q, -p, -n, m
    dw1dm = zero * k3 - q * k1
    dw1dn = -t * k3 - -p * k1
    dw1dp = zero * k3 - -n * k1
    dw1dq = s * k3 - m * k1
    dw1ds = q * k3
    dw1dt = -n * k3
    dw2dm = t * k3 - q * k2
    dw2dn = zero * k3 - -p * k2
    dw2dp = -s * k3 - -n * k2
    dw2dq = zero * k3 - m * k2
    dw2ds = -p * k3
    dw2dt = m * k3
    dw1dax = -(dw1dm + dw1dn + dw1ds)
    dw1day = -(dw1dp + dw1dq + dw1dt)
    dw2dax = -(dw2dm + dw2dn + dw2ds)
    dw2day = -(dw2dp + dw2dq + dw2dt)

    g1 = (g * (c1 - c0)).sum(-1) / (k3 * k3)
    g2 = (g * (c2 - c0)).sum(-1) / (k3 * k3)
    grad_img_pix = torch.stack([
        g1 * dw1dax + g2 * dw2dax,
        g1 * dw1day + g2 * dw2day,
        g1 * dw1dm + g2 * dw2dm,
        g1 * dw1dp + g2 * dw2dp,
        g1 * dw1dn + g2 * dw2dn,
        g1 * dw1dq + g2 * dw2dq,
    ], dim=-1)
    grad_feat_pix = torch.stack([aw, bw, cw], -1)[..., None] * g[:, None]
    return seg, grad_img_pix, grad_feat_pix.reshape(-1, 3 * D)


def _lib():
    return _build.load('rasterize_bwd', _SIGNATURES)


def rasterize_backward(grad_features, face_idx, weights,
                       face_vertices_image_flat, face_features_flat,
                       row_start=0, *, total_height=None, eps,
                       valid_faces=None):
    """Gradients of rasterization with respect to the image verts and the
    features.

    Args:
        grad_features: (B, H, W, D) cotangent of the features.
        face_idx: (B, H, W) int32 winner faces, -1 where uncovered.
        weights: (B, H, W, 3) the forward's barycentric weights.
        face_vertices_image_flat: (B, F, 6) UNSCALED image verts.
        face_features_flat: (B, F, 3*D) vertex-major features.
        row_start, total_height: the rows of a taller image, as in the
            forward; the kernel uses them only to find each face's pixels
            from its bbox.
        eps: the forward's barycentric epsilon.
        valid_faces: optional (B, F) bool, the forward's culling; the
            kernel skips the culled faces, which own no pixel.

    Returns:
        (grad image verts (B, F, 6), grad features (B, F, 3*D)).
    """
    _, H, W, _ = grad_features.shape
    if total_height is None:
        total_height = H
    if not _is_cuda(grad_features):
        return rasterize_backward_plain(
            grad_features, face_idx, weights, face_vertices_image_flat,
            face_features_flat, eps)
    (grad, wts, img, feat), (idx,), dev, stream = _build.cuda_inputs(
        'rasterize_backward', (grad_features, weights,
                               face_vertices_image_flat, face_features_flat),
        (face_idx,))
    B, F, _ = img.shape
    D = feat.shape[-1] // 3
    _build.check_shapes('rasterize_backward', grad, (B, H, W, D),
                        idx, (B, H, W), wts, (B, H, W, 3), img, (B, F, 6),
                        feat, (B, F, 3 * D))
    grad_img = img.new_empty((B, F, 6))
    grad_feat = img.new_empty((B, F, 3 * D))
    if B * F == 0:
        return grad_img, grad_feat
    valid = None
    if valid_faces is not None:
        valid = torch.broadcast_to(valid_faces, (B, F)).to(
            device=img.device, dtype=torch.uint8).contiguous()
    _build.launch(
        _lib(), 'rasterize_backward', grad.data_ptr(), idx.data_ptr(),
        wts.data_ptr(), img.data_ptr(), feat.data_ptr(),
        None if valid is None else valid.data_ptr(), grad_img.data_ptr(),
        grad_feat.data_ptr(), B, F, H, W, D, int(row_start),
        int(total_height), eps, dev, stream)
    rasterize_backward.launches += 1
    return grad_img, grad_feat


rasterize_backward.launches = 0
