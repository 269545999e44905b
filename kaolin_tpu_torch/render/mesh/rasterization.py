"""Differentiable z-buffer rasterization.

Port of ``kaolin_tpu/render/mesh/rasterization.py``. The winner-face
selection runs in ``kaolin_tpu_torch.kernels.rasterize``: the CUDA kernel
for CUDA tensors, the plain PyTorch version for CPU tensors. As in the JAX
package, features that fit the fused route (``14 + 3*D <= 128``) are
interpolated inside the kernel (interp mode); wider ones take the select
mode and a gather epilogue.

Face culling (``valid_faces``) gives culled faces the empty bbox
``(+inf, +inf, -inf, -inf)``, which no pixel is inside.

The analytic backward (``kaolin_tpu_torch.kernels.rasterize_bwd``) gives
the gradients of the image verts and the features; as in the JAX package,
``face_vertices_z`` and ``valid_faces`` get none.
"""

import torch
from torch.autograd.function import once_differentiable

from ...kernels import _build
from ...kernels import rasterize as _k
from ...kernels.rasterize_bwd import rasterize_backward
from ...tracing import span
# the pixel-centre and barycentric helpers live beside the plain versions
# that use them; re-exported here, where the JAX package defines them
from ...kernels.rasterize import _pixel_coords, _barycentric  # noqa: F401

__all__ = ['rasterize']


def _kernel_inputs(face_vertices_z, face_vertices_image, valid_faces,
                   multiplier):
    """The rasterize kernels' face inputs: (z (B,F,3), scaled image verts
    (B,F,6), scaled bboxes (B,F,4)), culled faces with the empty bbox."""
    B, F = face_vertices_image.shape[:2]
    img_scaled = face_vertices_image * multiplier
    bboxes = torch.cat([img_scaled.amin(dim=2), img_scaled.amax(dim=2)],
                       dim=-1)
    if valid_faces is not None:
        # filled on the device: no copy from the host, which would wait
        empty = bboxes.new_full((4,), torch.inf)
        empty[2:] = -torch.inf
        valid = valid_faces.to(bboxes.dtype)[..., None] > 0
        bboxes = torch.where(valid, bboxes, empty)
    return face_vertices_z.contiguous(), img_scaled.reshape(B, F, 6), bboxes


def _rasterize_forward(height, width, multiplier, eps, total_height,
                       face_vertices_z, face_vertices_image, face_features,
                       valid_faces, row_start, bins=None):
    """Returns (features (B,H,W,D), face_idx (B,H,W) int32, weights
    (B,H,W,3)) for rows ``row_start ..`` of a ``total_height`` image.
    ``bins``: the kernels' per-tile face lists, if the caller has them."""
    B, F = face_vertices_image.shape[:2]
    feat_dim = face_features.shape[-1]
    if F == 0:
        # the empty render, as the JAX package gives it (its gathers clamp
        # an index into no faces; PyTorch's raise), and no kernel launch
        dev, dtype = face_vertices_image.device, face_vertices_image.dtype
        return (torch.zeros((B, height, width, feat_dim), dtype=dtype,
                            device=dev),
                torch.full((B, height, width), -1, dtype=torch.int32,
                           device=dev),
                torch.zeros((B, height, width, 3), dtype=dtype, device=dev))
    fz, img_flat, bboxes = _kernel_inputs(face_vertices_z,
                                          face_vertices_image, valid_faces,
                                          multiplier)
    feats_flat = face_features.reshape(B, F, 3 * feat_dim)
    kw = dict(height=height, width=width, total_height=total_height,
              multiplier=multiplier, eps=eps)
    if bins is not None:
        kw['bins'] = bins
    if 14 + 3 * feat_dim <= 128:
        return _k.rasterize_interp(fz, img_flat, bboxes, feats_flat,
                                   row_start, **kw)
    _, face_idx = _k.rasterize_select(fz, img_flat, bboxes, row_start, **kw)
    features, weights = _k.interp_epilogue(
        face_idx, img_flat, feats_flat, row_start, total_height=total_height,
        multiplier=multiplier, eps=eps)
    return features, face_idx, weights


class _Rasterize(torch.autograd.Function):

    @staticmethod
    def forward(ctx, face_vertices_z, face_vertices_image, face_features,
                valid_faces, height, width, multiplier, eps, row_start,
                total_height, bins):
        features, face_idx, weights = _rasterize_forward(
            height, width, multiplier, eps, total_height, face_vertices_z,
            face_vertices_image, face_features, valid_faces, row_start, bins)
        ctx.mark_non_differentiable(face_idx)
        # the culled faces, which own no pixel, for the backward to skip
        valid = (None if valid_faces is None
                 else valid_faces.to(face_vertices_image.dtype) > 0)
        ctx.save_for_backward(face_idx, weights, face_vertices_image,
                              face_features, valid)
        ctx.eps, ctx.row_start, ctx.total_height = eps, row_start, \
            total_height
        return features, face_idx

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_features, grad_face_idx):
        face_idx, weights, face_vertices_image, face_features, valid = \
            ctx.saved_tensors
        B, F = face_vertices_image.shape[:2]
        D = face_features.shape[-1]
        if F == 0:
            return (None, torch.zeros_like(face_vertices_image),
                    torch.zeros_like(face_features)) + (None,) * 8
        grad_img, grad_feat = rasterize_backward(
            grad_features.contiguous(), face_idx, weights,
            face_vertices_image.reshape(B, F, 6),
            face_features.reshape(B, F, 3 * D), ctx.row_start,
            total_height=ctx.total_height, eps=ctx.eps, valid_faces=valid)
        return (None, grad_img.reshape(B, F, 3, 2),
                grad_feat.reshape(B, F, 3, D)) + (None,) * 8


def rasterize(height, width, face_vertices_z, face_vertices_image,
              face_features, valid_faces=None, multiplier=None, eps=None,
              backend='auto', row_start=0, total_height=None):
    r"""Rasterization of triangle meshes with per-vertex-per-face features
    into feature images.

    The device of the inputs picks the route: CUDA tensors run the CUDA
    kernel (float32 only), CPU tensors the plain version (float32 or
    float64). With no faces it returns the empty render and launches
    nothing.

    Args:
        height, width (int): output image size.
        face_vertices_z: (batch_size, num_faces, 3) camera-space z
            (negative forward; the *max* interpolated z wins the z-test).
        face_vertices_image: (batch_size, num_faces, 3, 2) image-plane
            coords in [-1, 1].
        face_features: (batch_size, num_faces, 3, feat_dim) or a
            list/tuple of such (concatenated then re-split).
        valid_faces: optional (batch_size, num_faces) bool mask.
        multiplier (float): coordinate scaling for numerics. Default 1000.
        eps (float): barycentric normalization epsilon. Default 1e-8.
        backend: ``kaolin_tpu``'s choice of route, 'auto', 'xla', 'pallas'
            or 'pallas_interpret'; checked, and otherwise unused: the
            inputs' device picks the route ('pallas' forces nothing on the
            CPU).
        row_start, total_height (int): render rows ``row_start ..
            row_start + height`` of a ``total_height`` x ``width`` image.

    Returns:
        (interpolated_features (B, H, W, feat_dim) — or tuple if
        ``face_features`` was a list — and face_idx (B, H, W) int32,
        -1 where uncovered).
    """
    return _rasterize(height, width, face_vertices_z, face_vertices_image,
                      face_features, valid_faces, multiplier, eps, backend,
                      row_start, total_height)


def _rasterize(height, width, face_vertices_z, face_vertices_image,
               face_features, valid_faces=None, multiplier=None, eps=None,
               backend='auto', row_start=0, total_height=None, bins=None):
    """:func:`rasterize`, on the card over ``bins`` (the per-tile face lists
    of bboxes that hold the faces' own) when given."""
    _build.check_backend('rasterize', backend)
    if multiplier is None:
        multiplier = 1000
    if eps is None:
        eps = 1e-8
    if total_height is None:
        total_height = height
    with span('kaolin.rasterize'):
        is_multi = isinstance(face_features, (list, tuple))
        _face_features = torch.cat(list(face_features), dim=-1) if is_multi \
            else face_features
        image_features, face_idx = _Rasterize.apply(
            face_vertices_z, face_vertices_image, _face_features,
            valid_faces, int(height), int(width), float(multiplier),
            float(eps), int(row_start), int(total_height), bins)
        if is_multi:
            outs = []
            cur = 0
            for f in face_features:
                outs.append(image_features[..., cur:cur + f.shape[-1]])
                cur += f.shape[-1]
            image_features = tuple(outs)
        return image_features, face_idx
