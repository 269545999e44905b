"""DIB-R soft silhouette and the full rasterization pipeline.

Port of ``kaolin_tpu/render/mesh/dibr.py``. The soft mask runs in
``kaolin_tpu_torch.kernels.soft_mask``: the CUDA kernel for CUDA tensors,
the plain PyTorch version for CPU tensors. Both keep the first ``knum``
bbox hits in original face order, which is the JAX package's order-exact
XLA path; so the JAX side's ``knum_exact`` switch and its host probe of
whether ``knum`` binds have nothing to choose here. ``knum_exact`` is
accepted and changes nothing.

The analytic backward (``soft_mask_backward``, beside the forward) gives
the gradient of the image verts. When that gradient is needed, the forward
also returns the cut (which faces each pixel recorded) and saves it with
its scaled inputs.

On the card both forward kernels walk per-tile face lists
(``kernels.rasterize.tile_bins``). ``dibr_rasterization`` makes them once,
from the soft mask's enlarged bboxes, which hold the rasterizer's, and
passes them to both.
"""

import torch
from torch.autograd.function import once_differentiable

from ...kernels import _build
from ...kernels.rasterize import tile_bins
from ...kernels.soft_mask import soft_mask_backward, soft_mask_forward
from ...tracing import span
from .rasterization import _rasterize

__all__ = ['dibr_soft_mask', 'dibr_rasterization']


def _scaled_inputs(face_vertices_image, boxlen, multiplier):
    """(B, F, 6) scaled verts and their (B, F, 4) bboxes enlarged by
    ``boxlen * multiplier``."""
    img_scaled = face_vertices_image * multiplier
    margin = boxlen * multiplier
    bboxes = torch.cat([img_scaled.amin(dim=-2) - margin,
                        img_scaled.amax(dim=-2) + margin], dim=-1)
    B, F = img_scaled.shape[:2]
    return img_scaled.reshape(B, F, 6), bboxes


class _DibrSoftMask(torch.autograd.Function):

    @staticmethod
    def forward(ctx, face_vertices_image, selected_face_idx, sigmainv,
                boxlen, knum, multiplier, row_start, total_height, prepared):
        # prepared: the scaled inputs and their per-tile lists, made by
        # dibr_rasterization for both kernels, or None
        img_scaled, bboxes, bins = prepared or (
            *_scaled_inputs(face_vertices_image, boxlen, multiplier), None)
        B, H, W = selected_face_idx.shape
        ctx.shape = face_vertices_image.shape
        if face_vertices_image.shape[1] == 0:
            # no face: every pixel uncovered, with no bbox hit
            return face_vertices_image.new_zeros((B, H, W))
        face_idx = selected_face_idx.to(torch.int32)
        kw = dict(row_start=row_start, height=H, width=W,
                  total_height=total_height, sigmainv=sigmainv,
                  multiplier=multiplier)
        fkw = dict(kw, knum=knum, **({} if bins is None else {'bins': bins}))
        if not ctx.needs_input_grad[0]:
            return soft_mask_forward(img_scaled, bboxes, face_idx, **fkw)
        mask, cut = soft_mask_forward(img_scaled, bboxes, face_idx,
                                      return_cut=True, **fkw)
        ctx.save_for_backward(img_scaled, bboxes, cut, mask)
        ctx.kw = kw
        return mask

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_soft_mask):
        if ctx.shape[1] == 0:
            return (grad_soft_mask.new_zeros(ctx.shape),) + (None,) * 8
        grad = soft_mask_backward(*ctx.saved_tensors,
                                  grad_soft_mask.contiguous(), **ctx.kw)
        return (grad.reshape(ctx.shape),) + (None,) * 8


def dibr_soft_mask(face_vertices_image, selected_face_idx, sigmainv=7000,
                   boxlen=0.02, knum=30, multiplier=1000., row_start=0,
                   total_height=None, backend='auto', knum_exact=False):
    r"""Soft silhouette mask for DIB-R silhouette losses.

    Per uncovered pixel, the first ``knum`` faces (in face order) whose bbox
    enlarged by ``boxlen`` contains the pixel contribute
    ``p = exp(-sigmainv * d^2 / m^2)`` with ``d^2`` the min of 6 squared
    pixel-face distances; the mask is ``1 - prod(1 - p)``. Covered pixels
    are 1. With no faces the mask is 0 and no kernel is launched.

    Args:
        face_vertices_image: (B, F, 3, 2) image-plane verts in [-1, 1].
        selected_face_idx: (B, H, W) int, from :func:`rasterize`.
        sigmainv, boxlen, knum, multiplier: as in the reference.
        row_start, total_height: the rows of a taller image, as in
            :func:`rasterize`.
        backend: ``kaolin_tpu``'s choice of route, 'auto', 'xla', 'pallas'
            or 'pallas_interpret'; checked, and otherwise unused: the
            inputs' device picks the route ('pallas' forces nothing on the
            CPU).
        knum_exact (bool): accepted for the JAX package's signature; the
            port is always order-exact.

    Returns:
        (B, H, W) soft mask.
    """
    del knum_exact
    return _dibr_soft_mask(face_vertices_image, selected_face_idx, sigmainv,
                           boxlen, knum, multiplier, row_start, total_height,
                           backend)


def _dibr_soft_mask(face_vertices_image, selected_face_idx, sigmainv, boxlen,
                    knum, multiplier, row_start, total_height, backend,
                    prepared=None):
    _build.check_backend('dibr_soft_mask', backend)
    if total_height is None:
        total_height = selected_face_idx.shape[1]
    with span('kaolin.dibr_soft_mask'):
        return _DibrSoftMask.apply(
            face_vertices_image, selected_face_idx, float(sigmainv),
            float(boxlen), int(knum), float(multiplier), int(row_start),
            int(total_height), prepared)


def dibr_rasterization(height, width, face_vertices_z, face_vertices_image,
                       face_features, face_normals_z, sigmainv=7000,
                       boxlen=0.02, knum=30, multiplier=None, eps=None,
                       rast_backend='auto', row_start=0, total_height=None,
                       mask_backend='auto', knum_exact=False):
    r"""Full DIB-R pipeline: rasterize (with normal-z face culling) plus the
    soft silhouette mask.

    ``rast_backend`` and ``mask_backend`` are the ``backend`` of
    :func:`rasterize` and :func:`dibr_soft_mask`: checked, and otherwise
    unused, since the inputs' device picks the route.

    Returns:
        (interpolated_features, soft_mask, face_idx).
    """
    del knum_exact
    _multiplier = 1000. if multiplier is None else float(multiplier)
    with span('kaolin.dibr_rasterization'):
        prepared = None
        if (face_vertices_image.is_cuda and face_vertices_image.shape[1] > 0
                and boxlen * _multiplier >= 0.):
            # the enlarged bboxes hold the rasterizer's (the same scaled
            # verts, a margin >= 0): one binning serves both kernels
            with torch.no_grad():
                img_scaled, bboxes = _scaled_inputs(
                    face_vertices_image.detach(), float(boxlen), _multiplier)
            prepared = (img_scaled, bboxes, tile_bins(
                bboxes, row_start, height=height, width=width,
                total_height=total_height, multiplier=_multiplier))
        interpolated_features, face_idx = _rasterize(
            height, width, face_vertices_z, face_vertices_image,
            face_features, face_normals_z >= 0., multiplier, eps,
            rast_backend, row_start=row_start, total_height=total_height,
            bins=prepared and prepared[2])
        soft_mask = _dibr_soft_mask(face_vertices_image, face_idx, sigmainv,
                                    boxlen, knum, _multiplier, row_start,
                                    total_height, mask_backend, prepared)
        return interpolated_features, soft_mask, face_idx
