"""DefTet volumetric renderer: all ray-face intersections per pixel,
sorted near to far, up to ``knum``.

Port of ``kaolin_tpu/render/mesh/deftet.py``. The selection (the first
``knum`` faces by depth, ``lax.top_k``'s order) runs without gradients in
:func:`kaolin_tpu_torch.kernels.deftet_topk.deftet_topk`: the CUDA kernel
on CUDA tensors, its plain version on CPU tensors. The features are then
interpolated from the selected faces with plain tensor operations (the
reference's Cramer k1/k2/k3 form), and autograd takes their gradient; on
the card the backward of the gathers adds with atomics.
"""

import torch

from ...kernels import _build
from ...kernels.deftet_topk import deftet_topk

__all__ = ['deftet_sparse_render']


def _select_topk(pixel_coords, render_ranges, face_vertices_z,
                 face_vertices_image, valid_mask, knum, eps):
    """Per-pixel top-``knum`` face ids by descending depth, -1 in empty
    slots (no gradient)."""
    with torch.no_grad():
        return deftet_topk(pixel_coords.detach(), render_ranges.detach(),
                           face_vertices_z.detach(),
                           face_vertices_image.detach(), valid_mask,
                           int(knum), float(eps))


class _NoFaces(torch.autograd.Function):
    """The features of no faces: zeros of ``shape`` and zero gradients to
    ``inputs`` (those the interpolation differentiates)."""

    @staticmethod
    def forward(ctx, shape, *inputs):
        ctx.shapes = [(x.shape, x.dtype, x.device) for x in inputs]
        return inputs[-1].new_zeros(shape)

    @staticmethod
    def backward(ctx, grad):
        return (None,) + tuple(torch.zeros(s, dtype=t, device=d)
                               for s, t, d in ctx.shapes)


def deftet_sparse_render(pixel_coords, render_ranges, face_vertices_z,
                         face_vertices_image, face_features, knum=300,
                         valid_faces=None, eps=1e-8, tie_exact=False,
                         backend=None):
    r"""Renders all ray-face intersections per pixel sorted by depth.

    Reference: ``kaolin/render/mesh/deftet.py:338`` (the top-``knum``-by-
    depth semantics of its naive test anchor).

    Args:
        pixel_coords: (batch_size, num_pixels, 2) image coords in [-1, 1].
        render_ranges: (batch_size, num_pixels, 2) (min_depth, max_depth),
            typically [-inf, 0] for camera-space z.
        face_vertices_z: (batch_size, num_faces, 3) camera-space z
            (negative forward, nearest = greatest).
        face_vertices_image: (batch_size, num_faces, 3, 2).
        face_features: (batch_size, num_faces, 3, feat_dim) or a list of
            such tensors.
        knum (int): max faces per pixel.
        valid_faces: optional (batch_size, num_faces) bool.
        eps: barycentric normalization epsilon.
        tie_exact (bool): accepted for ``kaolin_tpu``'s signature; the
            port's selection always takes ``lax.top_k``'s lowest-id rule
            on tied depths.
        backend: ``kaolin_tpu``'s choice of route, None, 'xla', 'pallas'
            or 'pallas_interpret'; checked, and otherwise unused: the
            inputs' device picks the route ('pallas' forces nothing on the
            CPU).

    Returns:
        (interpolated_features (B, P, knum, feat_dim) -- or a tuple -- and
        face_idx (B, P, knum) int32, -1 for empty slots). With no faces,
        every slot is empty, the features 0 and no kernel is launched.
    """
    _build.check_backend('deftet_sparse_render', backend,
                         (None, 'xla', 'pallas', 'pallas_interpret'))
    is_multi = isinstance(face_features, (list, tuple))
    _face_features = torch.cat(list(face_features), dim=-1) if is_multi \
        else face_features
    B, P, _ = pixel_coords.shape
    F = face_vertices_z.shape[1]
    D = _face_features.shape[-1]
    if valid_faces is None:
        valid_mask = torch.ones((B, F), dtype=torch.bool,
                                device=pixel_coords.device)
    else:
        valid_mask = valid_faces.to(torch.bool)

    if F == 0:
        sel = torch.full((B, P, int(knum)), -1, dtype=torch.int32,
                         device=pixel_coords.device)
        out = _NoFaces.apply((B, P, int(knum), D), pixel_coords,
                             face_vertices_image, _face_features)
        return _split(out, face_features, is_multi), sel

    sel = _select_topk(pixel_coords, render_ranges, face_vertices_z,
                       face_vertices_image, valid_mask, knum, eps)
    knum = sel.shape[-1]

    # differentiable interpolation on the selected faces
    # (kaolin/render/mesh/deftet.py:203-257, the k1/k2/k3 form)
    covered = sel >= 0
    safe = sel.clamp(min=0).reshape(B, -1).to(torch.int64)   # (B, P*knum)
    img_flat = face_vertices_image.reshape(B, F, 6)
    g = torch.gather(img_flat, 1, safe[..., None].expand(-1, -1, 6)
                     ).reshape(B, P, knum, 6)
    ax, ay = g[..., 0], g[..., 1]
    m = g[..., 2] - g[..., 0]
    p = g[..., 3] - g[..., 1]
    n = g[..., 4] - g[..., 0]
    q = g[..., 5] - g[..., 1]
    k3 = m * q - n * p
    s = pixel_coords[:, :, None, 0] - ax
    t = pixel_coords[:, :, None, 1] - ay
    k1 = s * q - n * t
    k2 = m * t - s * p
    norm_eps = eps * torch.sign(k3)
    w1 = k1 / (k3 + norm_eps)
    w2 = k2 / (k3 + norm_eps)
    w0 = 1. - w1 - w2
    weights = torch.stack([w0, w1, w2], dim=-1)             # (B, P, knum, 3)
    feat = torch.gather(_face_features.reshape(B, F, 3 * D), 1,
                        safe[..., None].expand(-1, -1, 3 * D)
                        ).reshape(B, P, knum, 3, D)
    out = torch.sum(feat * weights[..., None], dim=-2)
    out = torch.where(covered[..., None], out, torch.zeros((), dtype=out.dtype,
                                                           device=out.device))
    return _split(out, face_features, is_multi), sel


def _split(out, face_features, is_multi):
    """``out`` split back into the widths of a list of features."""
    if not is_multi:
        return out
    outs = []
    cur = 0
    for f in face_features:
        outs.append(out[..., cur:cur + f.shape[-1]])
        cur += f.shape[-1]
    return tuple(outs)
