"""Texture sampling, SH lighting and vertex preparation for mesh
rendering. Port of ``kaolin_tpu/render/mesh/utils.py``.

``grid_sample_2d`` and ``texture_mapping`` sample through
``kaolin_tpu_torch.kernels.texture``: the CUDA kernels for CUDA tensors,
the plain versions for CPU tensors. The JAX package's ``backend`` argument
is dropped: the device picks the route, as in ``rasterize``. On CUDA
float32 tensors ``texture_mapping`` hands the UVs to the kernels' UV mode
(``grid_sample_uv``), which converts and clips them in-thread with the
operations of ``_uv_coords`` below, both ways, to the same bits; elsewhere
it runs that composition in PyTorch.

Clipping is ``minimum(maximum(x, lo), hi)`` with tensor bounds, which
gives half the gradient where ``x`` equals a bound, as ``jnp.clip`` does
(``torch.clamp`` gives all of it). On the DIB-R textured path every
uncovered pixel's UV is exactly 0, a bound.
"""

import torch
import torch.nn.functional as F

from .. import camera
from ... import ops
from ...kernels import _build
from ...kernels.texture import grid_sample_coords, grid_sample_uv
from ...tracing import span

__all__ = ['texture_mapping', 'spherical_harmonic_lighting',
           'prepare_vertices', 'grid_sample_2d']


def _balanced(x, ans, other):
    """``lax.max``'s and ``lax.min``'s derivative factor for ``x``: 1 where
    ``x`` gave ``ans``, 1/2 where ``other`` equals it too, 0 elsewhere (a
    NaN ``x`` equals nothing)."""
    half = torch.where(other == ans, 0.5, 1.).to(ans.dtype)
    return torch.where(x == ans, half, torch.zeros_like(half))


class _Clip(torch.autograd.Function):
    """``jnp.clip``, ``min(max(x, lo), hi)``: the cotangent times the min's
    factor, then the max's (:func:`_balanced`), as JAX's VJP multiplies
    them, so a NaN or infinite cotangent stays NaN where a factor is 0."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        m = torch.maximum(x, lo)
        y = torch.minimum(m, hi)
        ctx.save_for_backward(x, lo, hi, m, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, lo, hi, m, y = ctx.saved_tensors
        return (g * _balanced(m, y, hi)) * _balanced(x, m, lo), None, None


def _clip(x, lo, hi):
    """``jnp.clip``'s values and gradients (half the gradient at a tie,
    none at a NaN ``x``). The bounds are filled on ``x``'s device (a
    tensor made from a Python number would be copied from the host, which
    waits for the card)."""
    return _Clip.apply(x, x.new_full((), lo), x.new_full((), hi))


def _sampler_coords(x, y, h_in, w_in):
    """Grid coords ``x``, ``y`` (B, ...) in [-1, 1] to the sampler's (B, P),
    unnormalised (``align_corners=False``) and clipped (border padding)."""
    b = x.shape[0]
    ix = _clip(((x + 1.) * w_in - 1.) / 2., 0., w_in - 1.)
    iy = _clip(((y + 1.) * h_in - 1.) / 2., 0., h_in - 1.)
    return ix.reshape(b, -1), iy.reshape(b, -1)


def _uv_coords(texture_coordinates, h_in, w_in):
    """OpenGL-style UVs (B, ..., 2) to the sampler's coordinates (B, P)."""
    uv = _clip(texture_coordinates.reshape(texture_coordinates.shape[0], -1,
                                           2), 0., 1.)
    uv = uv * 2. - 1.
    return _sampler_coords(uv[..., 0], uv[..., 1] * -1., h_in, w_in)


def _sample(input_maps, x, y, mode):
    """Samples (B, C, h_in, w_in) maps at grid coords ``x``, ``y`` (B, ...)
    in [-1, 1] (``align_corners=False``, border padding); (B, P, C)."""
    return grid_sample_coords(
        input_maps, *_sampler_coords(x, y, *input_maps.shape[2:]), mode)


def grid_sample_2d(input_maps, grid, mode='bilinear', backend='auto'):
    """2D grid sampling, matching ``torch.nn.functional.grid_sample`` with
    ``align_corners=False`` and ``padding_mode='border'``.

    Args:
        input_maps: (batch_size, channels, h_in, w_in).
        grid: (batch_size, h_out, w_out, 2) coords in [-1, 1] (x, y).
        mode: 'bilinear' or 'nearest'.
        backend: ``kaolin_tpu``'s choice of route, 'auto', 'xla', 'pallas'
            or 'pallas_interpret'; checked, and otherwise unused: the
            inputs' device picks the route ('pallas' forces nothing on the
            CPU).

    Returns:
        (batch_size, channels, h_out, w_out).
    """
    _build.check_backend('grid_sample_2d', backend)
    out = _sample(input_maps, grid[..., 0], grid[..., 1], mode)
    return out.transpose(1, 2).reshape(input_maps.shape[:2]
                                       + grid.shape[1:-1])


def texture_mapping(texture_coordinates, texture_maps, mode='nearest'):
    """Samples texture maps at dense or sparse UV coordinates.

    UVs are OpenGL-style in [0, 1] with y bottom-to-top; converted to
    sampler coords internally. On CUDA float32 tensors the sampler's
    kernels do the conversion and its clips in-thread, forward and
    backward (``kernels.texture.grid_sample_uv``): the UVs are read where
    they lie when their last dimension has stride 1 and their points
    flatten with one stride (the rasterizer's view of its feature map, a
    contiguous map), else copied first; the samples and both gradients are
    the bits of the PyTorch composition (``_uv_coords``, then
    ``grid_sample_coords``), which runs on the CPU and in float64.

    Args:
        texture_coordinates: (batch_size, h, w, 2) or (batch_size,
            num_points, 2).
        texture_maps: (batch_size, channels, h', w').
        mode: 'nearest' or 'bilinear'.

    Returns:
        (batch_size, h, w, channels) or (batch_size, num_points, channels).
    """
    with span('kaolin.texture_mapping'):
        batch_size = texture_coordinates.shape[0]
        num_channels = texture_maps.shape[1]
        if texture_maps.is_cuda and texture_coordinates.is_cuda \
                and texture_maps.dtype == texture_coordinates.dtype \
                == torch.float32:
            sampled = grid_sample_uv(texture_maps, texture_coordinates, mode)
        else:
            sampled = grid_sample_coords(
                texture_maps, *_uv_coords(texture_coordinates,
                                          *texture_maps.shape[2:]), mode)
        return sampled.reshape(batch_size, *texture_coordinates.shape[1:-1],
                               num_channels)


def spherical_harmonic_lighting(imnormal, lights):
    """9-band spherical harmonic lighting from per-pixel normals.

    Args:
        imnormal: (batch_size, height, width, 3).
        lights: (batch_size, 9) SH coefficients.

    Returns:
        (batch_size, height, width).
    """
    x = imnormal[..., 0]
    y = imnormal[..., 1]
    z = imnormal[..., 2]
    bands = torch.stack([
        0.28209479177 * torch.ones_like(x),
        0.4886025119 * x,
        0.4886025119 * z,
        0.4886025119 * y,
        1.09254843059 * (x * y),
        1.09254843059 * (y * z),
        0.94617469575 * (z * z) - 0.31539156525,
        0.77254840404 * (x * z),
        0.38627420202 * (x * x - y * y),
    ], dim=3)
    return torch.sum(bands * lights.reshape(-1, 1, 1, 9), dim=3)


def prepare_vertices(vertices, faces, camera_proj, camera_rot=None,
                     camera_trans=None, camera_transform=None):
    """Moves vertices to camera space, projects them, indexes by faces.

    Give either ``camera_rot`` and ``camera_trans`` or ``camera_transform``.

    Returns:
        (face_vertices_camera (B,F,3,3), face_vertices_image (B,F,3,2),
         face_normals (B,F,3) unit).
    """
    with span('kaolin.prepare_vertices'):
        if camera_transform is None:
            if camera_trans is None or camera_rot is None:
                raise ValueError("camera_transform or camera_trans and "
                                 "camera_rot must be defined")
            vertices_camera = camera.rotate_translate_points(
                vertices, camera_rot, camera_trans)
        else:
            if camera_trans is not None or camera_rot is not None:
                raise ValueError("camera_trans and camera_rot must be None "
                                 "when camera_transform is defined")
            padded = F.pad(vertices, (0, 1), value=1.)
            vertices_camera = torch.matmul(padded, camera_transform)
        vertices_image = camera.perspective_camera(vertices_camera,
                                                   camera_proj)
        face_vertices_camera = ops.mesh.index_vertices_by_faces(
            vertices_camera, faces)
        face_vertices_image = ops.mesh.index_vertices_by_faces(
            vertices_image, faces)
        normals = ops.mesh.face_normals(face_vertices_camera, unit=True)
        return face_vertices_camera, face_vertices_image, normals
