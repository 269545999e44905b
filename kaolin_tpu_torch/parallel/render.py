"""Sharded rendering: pixel rows x data batch over a mesh of ranks.

Port of ``kaolin_tpu/parallel/render.py``. Every rank holds the whole
face tensors, as a JAX caller passes whole arrays. A rank takes the batch
slice of its 'data' coordinate and renders the slab of rows of its 'pix'
coordinate through the port's :func:`rasterize` /
:func:`dibr_rasterization`, whose kernels take ``row_start`` and
``total_height``; it returns its own block (batch slice x row slab). The
forward exchanges nothing. The face tensors pass through
:func:`kaolin_tpu_torch.parallel.mesh.replicate`, so that backward every
rank's gradient holds the 'pix' partials and the disjoint 'data' slices:
the one-process gradient.
"""

from ..render.mesh.dibr import dibr_rasterization
from ..render.mesh.rasterization import rasterize
from ..tracing import span
from .mesh import axis, replicate

__all__ = ['sharded_rasterize', 'sharded_dibr_rasterization']


def _block(mesh, height, tensors):
    """(row_start, local_h, this rank's batch slices of ``tensors``, each
    passed through ``replicate`` first)."""
    ndata, di = axis(mesh, 'data')
    npix, pi = axis(mesh, 'pix')
    assert height % (npix * 8) == 0, (height, npix)
    local_h = height // npix
    batch = tensors[0].shape[0]
    assert batch % ndata == 0, (batch, ndata)
    local_b = batch // ndata
    rows = slice(di * local_b, (di + 1) * local_b)
    return pi * local_h, local_h, [None if t is None else t[rows]
                                   for t in replicate(mesh, *tensors)]


def sharded_rasterize(mesh, height, width, face_vertices_z,
                      face_vertices_image, face_features, valid_faces=None,
                      multiplier=None, eps=None, backend='auto'):
    """:func:`kaolin_tpu_torch.render.mesh.rasterize` over a ('data', 'pix')
    mesh.

    The batch is split over 'data'; each rank on 'pix' rasterizes its
    horizontal slab of rows (``height`` must divide by 8 times the 'pix'
    size). Differentiable: every rank's gradient to the face tensors is the
    one-process gradient of the loss that every rank computes from all
    blocks (see :func:`kaolin_tpu_torch.parallel.mesh.mesh_sum`).

    Returns this rank's block of ``rasterize``'s (features, face_idx):
    (B / data, height / pix, width, ...).
    """
    with span('kaolin.sharded_rasterize'):
        multi = isinstance(face_features, (list, tuple))
        feats = list(face_features) if multi else [face_features]
        row_start, local_h, (fvz, fvi, valid, *ff) = _block(
            mesh, height, (face_vertices_z, face_vertices_image, valid_faces,
                           *feats))
        ff = type(face_features)(ff) if multi else ff[0]
        return rasterize(local_h, width, fvz, fvi, ff, valid, multiplier,
                         eps, backend, row_start=row_start,
                         total_height=height)


def sharded_dibr_rasterization(mesh, height, width, face_vertices_z,
                               face_vertices_image, face_features,
                               face_normals_z, sigmainv=7000, boxlen=0.02,
                               knum=30, multiplier=None, eps=None,
                               rast_backend='auto', mask_backend='auto'):
    """:func:`kaolin_tpu_torch.render.mesh.dibr_rasterization` over a
    ('data', 'pix') mesh; see :func:`sharded_rasterize`.

    Returns this rank's block of (interpolated_features, soft_mask,
    face_idx).
    """
    row_start, local_h, (fvz, fvi, ff, fnz) = _block(
        mesh, height, (face_vertices_z, face_vertices_image, face_features,
                       face_normals_z))
    return dibr_rasterization(
        local_h, width, fvz, fvi, ff, fnz, sigmainv, boxlen, knum,
        multiplier, eps, rast_backend, row_start=row_start,
        total_height=height, mask_backend=mask_backend)
