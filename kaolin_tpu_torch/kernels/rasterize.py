"""Z-buffer rasterization: the CUDA kernel of ``csrc/rasterize.cu`` and its
plain PyTorch version.

Port of ``kaolin_tpu/kernels/rasterize.py``: ``rasterize_interp`` replaces
``rasterize_interp_pallas`` and ``rasterize_select`` replaces
``rasterize_select_pallas``; both are modes of one CUDA kernel. Each
wrapper follows its inputs: on CUDA tensors it launches the kernel (float32
only) and counts the launch in its ``launches`` attribute; on CPU tensors
it runs the plain version, which mirrors the JAX package's XLA path
(``_select_faces_xla`` and the gather epilogue of
``kaolin_tpu/render/mesh/rasterization.py``) and takes float32 or float64.

On the card both modes walk per-tile face lists: for every 16x16 tile of
pixels, the faces whose bbox overlaps the tile's pixel-centre rectangle, a
bit a face, from a binning pass (:func:`tile_bins`, another entry point of
``csrc/rasterize.cu``). ``dibr_rasterization`` bins the soft mask's
enlarged bboxes once and passes the lists to both kernels (``bins``);
lists of bboxes that hold the kernel's own give the same result.

Inputs, as the TPU kernels take them: ``face_vertices_z`` (B, F, 3),
``face_vertices_image_flat`` (B, F, 6) scaled by ``multiplier``,
``face_bboxes`` (B, F, 4) scaled (xmin, ymin, xmax, ymax), culled faces
carrying the empty bbox (+inf, +inf, -inf, -inf), and for interp
``face_features_flat`` (B, F, 3*D) vertex-major. The image is rows
``row_start .. row_start + height`` of a ``total_height`` x ``width``
image.
"""

import ctypes

import torch

from . import _build

__all__ = ['rasterize_interp', 'rasterize_select', 'rasterize_interp_plain',
           'rasterize_select_plain', 'tile_bins', 'tile_bins_plain']

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    'rasterize_interp': ([_P] * 5 + [_I] + [_P] * 3 + [_I] * 7 + [_F] * 3
                         + [_I, _P]),
    'rasterize_select': ([_P] * 4 + [_I] + [_P] * 2 + [_I] * 6 + [_F] * 3
                         + [_I, _P]),
    'tile_bins': [_P] * 2 + [_I] * 6 + [_F] * 2 + [_I, _P],
}
# the lists' layout (csrc/tile_lists.cuh): pixels a side of a tile, face
# ids a slot (a tile's faces are cut into slots of CHUNK consecutive ids)
TILE, CHUNK = 16, 1024
# elements per (chunk, B, H, W) intermediate of the plain version
_PLAIN_BUDGET = 1 << 25


def _pixel_coords(height, width, multiplier, dtype, row_start=0,
                  total_height=None, device=None):
    """Pixel-centre coordinates, y-up, scaled by ``multiplier``:
    ``x0 = m/W*(2wx+1-W)``, ``y0 = m/H*(H-2hy-1)``, with ``m/W`` formed in
    double and rounded to ``dtype`` as the JAX package does."""
    if total_height is None:
        total_height = height
    wx = torch.arange(width, dtype=dtype, device=device)
    hy = row_start + torch.arange(height, dtype=dtype, device=device)
    sx = torch.tensor(multiplier / width, dtype=dtype, device=device)
    sy = torch.tensor(multiplier / total_height, dtype=dtype, device=device)
    x0 = sx * (2. * wx + 1. - width)
    y0 = sy * (total_height - 2. * hy - 1.)
    return x0, y0


def _barycentric(px, py, img, eps):
    """Edge-function barycentrics with signed-eps normalization.

    ``img``: (..., 6) = (ax, ay, bx, by, cx, cy); ``px``/``py`` broadcast
    against its leading dims."""
    ax = img[..., 0] - px
    ay = img[..., 1] - py
    bx = img[..., 2] - px
    by = img[..., 3] - py
    cx = img[..., 4] - px
    cy = img[..., 5] - py
    w0 = bx * cy - by * cx
    w1 = cx * ay - cy * ax
    w2 = ax * by - ay * bx
    norm = w0 + w1 + w2
    norm = norm + torch.copysign(norm.new_tensor(eps), norm)
    return w0 / norm, w1 / norm, w2 / norm


def rasterize_select_plain(face_vertices_z, face_vertices_image_flat,
                           face_bboxes, row_start=0, *, height, width,
                           total_height=None, multiplier, eps):
    """Winner face and its z per pixel, over face chunks: the max z of a
    chunk wins, ties to the lowest face id, and a later chunk takes a
    pixel only with a strictly larger z. Returns (zbuf (B,H,W), face_idx
    (B,H,W) int32), -inf and -1 where uncovered."""
    fz, img, bbox = face_vertices_z, face_vertices_image_flat, face_bboxes
    B, F, _ = fz.shape
    dtype, device = fz.dtype, fz.device
    x0, y0 = _pixel_coords(height, width, multiplier, dtype, row_start,
                           total_height, device)
    px = x0[None, None, None, :]
    py = y0[None, None, :, None]
    chunk = max(1, min(32, _PLAIN_BUDGET // max(1, B * height * width)))
    zbuf = torch.full((B, height, width), -torch.inf, dtype=dtype,
                      device=device)
    idx = torch.full((B, height, width), -1, dtype=torch.int32,
                     device=device)
    big = torch.iinfo(torch.int32).max
    for start in range(0, F, chunk):
        sl = slice(start, min(start + chunk, F))
        bb = bbox[:, sl, :, None, None]
        hit = ((px >= bb[:, :, 0]) & (px < bb[:, :, 2])
               & (py >= bb[:, :, 1]) & (py < bb[:, :, 3]))
        w0, w1, w2 = _barycentric(px, py, img[:, sl, None, None, :], eps)
        inside = (w0 >= 0.) & (w1 >= 0.) & (w2 >= 0.)
        z = fz[:, sl, :, None, None]
        z0 = w0 * z[:, :, 0] + w1 * z[:, :, 1] + w2 * z[:, :, 2]
        z0 = torch.where(hit & inside, z0, -torch.inf)
        zmax = z0.amax(dim=1)
        ids = torch.arange(sl.start, sl.stop, dtype=torch.int32,
                           device=device)[None, :, None, None]
        is_max = (z0 == zmax[:, None]) & (zmax[:, None] > -torch.inf)
        kidx = torch.where(is_max, ids, big).amin(dim=1)
        take = zmax > zbuf
        zbuf = torch.where(take, zmax, zbuf)
        idx = torch.where(take, kidx, idx)
    return zbuf, idx


def interp_epilogue(face_idx, face_vertices_image_flat, face_features_flat,
                    row_start=0, *, total_height=None, multiplier, eps):
    """The winner's barycentric weights (recomputed with the same formula,
    so the values are those of the selection) and its interpolated
    features; uncovered pixels get 0. Returns (features (B,H,W,D),
    weights (B,H,W,3))."""
    img = face_vertices_image_flat
    B, F, _ = img.shape
    _, H, W = face_idx.shape
    D = face_features_flat.shape[-1] // 3
    covered = (face_idx >= 0)[..., None]
    flat = face_idx.clamp(min=0).long().reshape(B, H * W, 1)
    x0, y0 = _pixel_coords(H, W, multiplier, img.dtype, row_start,
                           total_height, img.device)
    win_img = torch.gather(img, 1, flat.expand(B, H * W, 6))
    w0, w1, w2 = _barycentric(x0[None, None, :], y0[None, :, None],
                              win_img.reshape(B, H, W, 6), eps)
    weights = torch.where(covered, torch.stack([w0, w1, w2], dim=-1), 0.)
    win_feat = torch.gather(face_features_flat, 1,
                            flat.expand(B, H * W, 3 * D))
    win_feat = win_feat.reshape(B, H, W, 3, D)
    w = weights[..., None]
    interp = (w[..., 0, :] * win_feat[..., 0, :]
              + w[..., 1, :] * win_feat[..., 1, :]
              + w[..., 2, :] * win_feat[..., 2, :])
    return torch.where(covered, interp, 0.), weights


def rasterize_interp_plain(face_vertices_z, face_vertices_image_flat,
                           face_bboxes, face_features_flat, row_start=0, *,
                           height, width, total_height=None, multiplier,
                           eps):
    """Plain version of :func:`rasterize_interp`: selection, then the
    gather epilogue."""
    _, face_idx = rasterize_select_plain(
        face_vertices_z, face_vertices_image_flat, face_bboxes, row_start,
        height=height, width=width, total_height=total_height,
        multiplier=multiplier, eps=eps)
    features, weights = interp_epilogue(
        face_idx, face_vertices_image_flat, face_features_flat, row_start,
        total_height=total_height, multiplier=multiplier, eps=eps)
    return features, face_idx, weights


def _slots(B, F, height, width):
    """The lists' slots: B * tile rows * tile columns * ceil(F / CHUNK)."""
    return B * -(-height // TILE) * -(-width // TILE) * -(-F // CHUNK)


def tile_bins_plain(face_bboxes, row_start=0, *, height, width,
                    total_height=None, multiplier):
    """Plain version of :func:`tile_bins`."""
    bb = face_bboxes
    B, F = bb.shape[:2]
    ty, tx = -(-height // TILE), -(-width // TILE)
    chunks, n = -(-F // CHUNK), _slots(B, F, height, width)
    x0, y0 = _pixel_coords(height, width, multiplier, bb.dtype, row_start,
                           total_height, bb.device)
    c0 = torch.arange(0, width, TILE, device=bb.device)
    r0 = torch.arange(0, height, TILE, device=bb.device)
    c1 = (c0 + TILE).clamp(max=width) - 1
    r1 = (r0 + TILE).clamp(max=height) - 1
    xp = (bb[..., 0, None] <= x0[c1]) & (bb[..., 2, None] > x0[c0])
    yp = (bb[..., 1, None] <= y0[r0]) & (bb[..., 3, None] > y0[r1])
    b, f, r, c = (yp[..., :, None] & xp[..., None, :]).nonzero(
        as_tuple=True)
    slot = ((b * ty + r) * tx + c) * chunks + f // CHUNK
    # a word's bits are distinct faces: their sum is their OR
    words = torch.zeros(n * (CHUNK // 32), dtype=torch.int64,
                        device=bb.device)
    words.index_add_(0, slot * (CHUNK // 32) + f % CHUNK // 32,
                     torch.ones_like(f) << (f % 32))
    return words.to(torch.int32)


def tile_bins(face_bboxes, row_start=0, *, height, width, total_height=None,
              multiplier):
    """Per-tile face lists: for every 16x16 tile of the (B, height, width)
    image, the faces whose bbox overlaps the tile's pixel-centre rectangle
    (``bb[0] <= x_hi and bb[2] > x_lo and bb[1] <= y_hi and bb[3] > y_lo``),
    in slots of CHUNK consecutive face ids laid out batch entry, tile row,
    tile column, id range: an int32 array of n slots of CHUNK / 32 words,
    face f bit f % 32 of word f % CHUNK // 32 of its slot. Its size depends
    on the shapes only (B * tiles * F / 8 bytes)."""
    if total_height is None:
        total_height = height
    if not _is_cuda(face_bboxes):
        return tile_bins_plain(face_bboxes, row_start, height=height,
                               width=width, total_height=total_height,
                               multiplier=multiplier)
    (bbox,), _, dev, stream = _build.cuda_inputs('tile_bins', (face_bboxes,))
    B, F, _ = bbox.shape
    bins = _empty_bins(B, F, height, width, bbox.device)
    _build.launch(_lib(), 'tile_bins', bbox.data_ptr(), bins.data_ptr(), B,
                  F, height, width, int(row_start), int(total_height),
                  _build.pixel_scale(multiplier, width),
                  _build.pixel_scale(multiplier, total_height), dev, stream)
    return bins


def _empty_bins(B, F, height, width, device):
    return torch.empty(_slots(B, F, height, width) * (CHUNK // 32),
                       dtype=torch.int32, device=device)


def _bins(bins, B, F, height, width, device):
    """(lists, bin first): ``bins`` if given, else room for the kernel to
    bin its own bboxes into."""
    if bins is None:
        return _empty_bins(B, F, height, width, device), 1
    _build.check_shapes('tile_bins', bins,
                        (_slots(B, F, height, width) * (CHUNK // 32),))
    return bins, 0


def _lib():
    return _build.load('rasterize', _SIGNATURES)


def _is_cuda(t):
    if t.device.type == 'cuda':
        return True
    if t.device.type != 'cpu':
        raise ValueError(f'no kernel for device {t.device}; the port takes '
                         'CUDA or CPU tensors')
    return False


def rasterize_interp(face_vertices_z, face_vertices_image_flat, face_bboxes,
                     face_features_flat, row_start=0, *, height, width,
                     total_height=None, multiplier, eps, bins=None):
    """Per pixel: winner face, its barycentric weights and its interpolated
    features. ``bins``: the lists of :func:`tile_bins` of bboxes that hold
    ``face_bboxes`` (default: those of ``face_bboxes``); CPU tensors take
    none. Returns (features (B,H,W,D), face_idx (B,H,W) int32, -1 where
    uncovered, weights (B,H,W,3))."""
    if total_height is None:
        total_height = height
    if not _is_cuda(face_vertices_z):
        return rasterize_interp_plain(
            face_vertices_z, face_vertices_image_flat, face_bboxes,
            face_features_flat, row_start, height=height, width=width,
            total_height=total_height, multiplier=multiplier, eps=eps)
    (fz, img, bbox, feat), _, dev, stream = _build.cuda_inputs(
        'rasterize_interp', (face_vertices_z, face_vertices_image_flat,
                             face_bboxes, face_features_flat))
    B, F, _ = fz.shape
    D = feat.shape[-1] // 3
    _build.check_shapes('rasterize_interp', fz, (B, F, 3), img, (B, F, 6),
                        bbox, (B, F, 4), feat, (B, F, 3 * D))
    if B * height * width == 0:         # no pixel: nothing to launch
        return (fz.new_zeros((B, height, width, D)),
                torch.zeros((B, height, width), dtype=torch.int32,
                            device=fz.device),
                fz.new_zeros((B, height, width, 3)))
    lists, bin_first = _bins(bins, B, F, height, width, fz.device)
    idx = torch.empty((B, height, width), dtype=torch.int32, device=fz.device)
    weights = fz.new_empty((B, height, width, 3))
    features = fz.new_empty((B, height, width, D))
    _build.launch(
        _lib(), 'rasterize_interp', fz.data_ptr(), img.data_ptr(),
        bbox.data_ptr(), feat.data_ptr(), lists.data_ptr(), bin_first,
        idx.data_ptr(), weights.data_ptr(), features.data_ptr(), B, F,
        height, width, D,
        int(row_start), int(total_height),
        _build.pixel_scale(multiplier, width),
        _build.pixel_scale(multiplier, total_height), eps, dev, stream)
    rasterize_interp.launches += 1
    return features, idx, weights


rasterize_interp.launches = 0


def rasterize_select(face_vertices_z, face_vertices_image_flat, face_bboxes,
                     row_start=0, *, height, width, total_height=None,
                     multiplier, eps, bins=None):
    """Per pixel: winner face and its interpolated z; ``bins`` as for
    :func:`rasterize_interp`. Returns (zbuf (B,H,W), face_idx (B,H,W)
    int32), -inf and -1 where uncovered."""
    if total_height is None:
        total_height = height
    if not _is_cuda(face_vertices_z):
        return rasterize_select_plain(
            face_vertices_z, face_vertices_image_flat, face_bboxes,
            row_start, height=height, width=width,
            total_height=total_height, multiplier=multiplier, eps=eps)
    (fz, img, bbox), _, dev, stream = _build.cuda_inputs(
        'rasterize_select', (face_vertices_z, face_vertices_image_flat,
                             face_bboxes))
    B, F, _ = fz.shape
    _build.check_shapes('rasterize_select', fz, (B, F, 3), img, (B, F, 6),
                        bbox, (B, F, 4))
    if B * height * width == 0:         # no pixel: nothing to launch
        return (fz.new_zeros((B, height, width)),
                torch.zeros((B, height, width), dtype=torch.int32,
                            device=fz.device))
    lists, bin_first = _bins(bins, B, F, height, width, fz.device)
    zbuf = fz.new_empty((B, height, width))
    idx = torch.empty((B, height, width), dtype=torch.int32, device=fz.device)
    _build.launch(
        _lib(), 'rasterize_select', fz.data_ptr(), img.data_ptr(),
        bbox.data_ptr(), lists.data_ptr(), bin_first, zbuf.data_ptr(),
        idx.data_ptr(), B, F, height, width, int(row_start),
        int(total_height),
        _build.pixel_scale(multiplier, width),
        _build.pixel_scale(multiplier, total_height), eps, dev, stream)
    rasterize_select.launches += 1
    return zbuf, idx


rasterize_select.launches = 0
