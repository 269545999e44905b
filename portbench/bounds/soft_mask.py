"""DIB-R's soft mask forward (``soft_mask_kernel``, ``csrc/soft_mask.cu``)
over the lists that ``dibr_rasterization`` bins once (counted under
``rasterize``).

Bytes: per face the scaled image coordinates and the enlarged box (10
floats) read; per pixel the face id read and the mask written.
Operations: 138 a recorded pair: at each uncovered pixel, the first
``knum`` faces whose enlarged box holds its centre."""

from .common import OPS_SOFT_PAIR, pixel_hits, scaled_boxes

NAMES = ('soft_mask_kernel',)
MEMSET_BEFORE = ()


def recorded(b):
    """(B, H, W) pairs recorded at each pixel (0 on covered pixels)."""
    face_idx = b['face_idx']
    _, H, W = face_idx.shape
    hits = pixel_hits(scaled_boxes(b['face_image'], b['boxlen']), H, W)
    return hits.clamp(max=b['knum']) * (face_idx < 0)


def work(b):
    fvi, face_idx = b['face_image'], b['face_idx']
    B, F = fvi.shape[:2]
    _, H, W = face_idx.shape
    nbytes = 4 * (B * F * 10 + B * H * W * 2)
    return nbytes, int(recorded(b).sum()) * OPS_SOFT_PAIR
