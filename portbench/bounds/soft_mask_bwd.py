"""DIB-R's soft mask backward (``soft_mask_live_kernel`` and
``soft_mask_bwd_kernel``, ``csrc/soft_mask.cu``).

Bytes: the cut at every pixel, the cotangent where a face was recorded
and the mask where that cotangent is nonzero read; per face the image
coordinates and enlarged box read and 6 gradients written (16 floats).
Operations: 188 a recorded pair at a pixel whose cotangent is nonzero.
The IoU loss's cotangent is nonzero at every pixel where the
intersection is, so every recorded pair counts."""

from .common import OPS_SOFT_BWD_PAIR
from .soft_mask import recorded

NAMES = ('soft_mask_live_kernel', 'soft_mask_bwd_kernel')
MEMSET_BEFORE = ()


def work(b):
    fvi, face_idx = b['face_image'], b['face_idx']
    B, F = fvi.shape[:2]
    _, H, W = face_idx.shape
    pairs = recorded(b)
    live = int((pairs > 0).sum())
    nbytes = 4 * (B * H * W + 2 * live + B * F * 16)
    return nbytes, int(pairs.sum()) * OPS_SOFT_BWD_PAIR
