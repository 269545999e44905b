"""``rasterize``'s backward (``csrc/rasterize_bwd.cu``): per covered
pixel the derivative of its barycentrics in the winner's 6 image
coordinates, chained with the feature deltas, and the weights times the
cotangent for the features.

Bytes: the face id at every pixel, the cotangent (D) and weights (3) at
covered pixels read; per face the image coordinates and features
(6 + 3 D) read and their gradients written. Operations: 94 + 12 D a
covered pixel."""

from .common import OPS_RBWD_CHANNEL, OPS_RBWD_PIXEL

NAMES = ('rasterize_bwd_kernel',)
MEMSET_BEFORE = ()


def work(b):
    fvi, face_idx, D = b['face_image'], b['face_idx'], b['feat_dim']
    B, F = fvi.shape[:2]
    _, H, W = face_idx.shape
    covered = int((face_idx >= 0).sum())
    nbytes = 4 * (B * H * W + covered * (D + 3) + 2 * B * F * (6 + 3 * D))
    return nbytes, covered * (OPS_RBWD_PIXEL + OPS_RBWD_CHANNEL * D)
