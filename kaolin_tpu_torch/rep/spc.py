"""Structured Point Cloud (SPC) container. Port of
``kaolin_tpu/rep/spc.py`` (reference ``kaolin/rep/spc.py:24-304``).

Octrees and lengths are given; ``max_level``, ``pyramids``, ``exsum`` and
``point_hierarchies`` are computed on first use by
:func:`kaolin_tpu_torch.ops.spc.scan_octrees` and
:func:`~kaolin_tpu_torch.ops.spc.generate_points`, on the octrees'
device.
"""

import numpy as np
import torch

from ..ops import spc as spc_ops

__all__ = ['Spc']


class Spc:
    """Batched structured point clouds (sparse octrees).

    Args:
        octrees: packed uint8 byte stream (tensor).
        lengths: (batch_size,) int byte counts.
        max_level / pyramids / exsum / point_hierarchies: optional
            precomputed structure (see ``scan_octrees``).
        features: optional per-point features.
    """

    KEYS = {'octrees', 'lengths', 'max_level', 'pyramids', 'exsum',
            'point_hierarchies'}

    def __init__(self, octrees, lengths, max_level=None, pyramids=None,
                 exsum=None, point_hierarchies=None, features=None):
        assert (max_level is None) == (pyramids is None) == (exsum is None), \
            "max_level, pyramids and exsum must be provided together"
        self.octrees = octrees
        self.lengths = np.asarray(lengths.cpu() if torch.is_tensor(lengths)
                                  else lengths)
        self.features = features
        self._max_level = max_level
        self._pyramids = pyramids
        self._exsum = exsum
        self._point_hierarchies = point_hierarchies

    @property
    def batch_size(self):
        return self.lengths.shape[0]

    def _apply_scan_octrees(self):
        max_level, pyramids, exsum = spc_ops.scan_octrees(self.octrees,
                                                          self.lengths)
        self._max_level = max_level
        self._pyramids = pyramids
        self._exsum = exsum

    @property
    def max_level(self):
        if self._max_level is None:
            self._apply_scan_octrees()
        return self._max_level

    @property
    def pyramids(self):
        if self._pyramids is None:
            self._apply_scan_octrees()
        return self._pyramids

    @property
    def exsum(self):
        if self._exsum is None:
            self._apply_scan_octrees()
        return self._exsum

    @property
    def point_hierarchies(self):
        if self._point_hierarchies is None:
            self._point_hierarchies = spc_ops.generate_points(
                self.octrees, self.pyramids, self.exsum)
        return self._point_hierarchies

    @classmethod
    def make_dense(cls, level, device='cuda'):
        """Fully-dense SPC at ``level`` (reference ``rep/spc.py:142``)."""
        octree, lengths = spc_ops.create_dense_spc(level, device=device)
        return cls(octree, lengths)

    @classmethod
    def from_features(cls, feature_grids, masks=None):
        """SPC with coalesced features from dense feature grids
        (reference ``rep/spc.py:160``)."""
        octrees, lengths, features = spc_ops.feature_grids_to_spc(
            feature_grids, masks)
        return cls(octrees, lengths, features=features)

    @classmethod
    def from_list(cls, octrees_list):
        """SPC from a list of single octree byte tensors
        (reference ``rep/spc.py:230``)."""
        lengths = np.array([len(o) for o in octrees_list], dtype=np.int32)
        return cls(torch.cat([torch.as_tensor(o) for o in octrees_list]),
                   lengths)

    def to_dense(self, input, level=-1):
        """Scatter features into a dense grid (reference ``rep/spc.py``)."""
        return spc_ops.to_dense(self.point_hierarchies, self.pyramids,
                                input, level)

    def num_points(self, lod):
        return self.pyramids[:, 0, lod]
