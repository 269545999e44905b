"""SPC 3D convolutions as a sparse mipmap: average colors down the tree.

Mirrors reference ``examples/recipes/spc/spc_conv3d_example.py``: apply
a 2x2x2 averaging ``conv3d`` with ``jump=1`` repeatedly, filtering the
finest-level colors down to the root — the 3D analog of a 2D mipmap
chain for level-of-detail rendering.
"""

import argparse

import numpy as np
import torch

from kaolin_tpu_torch.examples.utils import check_device
from kaolin_tpu_torch.ops.conversions import unbatched_pointcloud_to_spc
from kaolin_tpu_torch.ops.spc import conv3d


def encode(colors, octree, point_hierarchy, pyramids, exsum, level):
    """Filters `colors` at `level` down to level 0, returning the full
    colored hierarchy (one row per octree node, coarsest first)."""
    dev = colors.device
    kernel_vectors = torch.tensor(
        [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
         [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]], dtype=torch.int32,
        device=dev)
    # one input channel group; each of the 8 taps contributes 1/8
    c = colors.shape[1]
    weight = torch.zeros((8, c, c), dtype=colors.dtype, device=dev)
    weight[:, torch.arange(c), torch.arange(c)] = 1.0 / 8.0

    per_level = [colors]
    feats = colors
    for lod in range(level, 0, -1):
        feats, out_level = conv3d(octree, point_hierarchy, lod, pyramids,
                                  exsum, feats, weight, kernel_vectors,
                                  jump=1)
        per_level.append(feats)
        print(f'conv3d: level {lod} ({per_level[-2].shape[0]} cells) -> '
              f'level {out_level} ({feats.shape[0]} cells)')
    per_level.reverse()
    return torch.cat(per_level, dim=0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--device', default='cuda')
    device = check_device(ap.parse_args(argv).device)

    level = 3
    rng = np.random.default_rng(0)
    points = torch.as_tensor(rng.uniform(-1, 1, size=(64, 3))
                             .astype(np.float32), device=device)
    colors = torch.as_tensor(rng.uniform(0, 1, size=(points.shape[0], 3))
                             .astype(np.float32), device=device)

    spc = unbatched_pointcloud_to_spc(pointcloud=points, level=level,
                                      features=colors)
    hierarchy_colors = encode(spc.features, spc.octrees,
                              spc.point_hierarchies, spc.pyramids,
                              spc.exsum, level)
    print(f'colored hierarchy: {hierarchy_colors.shape[0]} nodes '
          f'({spc.point_hierarchies.shape[0]} in the SPC)')
    # Note: empty cells contribute zeros to the averaging kernel, so the
    # root is the leaf mean scaled by the occupancy of the tree — exactly
    # the reference's conv3d semantics.
    print('root color:', hierarchy_colors[0])
    print('leaf mean :', torch.mean(spc.features, dim=0))


if __name__ == '__main__':
    main()
