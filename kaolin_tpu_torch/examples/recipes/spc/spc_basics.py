"""Basics of the Structured Point Cloud (SPC) compressed octree.

Mirrors reference ``examples/recipes/spc/spc_basics.py``: build an SPC
from points in [-1, 1], inspect its batched/packed fields, and list the
occupied cells per level of detail.
"""

import argparse

import torch

from kaolin_tpu_torch.examples.utils import check_device
from kaolin_tpu_torch.ops.conversions import unbatched_pointcloud_to_spc
from kaolin_tpu_torch.ops.spc import unbatched_get_level_points


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--device', default='cuda')
    device = check_device(ap.parse_args(argv).device)

    points = torch.tensor([[-1.0, -1.0, -1.0],
                           [-0.9, -0.95, -1.0],
                           [1.0, 1.0, 1.0]], device=device)

    # Single point cloud -> unbatched conversion, 3 levels of detail
    spc = unbatched_pointcloud_to_spc(pointcloud=points, level=3)

    # SPC is a batched object with packed fields; `lengths` marks the
    # boundaries between batch entries in `octrees`
    print(f'spc.batch_size: {spc.batch_size}')
    print(f'spc.lengths (octree bytes per entry): {spc.lengths}')

    # point_hierarchies holds the sparse cell coordinates of every level,
    # pyramids separates level boundaries: pyramids[b, 0, l] = #cells at
    # l, pyramids[b, 1, l] = offset of level l in point_hierarchies
    print(f'total parent + leaf cells: {spc.point_hierarchies.shape[0]}')
    for level in range(spc.max_level + 1):
        pts = unbatched_get_level_points(spc.point_hierarchies,
                                         spc.pyramids[0], level)
        print(f'level {level}: {pts.shape[0]} occupied cells '
              f'(grid {2 ** level}^3)')
        print(pts)

    # exsum is the exclusive prefix sum of the per-byte child counts; it
    # is the indexing backbone for queries, raytracing, and convolutions
    print(f'spc.exsum shape: {spc.exsum.shape}')


if __name__ == '__main__':
    main()
