"""The dual octree: features on cell corners instead of cell centers.

Mirrors reference ``examples/recipes/spc/spc_dual_octree.py``: build a
level-1 SPC and compare the primary cells against the dual corners.
"""

import argparse

import torch

from kaolin_tpu_torch.examples.utils import check_device
from kaolin_tpu_torch.ops.conversions import unbatched_pointcloud_to_spc
from kaolin_tpu_torch.ops.spc import (unbatched_make_dual,
                                      unbatched_get_level_points)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--device', default='cuda')
    device = check_device(ap.parse_args(argv).device)

    level = 1
    points = torch.tensor([[-1.0, -1.0, -1.0],
                           [-0.9, -0.95, -1.0],
                           [1.0, 1.0, 1.0]], device=device)
    spc = unbatched_pointcloud_to_spc(pointcloud=points, level=level)

    pyramid = spc.pyramids[0]
    point_hierarchy = spc.point_hierarchies
    point_hierarchy_dual, pyramid_dual = unbatched_make_dual(
        point_hierarchy=point_hierarchy, pyramid=pyramid)

    for lod in range(level + 1):
        primary = unbatched_get_level_points(point_hierarchy, pyramid, lod)
        dual = unbatched_get_level_points(point_hierarchy_dual,
                                          pyramid_dual, lod)
        print(f'--- level {lod} ---')
        print(f'primary octree: {primary.shape[0]} cell centers')
        print(primary)
        print(f'dual octree: {dual.shape[0]} cell corners')
        print(dual)

    # Each occupied primary cell at the bottom level touches 8 dual
    # corners; shared corners between neighboring cells are stored once.


if __name__ == '__main__':
    main()
