"""Building an SPC (compressed octree) from raw point-cloud data.

Mirrors reference ``examples/recipes/dataload/spc_from_pointcloud.py``:
points with per-point features are quantized to a chosen level of
detail; features of points falling in the same cell are averaged.
"""

import argparse

import torch

from kaolin_tpu_torch.examples.utils import check_device
from kaolin_tpu_torch.ops.conversions import unbatched_pointcloud_to_spc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--device', default='cuda')
    device = check_device(ap.parse_args(argv).device)

    # Point coordinates are expected in the range [-1, 1]
    points = torch.tensor([
        [-1.0, -1.0, -1.0],
        [-0.9, -0.95, -1.0],
        [1.0, 0.0, 0.0],
        [0.0, -0.1, 0.3],
        [1.0, 1.0, 1.0],
    ], device=device)
    features = torch.tensor([
        [0.1, 1.1, 2.1],
        [0.2, 1.2, 2.2],
        [0.3, 1.3, 2.3],
        [0.4, 1.4, 2.4],
        [0.5, 1.5, 2.5],
    ], device=device)

    level = 3
    spc = unbatched_pointcloud_to_spc(pointcloud=points, level=level,
                                      features=features)

    print(f'batch size: {spc.batch_size}')
    print(f'octree bytes: {spc.lengths}')
    print(f'hierarchy cells: {spc.point_hierarchies.shape[0]}')
    # The first two input points share a cell at level 3, so 5 points
    # collapse to 4 leaves and their features are averaged
    print(f'leaf features ({spc.features.shape[0]} cells):')
    print(spc.features)


if __name__ == '__main__':
    main()
