"""Trilinear interpolation of dual-octree (corner) features.

Mirrors reference ``examples/recipes/spc/spc_trilinear_interp.py``:
features live on the dual corners, trinkets map each primary cell to
its 8 corner indices, and query points are interpolated inside their
containing cell.
"""

import argparse

import torch

from kaolin_tpu_torch.examples.utils import check_device
from kaolin_tpu_torch.ops.conversions import unbatched_pointcloud_to_spc
from kaolin_tpu_torch.ops.spc import (unbatched_make_dual,
                                      unbatched_make_trinkets,
                                      unbatched_query,
                                      unbatched_interpolate_trilinear)


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

    # trinkets[i] = indices of the 8 dual corners of primary cell i
    trinkets, parents = unbatched_make_trinkets(
        point_hierarchy, pyramid, point_hierarchy_dual, pyramid_dual)
    num_corners = point_hierarchy_dual.shape[0]
    print(f'{point_hierarchy.shape[0]} primary cells, '
          f'{num_corners} dual corners')

    # One scalar feature per dual corner: its index, for easy inspection
    features = torch.arange(num_corners, dtype=torch.float32,
                            device=device)[:, None]

    # Query points in [-1, 1]; pidx is each point's containing cell at
    # `level` (-1 when the point falls in empty space)
    query = torch.tensor([[-0.95, -0.97, -0.98],
                          [0.9, 0.9, 0.9],
                          [0.0, 0.0, 0.0]], device=device)
    pidx = unbatched_query(spc.octrees, spc.exsum, query, level)
    print('containing cell per query point:', pidx)

    interpolated = unbatched_interpolate_trilinear(
        query[:, None, :], pidx, point_hierarchy, trinkets, features, level)
    for q, i, v in zip(query.tolist(), pidx.tolist(),
                       interpolated[:, 0, 0].tolist()):
        tag = 'EMPTY' if int(i) < 0 else f'cell {int(i)}'
        print(f'point {q} -> {tag}, interpolated value {float(v):.3f}')


if __name__ == '__main__':
    main()
