"""Sampling an occupancy function from a watertight mesh.

Mirrors reference ``examples/recipes/preprocess/occupancy_sampling.py``:
sample uniform points in the bounding box (+10% margin) and label them
inside/outside with ``check_sign`` — the standard preprocessing step for
occupancy-network training data. Loads the OBJ given by ``--mesh``;
without one it builds an icosahedron.
"""

import argparse

import torch

import kaolin_tpu_torch as kal
from kaolin_tpu_torch.examples.utils import check_device, uniform

NUM_SAMPLES = 100000


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--mesh', default=None, help='a watertight OBJ')
    args = ap.parse_args(argv)
    device = check_device(args.device)

    if args.mesh is not None:
        mesh = kal.io.obj.import_mesh(args.mesh, device=device)
        vertices, faces = mesh.vertices, mesh.faces
    else:
        # a regular icosahedron (watertight)
        p = (1 + 5 ** 0.5) / 2
        vertices = torch.tensor(
            [[-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0],
             [0, -1, p], [0, 1, p], [0, -1, -p], [0, 1, -p],
             [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1]],
            dtype=torch.float32, device=device)
        faces = torch.tensor(
            [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
             [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
             [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
             [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
            dtype=torch.int64, device=device)
    print(f'mesh: {vertices.shape[0]} vertices, {faces.shape[0]} faces')

    # Batch format: (1, V, 3)
    vertices = vertices[None]

    # Uniform samples in the bounding box + 10% margin
    min_bound = vertices.amin(dim=1)
    max_bound = vertices.amax(dim=1)
    margin = (max_bound - min_bound) * 0.1
    min_bound, max_bound = min_bound - margin, max_bound + margin
    key = torch.Generator().manual_seed(0)
    occupancy_coords = min_bound + (max_bound - min_bound) \
        * uniform(key, (1, NUM_SAMPLES, 3), device)

    occupancy = kal.ops.mesh.check_sign(vertices, faces, occupancy_coords)

    occupancy_coords = occupancy_coords[0]
    occupancy = occupancy[0]
    inside = float(torch.mean(occupancy.to(torch.float32)))
    print(f'sampled {NUM_SAMPLES} points; {inside:.1%} inside the mesh')
    print('example inside point:',
          occupancy_coords[torch.argmax(occupancy.to(torch.int32))])


if __name__ == '__main__':
    main()
