"""Preprocessing a mesh dataset for fast point-cloud sampling at runtime.

Mirrors reference ``examples/recipes/preprocess/fast_mesh_sampling.py``:
the expensive part of surface sampling (loading the mesh, computing face
areas, oversampling) is done ONCE and cached to disk with
``CachedDataset``; the runtime transform then only subsamples — cheap
enough for the training loop's hot path.

Pass ``--shapenet-dir`` to run on ShapeNet v2; without it, a synthetic
two-mesh dataset stands in so the recipe runs anywhere.
"""

import argparse
import tempfile

import numpy as np
import torch

import kaolin_tpu_torch as kal
from kaolin_tpu_torch.examples.utils import check_device, sample_points
from kaolin_tpu_torch.io.dataset import CachedDataset, KaolinDataset

_P = (1 + 5 ** 0.5) / 2
ICOSAHEDRON_VERTICES = [
    [-1, _P, 0], [1, _P, 0], [-1, -_P, 0], [1, -_P, 0],
    [0, -1, _P], [0, 1, _P], [0, -1, -_P], [0, 1, -_P],
    [_P, 0, -1], [_P, 0, 1], [-_P, 0, -1], [-_P, 0, 1]]
ICOSAHEDRON_FACES = [
    [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
    [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
    [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
    [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]


class _SyntheticMeshes(KaolinDataset):
    """Stand-in for ShapeNet: two unit shapes on ``device``."""

    def __init__(self, device):
        self.device = device

    def __len__(self):
        return 2

    def get_data(self, i):
        verts = torch.tensor(ICOSAHEDRON_VERTICES, dtype=torch.float32,
                             device=self.device) * (0.5 + 0.5 * i)
        faces = torch.tensor(ICOSAHEDRON_FACES, dtype=torch.int32,
                             device=self.device)
        return verts, faces

    def get_attributes(self, i):
        return {'name': f'shape_{i}'}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--shapenet-dir', type=str, default=None)
    parser.add_argument('--cache-dir', type=str, default=None)
    parser.add_argument('--num-samples', type=int, default=1024)
    parser.add_argument('--num-oversample', type=int, default=16384)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)
    device = check_device(args.device)
    cache_dir = args.cache_dir or tempfile.mkdtemp(prefix='kal_cache_')

    def preprocessing_transform(inputs):
        """Run once per item, cached on disk: oversample the surface."""
        verts, faces = inputs.data if hasattr(inputs, 'data') else inputs
        verts = torch.as_tensor(verts, device=device)
        faces = torch.as_tensor(faces, device=device)
        pts, _ = sample_points(verts[None], faces, args.num_oversample,
                               torch.Generator().manual_seed(0))
        return {'points': pts[0].cpu().numpy()}

    def runtime_transform(item, key):
        """Cheap per-__getitem__ work: subsample the cached oversampling."""
        pts = item['points']
        idx = torch.randperm(pts.shape[0], generator=key)[:args.num_samples]
        return torch.as_tensor(np.asarray(pts), device=device)[idx.to(device)]

    if args.shapenet_dir is not None:
        base = kal.io.shapenet.ShapeNetV2(root=args.shapenet_dir,
                                          categories=['car'], train=True,
                                          with_materials=False,
                                          device=device)
    else:
        print('no --shapenet-dir given: using a synthetic 2-mesh dataset')
        base = _SyntheticMeshes(device)

    ds = CachedDataset(base, cache_dir, transform=preprocessing_transform)

    key = torch.Generator().manual_seed(42)
    for i in range(len(ds)):
        cloud = runtime_transform(ds[i], key)
        print(f'item {i}: runtime point cloud {tuple(cloud.shape)}, '
              f'bbox extent {float(cloud.max() - cloud.min()):.2f}')
    print(f'cache written under {cache_dir}')


if __name__ == '__main__':
    main()
