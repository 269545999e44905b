"""Emulated-training Timelapse demo: writes timed USD checkpoints of
meshes / pointclouds / voxelgrids for the Dash3D web viewer.

Behavioral reference: ``examples/tutorial/visualize_main.py`` (OBJ
import, bbox normalization, emulated training deltas, static
ground-truth/input categories + per-iteration output categories).

Run: ``python -m kaolin_tpu_torch.examples.visualize_main --test-objs
a.obj,b.obj --output-dir logs/ [--device cpu]`` then view with
``python -m kaolin_tpu_torch.experimental.dash3d --logdir logs/``.
"""

import argparse
import os

import numpy as np
import torch

from .. import io as kio
from .. import ops, visualize
from . import utils

__all__ = ['normalize_vertices', 'emulate_training_timelapse']


def normalize_vertices(vertices):
    """Centers vertices and scales the bounding box into [-1, 1]
    (``visualize_main.py:27-34``)."""
    centered = vertices - torch.mean(vertices, dim=0, keepdim=True)
    span = centered.amax(dim=0) - centered.amin(dim=0)
    return centered / span.max()


def emulate_training_timelapse(objs, output_dir, iterations=101,
                               checkpoint_interval=10, normalize=True,
                               voxel_res=30, seed=0, device='cuda'):
    """Imports meshes, then logs fake training outputs converging to the
    ground truth (mesh + sampled pointcloud + voxelized grid per
    checkpoint). The samples are drawn from a CPU ``torch.Generator``
    seeded by ``seed`` (the JAX example's PRNG key), the rest from numpy
    as there. Returns the Timelapse directory."""
    device = utils.check_device(device)
    key = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    face_list, gt_verts, in_pts, dv, dp = [], [], [], [], []
    for path in objs:
        mesh = kio.obj.import_mesh(path, device=device)
        verts = mesh.vertices.to(torch.float32)
        if normalize:
            verts = normalize_vertices(verts)
        num_samples = int(rng.integers(1000, 1500))
        pts = utils.sample_points(verts[None], mesh.faces, num_samples,
                                  key)[0][0]
        face_list.append(mesh.faces)
        gt_verts.append(verts)
        in_pts.append(pts)
        dv.append(torch.as_tensor(
            rng.uniform(-0.25, 0.25, tuple(verts.shape)).astype(np.float32),
            device=device))
        dp.append(torch.as_tensor(
            rng.uniform(-0.25, 0.25, tuple(pts.shape)).astype(np.float32),
            device=device))

    timelapse = visualize.Timelapse(output_dir)
    timelapse.add_mesh_batch(category='ground_truth',
                             faces_list=face_list, vertices_list=gt_verts)
    timelapse.add_pointcloud_batch(category='input', pointcloud_list=in_pts)

    for it in range(0, iterations, checkpoint_interval):
        w = 1. - it / max(iterations - 1, 1)
        out_verts = [v * (1. + d * w) for v, d in zip(gt_verts, dv)]
        out_pts = [p * (1. + d * w) for p, d in zip(in_pts, dp)]
        out_vox = [
            ops.conversions.trianglemeshes_to_voxelgrids(
                v[None], f, voxel_res)[0].to(torch.bool)
            for v, f in zip(out_verts, face_list)]
        timelapse.add_mesh_batch(iteration=it, category='output',
                                 faces_list=face_list,
                                 vertices_list=out_verts)
        timelapse.add_pointcloud_batch(iteration=it, category='output',
                                       pointcloud_list=out_pts)
        timelapse.add_voxelgrid_batch(iteration=it, category='output',
                                      voxelgrid_list=out_vox)
    return output_dir


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--test-objs', required=True,
                    help='comma-separated OBJ paths')
    ap.add_argument('--output-dir', required=True)
    ap.add_argument('--iterations', type=int, default=101)
    ap.add_argument('--checkpoint-interval', type=int, default=10)
    ap.add_argument('--skip-normalization', action='store_true')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    if not os.path.isdir(args.output_dir):
        raise RuntimeError(f'output dir does not exist: {args.output_dir}')
    emulate_training_timelapse(args.test_objs.split(','), args.output_dir,
                               args.iterations, args.checkpoint_interval,
                               normalize=not args.skip_normalization,
                               device=args.device)
    print(f'wrote Timelapse USDs to {args.output_dir}')
