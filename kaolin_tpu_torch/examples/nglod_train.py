"""nglod-style neural SDF on an SPC octree: build the octree from surface
samples, fit multi-level corner features with trilinear interpolation,
render with the SPC raytracer + sphere tracing against the fitted SDF.

Reference workload: BASELINE.md config 5 / the nglod use case called out
in the reference README (``README.md:39``). The fit is a Python loop of
``torch.optim.Adam`` steps whose losses stay on the device until the end.

Run: ``python -m kaolin_tpu_torch.examples.nglod_train [--level L]
[--steps N] [--res R] [--device cpu]``.
"""

import argparse
import math
import time

import numpy as np
import torch

from ..ops.spc import (quantize_points, unbatched_points_to_octree,
                       scan_octrees, generate_points, unbatched_query,
                       unbatched_make_dual, unbatched_make_trinkets,
                       unbatched_interpolate_trilinear)
from ..render.spc import unbatched_raytrace_fixed, generate_primary_rays
from ..render.spc.raytrace import plan_raytrace
from . import utils


def sdf_gt(p):
    """Ground-truth SDF: a sphere of radius 0.6."""
    return torch.sqrt(torch.sum(p * p, dim=-1)) - 0.6


def main(level=6, steps=300, render_res=128, device='cuda'):
    device = utils.check_device(device)
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(20000, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    surf = dirs * 0.6

    # SPC structure (host preprocessing)
    octree = unbatched_points_to_octree(
        quantize_points(torch.as_tensor(surf.astype(np.float32),
                                        device=device), level), level)
    lengths = np.array([octree.shape[0]])
    _, pyramids, exsum = scan_octrees(octree, lengths)
    ph = generate_points(octree, pyramids, exsum)
    phd, pyr_dual = unbatched_make_dual(ph, pyramids[0])
    trinkets, _ = unbatched_make_trinkets(ph, pyramids[0], phd, pyr_dual)
    n_dual = phd.shape[0]
    print(f"octree: level {level}, {ph.shape[0]} nodes, "
          f"{n_dual} dual corners")

    # training points near the surface
    train = surf + rng.normal(0, 0.5 / 2 ** level, surf.shape)
    coords = torch.as_tensor(train.astype(np.float32), device=device)
    pidx = unbatched_query(octree, exsum, coords, level)
    target = sdf_gt(coords)
    valid = pidx >= 0
    num_valid = valid.sum()
    feats = torch.zeros((n_dual, 1), dtype=torch.float32, device=device,
                        requires_grad=True)
    opt = torch.optim.Adam([feats], lr=5e-3)

    def loss_fn(f):
        pred = unbatched_interpolate_trilinear(
            coords[:, None, :], pidx, ph, trinkets, f, level)[:, 0, 0]
        return torch.sum(torch.where(valid, (pred - target) ** 2,
                                     pred.new_zeros(()))) / num_valid

    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(feats)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    losses = torch.stack(losses).cpu().numpy()
    print(f"fit {steps} steps in {time.perf_counter() - t0:.1f}s; "
          f"loss {losses[0]:.5f} -> {losses[-1]:.2e}")

    # render: raytrace to voxel hits, refine depth by sphere tracing the
    # fitted SDF inside each hit interval
    H = W = render_res
    o, d = generate_primary_rays(H, W, (0., 0., 2.0), (0., 0., 0.),
                                 (0., 1., 0.), math.pi / 3, device=device)
    cap = 16 * H * W
    sched = plan_raytrace(octree, ph, exsum, o, d, level, cap=cap)

    with torch.no_grad():
        ridx, pidx_r, depth, count = unbatched_raytrace_fixed(
            octree, ph, exsum, o, d, level, cap, with_exit=True,
            cap_schedule=sched)
        hit_rows = ridx >= 0
        seg = ridx.clamp(min=0).long()
        tmid = 0.5 * (depth[:, 0] + depth[:, 1])
        pts = o[seg] + tmid[:, None] * d[seg]
        sdf_vals = unbatched_interpolate_trilinear(
            pts[:, None, :], pidx_r, ph, trinkets, feats, level)[:, 0, 0]
        # first voxel whose midpoint SDF <= half voxel size wins: the
        # least midpoint depth of a ray's hits; a ray with none stays +inf
        hit = hit_rows & (sdf_vals <= 1.0 / 2 ** level)
        big = torch.where(hit, tmid, tmid.new_full((), math.inf))
        depth_img = torch.full((H * W,), math.inf, dtype=tmid.dtype,
                               device=device).scatter_reduce_(
            0, seg, big, 'amin', include_self=True)
    depth_img = depth_img.reshape(H, W).cpu().numpy()
    covered = np.isfinite(depth_img)
    center = depth_img[H // 2, W // 2]
    print(f"render: coverage {covered.mean():.3f}, center depth "
          f"{center:.3f} (analytic {2.0 - 0.6:.3f})")
    return losses, depth_img


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--level', type=int, default=6)
    p.add_argument('--steps', type=int, default=300)
    p.add_argument('--res', type=int, default=128)
    p.add_argument('--device', default='cuda')
    args = p.parse_args()
    main(level=args.level, steps=args.steps, render_res=args.res,
         device=args.device)
