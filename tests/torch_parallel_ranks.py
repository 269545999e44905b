"""The rank program of ``tests/test_torch_parallel.py``, and the seeded
numpy inputs that the test gives ``kaolin_tpu`` too.

Run as ``python torch_parallel_ranks.py TASK INIT_FILE OUT_DIR`` under
:func:`kaolin_tpu_torch.parallel.launch.run_ranks` (which sets ``RANK``
and ``WORLD_SIZE``): each rank joins a gloo world through ``INIT_FILE``,
runs the task's sharded calls on the CPU at float64 and writes its blocks
and gradients to ``OUT_DIR/TASK_RANK.npz``. It imports torch, numpy and
``kaolin_tpu_torch`` only, so that a rank starts in torch's import time.

Tasks: ``all`` (at world 4: the sharded DIB-R and rasterize at meshes
(1, 4), (2, 2) and (4, 1), with the gradients of
``tests/test_parallel.py``'s loss; the three sharded metrics with
gradients on the default mesh; the ray-split trace with and without
``ray_fn`` on a (1, 4) mesh), ``metrics`` (the metrics alone, at world 2)
and ``fail`` (rank 1 raises before the first collective).
"""

import math
import os
import sys

import numpy as np

H, W = 64, 128
MESHES = ((1, 4), (2, 2), (4, 1))
LEVEL = 4
RAY_RES = 16
CAP = 4096
CAMERA = ([0.31, 0.17, 2.5], [0.05, -0.03, 0.], [0., 1., 0.], math.pi / 4)


def render_inputs():
    """``tests/test_parallel.py``'s triangle soup at batch 4 (so that the
    (4, 1) mesh gives each rank a batch row), float64."""
    rng = np.random.default_rng(3)
    B, F = 4, 40
    centers = rng.uniform(-0.8, 0.8, (B, F, 1, 2))
    fvi = centers + rng.uniform(-0.15, 0.15, (B, F, 3, 2))
    fvz = -rng.uniform(1., 3., (B, F, 3))
    ff = rng.normal(size=(B, F, 3, 3))
    fnz = rng.uniform(-1., 1., (B, F))
    return fvz, fvi, ff, fnz


def metric_inputs():
    """``tests/test_parallel.py``'s clouds and faces, float64."""
    rng = np.random.default_rng(0)
    return (rng.random((2, 64, 3)), rng.random((2, 96, 3)),
            rng.random((2, 40, 3, 3)))


def shell_points():
    """2,000 points on a sphere of radius 0.7, float32 (the octree's)."""
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(2000, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return (dirs * 0.7).astype(np.float32)


def _t(a, grad=False):
    import torch
    return torch.tensor(a, requires_grad=grad)


def _iou_loss(kt, mesh, feat, mask, batch):
    """``tests/test_parallel.py``'s loss, ``sum(feat ** 2) * 1e-2 +
    mask_iou(mask, 0.5)``, of the whole image from this rank's block: the
    per-image sums are summed over the mesh (``mesh_sum``)."""
    import torch
    from kaolin_tpu_torch.parallel.mesh import axis, mesh_sum
    ndata, di = axis(mesh, 'data')
    rows = torch.arange(di * (batch // ndata), (di + 1) * (batch // ndata))
    target = torch.full_like(mask, 0.5)
    mul, add = mask * target, mask + target
    up = mul.reshape(mask.shape[0], -1).sum(dim=1)
    down = (add - mul).reshape(mask.shape[0], -1).sum(dim=1)
    zeros = mask.new_zeros(batch)
    sums = mesh_sum(mesh, torch.stack([zeros.index_add(0, rows, up),
                                       zeros.index_add(0, rows, down)]))
    sq = mesh_sum(mesh, (feat ** 2).sum())
    return sq * 1e-2 + (1. - (sums[0] / (sums[1] + 1e-10)).mean())


def _render(kt, out):
    par = kt.parallel
    fvz, fvi, ff, fnz = render_inputs()
    for data, pix in MESHES:
        mesh = par.make_mesh(data=data, pix=pix)
        key = f'{data}x{pix}'
        tvi, tff = _t(fvi, True), _t(ff, True)
        feat, mask, idx = par.sharded_dibr_rasterization(
            mesh, H, W, _t(fvz), tvi, tff, _t(fnz), rast_backend='xla')
        loss = _iou_loss(kt, mesh, feat, mask, fvi.shape[0])
        loss.backward()
        rfeat, ridx = par.sharded_rasterize(
            mesh, H, W, _t(fvz), _t(fvi), [_t(ff[..., :1]), _t(ff[..., 1:])],
            _t(fnz) >= 0.)
        out.update({f'{key}_feat': feat.detach(), f'{key}_mask':
                    mask.detach(), f'{key}_idx': idx, f'{key}_loss':
                    loss.detach(), f'{key}_gvi': tvi.grad, f'{key}_gff':
                    tff.grad, f'{key}_rfeat': rfeat[0], f'{key}_rfeat2':
                    rfeat[1], f'{key}_ridx': ridx})


def _metrics(kt, out):
    import torch
    par = kt.parallel
    mesh = par.make_mesh()
    p1, p2, fv = metric_inputs()
    a, b = _t(p1, True), _t(p2, True)
    dist, idx = par.sharded_sided_distance(mesh, a, b)
    out['sided_dist'], out['sided_idx'] = dist.detach(), idx
    out['sided_g1'], out['sided_g2'] = torch.autograd.grad(dist.sum(),
                                                           [a, b])
    a, b = _t(p1, True), _t(p2, True)
    cham = par.sharded_chamfer_distance(mesh, a, b)
    out['chamfer'] = cham.detach()
    out['chamfer_g1'], out['chamfer_g2'] = torch.autograd.grad(cham.sum(),
                                                               [a, b])
    a, f = _t(p1, True), _t(fv, True)
    dist, fidx, types = par.sharded_point_to_mesh_distance(mesh, a, f)
    out['p2m_dist'], out['p2m_idx'], out['p2m_type'] = (dist.detach(), fidx,
                                                        types)
    out['p2m_gp'], out['p2m_gf'] = torch.autograd.grad(dist.sum(), [a, f])


def _raytrace(kt, out):
    import torch
    par, ops = kt.parallel, kt.ops.spc
    from kaolin_tpu_torch.parallel.spc import plan_sharded_raytrace
    q = ops.quantize_points(torch.tensor(shell_points()), LEVEL)
    octree = ops.unbatched_points_to_octree(q, LEVEL)
    _, pyramids, exsum = ops.scan_octrees(
        octree, torch.tensor([octree.shape[0]]))
    ph = ops.generate_points(octree, pyramids, exsum)
    mesh = par.make_mesh(data=1, pix=4)
    rt = kt.render.spc
    o, d = rt.generate_primary_rays(RAY_RES, RAY_RES, *CAMERA,
                                    dtype=torch.float64, device='cpu')
    ridx, pidx, depth, count = par.sharded_raytrace(mesh, octree, ph, exsum,
                                                    o, d, LEVEL, CAP)
    out.update(octree=octree, ph=ph, exsum=exsum, origin=o, direction=d,
               ridx=ridx, pidx=pidx, depth=depth, count=count)
    ray_fn = rt.primary_rays_fn(RAY_RES, RAY_RES, *CAMERA,
                                dtype=torch.float64, device='cpu')
    sched, cap = plan_sharded_raytrace(4, octree, ph, exsum, o, d, LEVEL,
                                       ray_fn=ray_fn)
    ridx, pidx, depth, count = par.sharded_raytrace(
        mesh, octree, ph, exsum, o, d, LEVEL, cap, cap_schedule=sched,
        ray_fn=ray_fn)
    out.update(fn_ridx=ridx, fn_pidx=pidx, fn_depth=depth, fn_count=count,
               fn_sched=torch.tensor(sched), fn_cap=torch.tensor(cap))


TASKS = {'all': (_render, _metrics, _raytrace), 'metrics': (_metrics,)}


def main(task, init_file, out_dir):
    if task == 'fail' and os.environ['RANK'] == '1':
        # rank 0 waits for it in the rendezvous, the first collective
        raise RuntimeError('rank 1 fails before the collective')
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    import kaolin_tpu_torch as kt
    rank, world = kt.parallel.init_distributed('file://' + init_file,
                                               backend='gloo')
    out = {}
    if task == 'fail':
        dist.all_reduce(torch.ones(1))
    else:
        for part in TASKS[task]:
            part(kt, out)
    np.savez(os.path.join(out_dir, f'{task}_{rank}.npz'),
             **{k: np.asarray(v) for k, v in out.items()})
    dist.destroy_process_group()


if __name__ == '__main__':
    main(*sys.argv[1:4])
