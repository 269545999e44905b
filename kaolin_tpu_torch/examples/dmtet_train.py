"""DMTet: fitting an SDF + deformation MLP to a point cloud via
differentiable marching tetrahedra.

Behavioral reference: ``examples/tutorial/dmtet_tutorial.ipynb`` +
``dmtet_network.py`` (positional-encoded MLP decoder, sphere SDF
pre-training, chamfer loss on sampled surface points, umbrella-operator
laplacian regularization after the half-way point, Timelapse logging).

One optimization step — MLP forward on the tet lattice, fixed-shape
marching tetrahedra (``marching_tetrahedra_fixed`` over the grid's
topology, found once), area-weighted surface sampling, chamfer,
laplacian — then optax's global-norm clip and ``torch.optim.Adam`` under
the tutorial's ``LambdaLR`` (:func:`dmtet_step`). The random draws come
from one CPU ``torch.Generator`` seeded by ``seed``, so a run gives the
same draws on the card and on the CPU.

Run: ``python -m kaolin_tpu_torch.examples.dmtet_train [--grid-res R]
[--iterations N] [--logs DIR] [--device cpu]``.
"""

import numpy as np
import torch
from torch import nn

from .. import metrics, ops
from .. import visualize
from ..ops.conversions.tetmesh import (marching_tetrahedra_fixed, tet_grid,
                                       tet_topology)
from . import utils

__all__ = ['init_decoder', 'decoder_apply', 'pre_train_sphere',
           'laplace_regularizer', 'train_dmtet', 'Decoder',
           'positional_encoding', 'decoder_from_numpy',
           'clip_by_global_norm_', 'dmtet_loss', 'dmtet_optimizer',
           'dmtet_step', 'torus_points']


# ------------------------------------------------------------- decoder MLP

def positional_encoding(x, multires):
    """NeRF-style encoding: [x, sin(2^i x), cos(2^i x)]
    (``dmtet_network.py:44-77``)."""
    if multires <= 0:
        return x
    bands = 2. ** torch.arange(multires, dtype=x.dtype, device=x.device)
    xs = x[..., None, :] * bands[:, None]               # (..., L, 3)
    enc = torch.cat([torch.sin(xs), torch.cos(xs)], -1)
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], -1)


class Decoder(nn.Module):
    """Bias-free MLP matching ``dmtet_network.Decoder``: SDF + 3-vector
    deformation per query point. ``layers[i].weight`` is the transpose of
    the JAX example's ``params['w'][i]``."""

    def __init__(self, multires=2, internal_dims=128, hidden=5,
                 output_dims=4):
        super().__init__()
        in_dim = 3 * (1 + 2 * multires) if multires > 0 else 3
        dims = [in_dim] + [internal_dims] * hidden + [output_dims]
        self.multires = multires
        self.layers = nn.ModuleList(nn.Linear(a, b, bias=False)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x, multires=None):
        h = positional_encoding(x, self.multires if multires is None
                                else multires)
        # as JAX promotes an encoding of lower precision at the first layer
        h = h.to(self.layers[0].weight.dtype)
        for layer in self.layers[:-1]:
            h = torch.relu(layer(h))
        return self.layers[-1](h)


def init_decoder(key, multires=2, internal_dims=128, hidden=5,
                 output_dims=4, device='cuda'):
    """A :class:`Decoder` on ``device`` with He-normal weights drawn from
    ``key``, a CPU ``torch.Generator`` (the JAX example's PRNG key)."""
    device = utils.check_device(device)
    dec = Decoder(multires, internal_dims, hidden, output_dims)
    with torch.no_grad():
        for layer in dec.layers:
            b, a = layer.weight.shape
            w = torch.randn((a, b), generator=key) \
                * np.float32(np.sqrt(2. / a))
            layer.weight.copy_(w.T)
    return dec.to(device)


def decoder_from_numpy(params, multires=2, device='cuda'):
    """The JAX example's decoder ``{'w': [(a, b) arrays]}`` as a
    :class:`Decoder` on ``device`` with the same weights, in float64 where
    they are float64 (JAX with x64 enabled), else in float32."""
    device = utils.check_device(device)
    ws = [np.asarray(w) for w in params['w']]
    dtype = torch.float64 if ws[0].dtype == np.float64 else torch.float32
    dec = Decoder(multires, ws[0].shape[1], len(ws) - 1,
                  ws[-1].shape[1]).to(dtype)
    assert dec.layers[0].weight.shape[1] == ws[0].shape[0], 'multires'
    with torch.no_grad():
        for layer, w in zip(dec.layers, ws):
            layer.weight.copy_(torch.tensor(w.T))
    return dec.to(device)


def decoder_apply(params, x, multires=2):
    """``params`` (a :class:`Decoder`) at the points ``x`` (..., 3)."""
    return params(x, multires)


def pre_train_sphere(params, key, steps=1000, lr=1e-4, radius=0.3,
                     multires=2):
    """Initializes the SDF head to a sphere |p| - radius
    (``dmtet_network.py:26-40``): Adam on 1024 uniform points a step,
    drawn from ``key`` (a CPU ``torch.Generator``). Trains ``params`` in
    place; returns it and the last step's loss."""
    dev = next(params.parameters()).device
    opt = torch.optim.Adam(params.parameters(), lr=lr)
    loss = None
    for _ in range(steps):
        p = utils.uniform(key, (1024, 3), dev) - 0.5
        ref = torch.sqrt(torch.sum(p * p, dim=-1)) - radius
        opt.zero_grad(set_to_none=True)
        pred = decoder_apply(params, p, multires)[:, 0]
        loss = torch.mean((pred - ref) ** 2)
        loss.backward()
        opt.step()
    return params, float('nan') if loss is None else float(loss.detach())


# ------------------------------------------------------------------ losses

def laplace_regularizer(verts, faces, faces_mask, weights=None):
    """Umbrella-operator laplacian smoothness, masked-face aware
    (``dmtet_tutorial.ipynb`` laplace_regularizer_const)."""
    m = faces_mask.to(verts.dtype)[:, None]
    f = faces.long()
    v0, v1, v2 = verts[f[:, 0]], verts[f[:, 1]], verts[f[:, 2]]
    term = torch.zeros_like(verts)
    term.index_add_(0, f[:, 0], ((v1 - v0) + (v2 - v0)) * m)
    term.index_add_(0, f[:, 1], ((v0 - v1) + (v2 - v1)) * m)
    term.index_add_(0, f[:, 2], ((v0 - v2) + (v1 - v2)) * m)
    deg = verts.new_zeros(verts.shape[0])
    for k in range(3):
        deg.index_add_(0, f[:, k], 2. * m[:, 0])
    term = term / torch.clamp_min(deg, 1.)[:, None]
    return torch.mean(term ** 2)


def clip_by_global_norm_(parameters, max_norm):
    """Clips the gradients of ``parameters`` in place by optax's rule
    (``optax.clip_by_global_norm``): untouched while their global norm is
    below ``max_norm``, else each ``g / norm * max_norm``. Unlike
    ``torch.nn.utils.clip_grad_norm_`` it adds nothing to the norm, and it
    reads nothing back to the host. Returns the norm."""
    grads = [p.grad for p in parameters if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


# ---------------------------------------------------------------- training

def dmtet_loss(params, tet_verts, tets, target, key, grid_res=32,
               multires=2, num_samples=20000, laplacian_weight=0.1,
               lap_on=False):
    """One step's loss: the decoder on the tet lattice ``tet_verts``
    (V, 3), fixed-shape marching tetrahedra over ``tets`` (numpy, or its
    ``tet_topology``), ``num_samples`` area-weighted surface samples (from
    ``key``: a CPU ``torch.Generator`` or the three uniforms), their
    Chamfer distance to ``target`` (1, N, 3), plus the weighted laplacian
    when ``lap_on``."""
    out = decoder_apply(params, tet_verts, multires)
    sdf, deform = out[:, 0], out[:, 1:]
    deformed = tet_verts + torch.tanh(deform) / grid_res
    verts, vmask, faces, fmask, _ = marching_tetrahedra_fixed(
        deformed, tets, sdf)
    areas = ops.mesh.face_areas(verts[None], faces)[0]
    areas = torch.where(fmask, areas, areas.new_zeros(()))
    pred, _ = utils.sample_points(verts[None], faces, num_samples, key,
                                  areas=areas[None])
    chamfer = metrics.pointcloud.chamfer_distance(pred, target).mean()
    if lap_on:
        chamfer = chamfer + laplace_regularizer(
            verts, faces, fmask) * laplacian_weight
    return chamfer


def dmtet_optimizer(params, lr=1e-3):
    """``torch.optim.Adam`` over ``params`` under the tutorial's
    ``LambdaLR``, the rate decayed as ``lr * 10**(-it * 2e-4)``: the JAX
    example's ``optax.adam(sched)``. Returns (optimizer, scheduler)."""
    opt = torch.optim.Adam(params.parameters(), lr=lr)
    return opt, torch.optim.lr_scheduler.LambdaLR(
        opt, lambda it: 10. ** (-it * 2e-4))


def dmtet_step(params, opt, sched, tet_verts, tets, target, key,
               grid_res=32, multires=2, num_samples=20000,
               laplacian_weight=0.1, lap_on=False, grad_clip=1.0):
    """One training step: :func:`dmtet_loss` (same arguments), its
    gradient clipped by :func:`clip_by_global_norm_`, then ``opt`` and
    ``sched`` (from :func:`dmtet_optimizer`) step. Returns the loss, on
    the device, before the step."""
    opt.zero_grad(set_to_none=True)
    loss = dmtet_loss(params, tet_verts, tets, target, key, grid_res,
                      multires, num_samples, laplacian_weight, lap_on)
    loss.backward()
    # Gradient clipping guards MT's edge-interpolation term -sb/(sa-sb): a
    # crossing edge with tiny |sa-sb| spikes the gradient, and one bad
    # step can erase every sign crossing (unrecoverable — with no
    # active faces there is no gradient that recreates the surface).
    clip_by_global_norm_(params.parameters(), grad_clip)
    opt.step()
    sched.step()
    return loss.detach()


def _extract(params, tet_verts, tets, grid_res, multires):
    """The eager marching-tetrahedra mesh of the decoder's surface."""
    with torch.no_grad():
        out = decoder_apply(params, tet_verts, multires)
        deformed = tet_verts + torch.tanh(out[:, 1:]) / grid_res
        return ops.conversions.marching_tetrahedra(deformed[None], tets,
                                                   out[None, :, 0])


def train_dmtet(points, grid_res=32, iterations=1000, lr=1e-3,
                laplacian_weight=0.1, multires=2, num_samples=20000,
                seed=0, logs_path=None, save_every=100, verbose=False,
                grad_clip=1.0, device='cuda'):
    """Fits the decoder so the MT surface matches ``points`` (N, 3).

    Returns (decoder, loss history). Extract the final mesh with
    ``marching_tetrahedra`` (eager) on the deformed grid.
    """
    device = utils.check_device(device)
    # normalize like the reference (slightly inside the grid)
    points = torch.as_tensor(np.asarray(points, np.float32)
                             if not torch.is_tensor(points) else points,
                             dtype=torch.float32, device=device)
    center = (points.amax(0) + points.amin(0)) / 2
    max_l = (points.amax(0) - points.amin(0)).max()
    points = (points - center) / max_l * 0.9
    tet_verts_np, tets = tet_grid(grid_res)
    tet_verts = torch.as_tensor(tet_verts_np, device=device)
    topo = tet_topology(tets, device)

    key = torch.Generator().manual_seed(seed)
    params = init_decoder(key, multires=multires, device=device)
    params, pre_loss = pre_train_sphere(params, key, multires=multires)
    if verbose:
        print(f'pre-trained sphere SDF, loss {pre_loss:.2e}')

    opt, sched = dmtet_optimizer(params, lr)
    target = points[None]

    timelapse = None
    if logs_path is not None:
        timelapse = visualize.Timelapse(logs_path)
        timelapse.add_pointcloud_batch(category='input',
                                       pointcloud_list=[points])

    history = []
    for it in range(iterations):
        history.append(dmtet_step(
            params, opt, sched, tet_verts, topo, target, key, grid_res,
            multires, num_samples, laplacian_weight,
            lap_on=it > iterations // 2, grad_clip=grad_clip))
        if (timelapse or verbose) and (it % save_every == 0
                                       or it == iterations - 1):
            if verbose:
                print(f'iter {it} loss {float(history[-1]):.5f}')
            if timelapse:
                vl, fl = _extract(params, tet_verts, tets, grid_res,
                                  multires)
                timelapse.add_mesh_batch(iteration=it + 1,
                                         category='extracted_mesh',
                                         vertices_list=vl, faces_list=fl)
    history = torch.stack(history).tolist() if history else []
    return params, history


def torus_points(n=50000, seed=0):
    """The default workload: ``n`` points on a torus (R 0.35, r 0.15),
    numpy float64, drawn as the JAX example draws them."""
    rng = np.random.default_rng(seed)
    u, v = rng.uniform(0, 2 * np.pi, (2, n))
    return np.stack([(0.35 + 0.15 * np.cos(v)) * np.cos(u),
                     (0.35 + 0.15 * np.cos(v)) * np.sin(u),
                     0.15 * np.sin(v)], -1)


if __name__ == '__main__':
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument('--grid-res', type=int, default=32)
    ap.add_argument('--iterations', type=int, default=1000)
    ap.add_argument('--logs', default=None)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    _, hist = train_dmtet(torus_points(), grid_res=args.grid_res,
                          iterations=args.iterations,
                          logs_path=args.logs, verbose=True,
                          device=args.device)
    print(f'final chamfer {hist[-1]:.6f}')
