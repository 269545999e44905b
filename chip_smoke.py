#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``kaolin_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository, on a machine with a CUDA card and
``nvcc``::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``kaolin_tpu_torch/csrc/``, holds
each kernel against its plain PyTorch version on the card at the shapes of
the paths below, and drives five paths, checking that every kernel of each
ran in it:

- the forward render (``prepare_vertices`` -> ``dibr_rasterization`` ->
  ``mask_iou``), at two sizes;
- the train step of ``bench.py`` (the same, then L1 of the features plus
  ``mask_iou``, gradients to the vertices, 20 chained ``v - 1e-7*g``
  steps), at two sizes, timed as ``dibr_512x512_fwd_bwd_ms_per_frame``;
- config 2's textured train step (``bench_suite.py:88-129``: 6-DoF
  ``CameraExtrinsics``, ``rasterize`` of [face UVs, normal z], bilinear
  ``texture_mapping`` times the clipped normal z, L1 to an all-zero
  target, gradients to the vertices, the texture and the camera params,
  20 chained ``x - 1e-6*g`` steps), timed as ``dibr_512_textured_b8_20k``;
- config 3's metrics step (``bench_suite.py:184-202``: ``chamfer_distance``
  between two clouds of 100,000 points and ``point_to_mesh_distance`` from
  100,000 points to 10,000 faces, 20 chained iterations), timed as
  ``chamfer100k_p2m10k``;
- config 3's mesh fit: Adam on a unit icosphere (5,120 faces) toward
  100,000 points on an ellipsoid, through ``sample_points``, Chamfer,
  point-to-mesh and Laplacian terms, then an F-score on 10,000 points.

It then checks the render, the gradient, the textured step and config 3's
fit loss against the plain versions on the CPU on small inputs, fits a
sphere's silhouette to an ellipsoid's with Adam (batch 1, 256x256,
silhouette loss only, ``bench_suite.py``'s config 1), fits a striped
texture and perturbed cameras to four views with Adam
(``examples/dibr_train.py``'s scene), checks ``check_sign`` and
``sdf_to_voxelgrids`` on the card, and times it all with CUDA events and
``torch.profiler``.

Sizes: ``bench.py``'s (batch 4, icosphere subdivision 3 = 1,280 faces,
512x512) and ``bench_suite.py``'s config 2 (batch 8, subdivision 5 =
20,480 faces, 512x512, a 256x256 texture). The silhouette paths render
with 4 features per vertex (camera-space xyz and 1) and with 40 (the same
plus 36 seeded random channels), which takes the wide-feature route; the
train step uses 4. Its silhouette target is the sphere's analytic disc
(with ``bench.py``'s all-zero target the IoU gradient is exactly zero and
the soft-mask backward would have nothing to do).

Output: the card line from ``nvidia-smi``, one line per check, a JSON line
``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``. Any
failed check raises and the script exits non-zero without the last line.
It exits non-zero at once when no CUDA card is visible.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile, schedule

import kaolin_tpu_torch as kt
from kaolin_tpu_torch.kernels import _build
from kaolin_tpu_torch.kernels import nn_distance as kn
from kaolin_tpu_torch.kernels import p2m_distance as kp
from kaolin_tpu_torch.kernels import rasterize as kr
from kaolin_tpu_torch.kernels import rasterize_bwd as krb
from kaolin_tpu_torch.kernels import soft_mask as ks
from kaolin_tpu_torch.kernels import texture as ktex
from kaolin_tpu_torch.kernels.rasterize import _pixel_coords
from kaolin_tpu_torch.render.mesh.dibr import _scaled_inputs
from kaolin_tpu_torch.render.mesh.rasterization import _kernel_inputs
from kaolin_tpu_torch.render.mesh.utils import _clip, _uv_coords

SEED = 0
H = W = 512
SIZES = (('bench', 4, 3), ('config2', 8, 5))   # (name, batch, subdiv)
WIDE = 40                                      # features of the wide route
KNUM = 30                                      # dibr_soft_mask default
TIME_ITERS = 20
TRAIN_STEPS = 20                               # bench.py's ITERS
TRAIN_LR = 1e-7                                # bench.py's step
# the fit: batch 1, 256x256, Adam on the vertices toward an ellipsoid's
# silhouette; the IoU loss must fall by FIT_FACTOR and below FIT_BELOW
FIT_SIZE, FIT_STEPS, FIT_LR = 256, 100, 1e-2
FIT_SCALE = (1.3, 0.75, 1.0)
FIT_FACTOR, FIT_BELOW = 10., 0.05
# config 2's textured step (bench_suite.py:88-129): batch, icosphere
# subdivision, texture size, the chained step's learning rate
TEX_BATCH, TEX_SUBDIV, TEX_SIZE, TEX_LR = 8, 5, 256, 1e-6
# the textured fits (examples/dibr_train.py's scene): views, image size,
# steps, Adam's rates for the texture and the camera params, the largest
# move of each start eye in azimuth and elevation (degrees); fitting the
# texture and the cameras, the image loss must fall by TFIT_FACTOR; the
# cameras alone, the largest eye error by TFIT_EYE_FACTOR (both measured
# first with the plain versions on the CPU at 128x128: 14.07x and 174.7x)
TFIT_VIEWS, TFIT_SIZE, TFIT_STEPS = 4, 256, 100
TFIT_LR_TEX, TFIT_LR_CAM, TFIT_DEG = 2e-2, 2e-3, 4.
TFIT_FACTOR, TFIT_EYE_FACTOR = 5., 10.
# config 3 (bench_suite.py:184-202): chamfer between two clouds of M3_N
# points and point_to_mesh_distance from M3_N points to M3_FACES faces,
# drawn by utils.interop.metrics_scene
M3_N, M3_FACES = 100_000, 10_000
# config 3's mesh fit: a target of FIT3_N points sampled on an ellipsoid
# (icosphere subdivision FIT3_TARGET_SUBDIV scaled by FIT_SCALE), a unit
# icosphere of subdivision FIT3_SUBDIV as the model, FIT3_N samples of it
# per step, Adam at FIT3_LR, the Laplacian term weighted FIT3_LAP; the loss
# must fall by FIT3_FACTOR in FIT3_STEPS steps (measured first with the
# plain versions on the CPU: 24.2x at subdivision 2 / 4,000 points and
# 53.0x at subdivision 3 / 8,000 points, in 100 steps); then the F-score
# of FIT3_EVAL samples of each, the brute-force kernel's size
FIT3_N, FIT3_TARGET_SUBDIV, FIT3_SUBDIV = 100_000, 5, 4
FIT3_STEPS, FIT3_LR, FIT3_LAP, FIT3_FACTOR = 100, 1e-2, 0.1, 20.
FIT3_EVAL, FIT3_RADIUS = 10_000, 0.05
# check_sign: CHECK_N seeded points in [-1.5, 1.5]^3 against the unit
# icosphere of subdivision 5, CHECK_CPU of them also on the CPU
CHECK_N, CHECK_CPU = 100_000, 4096

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# float operations per (pixel, face) pair, counted from the formulas:
# rasterize - 6 subtractions to the pixel, 3 edge functions (2 mul, 1 sub
# each), the normalisation (3 add), 3 divisions, the z interpolation
# (3 mul, 2 add); soft mask - per edge 38 (line coefficients, the foot of
# the perpendicular, its inside test, the distance), per vertex 5, the
# 5-way min, z, exp, 1-p and the product
OPS_RASTER_PAIR = 26
OPS_SOFT_PAIR = 3 * 38 + 3 * 5 + 5 + 3 + 1 + 2
# rasterize backward, per covered pixel: x0, y0 (10), the 6 differences,
# k1..k3 and the guard (11), the dw table (28), dw/dax.. (12), the 2 sums
# over the D channels (6 per channel), 1/k3^2 (3), the 6 outputs and their
# sums (24); w_i * g_d and its sum (6 per channel)
OPS_RBWD_PIXEL, OPS_RBWD_CHANNEL = 94, 12
# soft-mask backward, per recorded pair: the forward's distance work, dLdz
# (6) and the derivative of the nearest edge (44; a vertex takes 6)
OPS_SOFT_BWD_PAIR = OPS_SOFT_PAIR + 6 + 44
# bilinear grid sample, per point: two floors, the fractions and their
# complements, the tap offsets (10); per channel, forward: 8 products and 3
# sums; backward: the coordinate terms (4 differences, 6 products, 4 sums),
# the 4 tap weights (8 products) and their 4 adds into the texture
OPS_GS_POINT, OPS_GS_CHANNEL, OPS_GS_BWD_CHANNEL = 10, 11, 26
# nearest neighbour, per (query, reference) pair: 3 subtractions, 3
# products, 2 sums, 1 compare
OPS_NN_PAIR = 9
# point to mesh, per (point, face) pair: p - v for 3 vertices (9), 3 dots
# with the edges (15) and 3 divisions, 3 dots with the edge normals (15),
# the 6 flags (12 compares), the plane point (a dot, 3 products, 3
# subtractions: 11), the distance (3 subtractions and a dot: 8), the NaN
# test and the compare (2)
OPS_P2M_PAIR = 9 + 15 + 3 + 15 + 12 + 11 + 8 + 2

# stated tolerances, kernel vs plain version on the card (float32): the
# kernels repeat the plain version's operations in its order without fused
# multiply-adds, so face indices must agree exactly; floats may differ only
# where expf and PyTorch's exp do (the soft mask)
TOL_WEIGHTS = 1e-6
TOL_FEATURES = 1e-5
TOL_MASK = 1e-6
# the card's render vs the plain version on the CPU from the same prepared
# vertices: the same arithmetic, so indices agree exactly
TOL_CPU = 1e-5
# gradients, kernel vs plain version on the card and the card vs the CPU:
# every entry within GRAD_TOL of itself plus GRAD_TOL of the median nonzero
# entry (the per-pixel terms are the same, the per-face sums run in other
# orders); a face whose sum is wrong fails however large the largest is
GRAD_TOL = 1e-4
# grid sample, kernel vs plain version on the card: the same operations in
# the same order without fused multiply-adds, so the samples and the
# coordinate gradients are expected bit-equal (held to TOL_SAMPLE and to
# GRAD_TOL entry by entry). The texture gradient adds each texel's terms
# with float32 atomics in no fixed order (as the plain version's
# scatter_add_ does), and a texel may take 10^5 terms (the background
# texel of config 2's step under a random cotangent): it is held against
# the plain version in float64, every entry within GRAD_TOL * (|ref| +
# median nonzero |ref|) plus TOL_ATOMIC times the sum of its terms'
# magnitudes
TOL_SAMPLE = 1e-6
TOL_ATOMIC = 1e-6

KERNELS = {
    'rasterize_interp': ('kaolin_tpu_torch/csrc/rasterize.cu',
                         'kaolin_tpu/kernels/rasterize.py:432'),
    'rasterize_select': ('kaolin_tpu_torch/csrc/rasterize.cu',
                         'kaolin_tpu/kernels/rasterize.py:527'),
    'soft_mask_forward': ('kaolin_tpu_torch/csrc/soft_mask.cu',
                          'kaolin_tpu/kernels/soft_mask.py:418'),
    'rasterize_backward': ('kaolin_tpu_torch/csrc/rasterize_bwd.cu',
                           'kaolin_tpu/kernels/rasterize_bwd.py:159'),
    'soft_mask_backward': ('kaolin_tpu_torch/csrc/soft_mask.cu',
                           'kaolin_tpu/kernels/soft_mask.py:468'),
    'grid_sample': ('kaolin_tpu_torch/csrc/grid_sample.cu',
                    'kaolin_tpu/kernels/texture.py:98'),
    'grid_sample_backward': ('kaolin_tpu_torch/csrc/grid_sample.cu',
                             'kaolin_tpu/kernels/texture.py:176'),
    'nearest_idx': ('kaolin_tpu_torch/csrc/nn_distance.cu',
                    'kaolin_tpu/kernels/nn_distance.py:64'),
    'nearest_idx_pruned': ('kaolin_tpu_torch/csrc/nn_distance.cu',
                           'kaolin_tpu/kernels/nn_distance.py:175'),
    'p2m_select': ('kaolin_tpu_torch/csrc/p2m_distance.cu',
                   'kaolin_tpu/kernels/p2m_distance.py:163'),
}
COUNTERS = (kr.rasterize_interp, kr.rasterize_select, ks.soft_mask_forward,
            krb.rasterize_backward, ks.soft_mask_backward, ktex.grid_sample,
            ktex.grid_sample_backward, kn.nearest_idx, kn.nearest_idx_pruned,
            kp.p2m_select)


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '-i', '0', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters, warmup=True):
    """Mean ms of ``fn()`` on the card over ``iters`` calls, after one
    warm-up call unless the caller has just made one, with CUDA events."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b, mask=None):
    d = (a.double() - b.double()).abs()
    if mask is not None:
        d = d[mask]
    return float(d.max()) if d.numel() else 0.0


def expect(cond, what):
    if not cond:
        raise AssertionError(what)


def disc_radius():
    """Silhouette radius of the unit sphere in image units: each camera
    sits sqrt(3^2 + 0.5^2) from its centre with a 45-degree fovy."""
    d = math.sqrt(3. ** 2 + 0.5 ** 2)
    return math.tan(math.asin(1. / d)) / math.tan(math.pi / 8.)


def disc(device):
    """(1, H, W) mask of the sphere's analytic silhouette."""
    x = (2. * torch.arange(W, device=device) + 1. - W) / W
    y = (H - 2. * torch.arange(H, device=device) - 1.) / H
    return ((x[None, :] ** 2 + y[:, None] ** 2)
            < disc_radius() ** 2).float()[None]


class Scene:
    """One size: the scene, its prepared vertices and the kernels' inputs."""

    def __init__(self, name, batch, subdiv, device):
        self.name, self.batch = name, batch
        verts, faces, rot, trans, proj = kt.utils.interop.scene(
            batch, subdiv, device=device)
        self.args = (verts, faces, rot, trans, proj)
        self.faces = faces
        self.num_faces = faces.shape[0]
        rng = np.random.default_rng(SEED)
        extra = rng.standard_normal((verts.shape[1], WIDE - 4))
        self.extra = torch.tensor(extra, dtype=torch.float32,
                                  device=device)[None].repeat(batch, 1, 1)
        self.target = disc(device).expand(batch, H, W)
        fvc, fvi, fn = kt.render.mesh.prepare_vertices(
            verts, faces, proj, camera_rot=rot, camera_trans=trans)
        self.fz, self.img, self.bbox = _kernel_inputs(
            fvc[..., 2], fvi, fn[..., 2] >= 0., 1000.)
        self.feat4 = self.features(fvc, 4).reshape(batch, -1, 12)
        self.sm_img, self.sm_bbox = _scaled_inputs(fvi, 0.02, 1000.)
        self.fvc, self.fvi = fvc, fvi.reshape(batch, -1, 6)

    def features(self, fvc, dim):
        ones = torch.ones(fvc.shape[:3] + (1,), device=fvc.device)
        parts = [fvc, ones]
        if dim > 4:
            parts.append(kt.ops.mesh.index_vertices_by_faces(self.extra,
                                                             self.faces))
        return torch.cat(parts, dim=-1)

    def forward(self, dim):
        """The user's forward render: prepare_vertices ->
        dibr_rasterization -> mask_iou."""
        verts, faces, rot, trans, proj = self.args
        fvc, fvi, fn = kt.render.mesh.prepare_vertices(
            verts, faces, proj, camera_rot=rot, camera_trans=trans)
        feat, soft_mask, face_idx = kt.render.mesh.dibr_rasterization(
            H, W, fvc[..., 2], fvi, self.features(fvc, dim), fn[..., 2])
        loss = kt.metrics.render.mask_iou(soft_mask, self.target)
        return feat, soft_mask, face_idx, loss

    def train_loss(self, verts, dim=4):
        """``bench.py``'s loss: L1 of the features to 0 plus mask_iou."""
        _, faces, rot, trans, proj = self.args
        fvc, fvi, fn = kt.render.mesh.prepare_vertices(
            verts, faces, proj, camera_rot=rot, camera_trans=trans)
        feat, soft_mask, _ = kt.render.mesh.dibr_rasterization(
            H, W, fvc[..., 2], fvi, self.features(fvc, dim), fn[..., 2])
        return (feat.abs().mean()
                + kt.metrics.render.mask_iou(soft_mask, self.target))

    def train(self, steps):
        """``steps`` chained train steps from the scene's vertices, as a
        user writes them; returns (vertices, losses, last gradient)."""
        v, losses = self.args[0], []
        for _ in range(steps):
            v = v.detach().requires_grad_(True)
            loss = self.train_loss(v)
            g, = torch.autograd.grad(loss, [v])
            v = v.detach() - TRAIN_LR * g
            losses.append(loss.detach())
        return v, losses, g

    def cotangents(self, dim):
        """The train step's cotangents of the features and the soft mask,
        with the face indices and mask they belong to."""
        feat, mask, idx, _ = self.forward(dim)
        feat = feat.detach().requires_grad_(True)
        mask = mask.detach().requires_grad_(True)
        loss = (feat.abs().mean()
                + kt.metrics.render.mask_iou(mask, self.target))
        g_feat, g_mask = torch.autograd.grad(loss, [feat, mask])
        return g_feat, g_mask, idx


class TexturedScene:
    """Config 2's textured train step (``bench_suite.py:88-129``): seeded
    texture and per-vertex UVs, 6-DoF cameras from ``from_lookat`` on a
    ring, an all-zero target."""

    def __init__(self, batch, subdiv, tex_size, height, width, device):
        self.s = kt.utils.interop.textured_scene(batch, subdiv, tex_size,
                                                 seed=SEED, device=device)
        self.batch, self.num_faces = batch, self.s['faces'].shape[0]
        self.target = torch.zeros(batch, height, width, 3, device=device)

    def params(self):
        """(vertices, texture, 6-DoF camera params), the step's leaves."""
        return [self.s[k] for k in ('vertices', 'texture', 'cam_params')]

    def loss(self, verts, tex, cam_params):
        s = self.s
        return kt.utils.interop.textured_loss(
            verts, tex, cam_params, s['faces'], s['face_uvs'],
            s['cam_proj'], self.target)

    def train(self, steps):
        """``steps`` chained steps ``x - TEX_LR * g`` from the scene's
        parameters, as a user writes them; returns (parameters, losses,
        last gradients)."""
        p, losses = self.params(), []
        for _ in range(steps):
            p = [x.detach().requires_grad_(True) for x in p]
            loss = self.loss(*p)
            g = torch.autograd.grad(loss, p)
            p = [x.detach() - TEX_LR * gx for x, gx in zip(p, g)]
            losses.append(loss.detach())
        return p, losses, g

    def sampler_inputs(self):
        """The grid sample's inputs in the step: the texture, the sampler
        coordinates (B, H*W) of the rendered UV map, and the step's
        cotangent of the samples (B, H*W, 3)."""
        s, (_, h, w, _) = self.s, self.target.shape
        with torch.no_grad():
            uv_map, nz_map = kt.utils.interop.textured_maps(
                s['vertices'], s['cam_params'], s['faces'], s['face_uvs'],
                s['cam_proj'], h, w)
        tex = s['texture']
        ix, iy = _uv_coords(uv_map, *tex.shape[2:])
        out = ktex.grid_sample(tex, ix, iy).requires_grad_(True)
        img = out.reshape(self.target.shape) * _clip(nz_map, 0., 1.)
        cot, = torch.autograd.grad(torch.mean(torch.abs(img - self.target)),
                                   [out])
        return tex, ix, iy, cot


def pixel_hits(bbox, height, width):
    """Per pixel, the number of faces whose bbox [xmin, xmax) x [ymin, ymax)
    holds its centre, from each face's column and row ranges (a 2-D
    difference array). (B, H, W) int64."""
    B = bbox.shape[0]
    x0, y0 = _pixel_coords(height, width, 1000., bbox.dtype,
                           device=bbox.device)
    y_up = y0.flip(0).contiguous()
    c_lo = torch.searchsorted(x0, bbox[..., 0].contiguous())
    c_hi = torch.searchsorted(x0, bbox[..., 2].contiguous())
    r_lo = height - torch.searchsorted(y_up, bbox[..., 3].contiguous())
    r_hi = height - torch.searchsorted(y_up, bbox[..., 1].contiguous())
    ok = (c_hi > c_lo) & (r_hi > r_lo)
    diff = torch.zeros((B, height + 1, width + 1), dtype=torch.int64,
                       device=bbox.device)
    b = torch.arange(B, device=bbox.device)[:, None].expand_as(c_lo)[ok]
    ones = torch.ones_like(b)
    for r, c, sign in ((r_lo, c_lo, 1), (r_lo, c_hi, -1), (r_hi, c_lo, -1),
                       (r_hi, c_hi, 1)):
        diff.index_put_((b, r[ok], c[ok]), sign * ones, accumulate=True)
    return diff.cumsum(1).cumsum(2)[:, :height, :width]


def raster_bound(sc, dim, interp):
    """(bound ms, 'bytes' or 'operations') of one rasterize call."""
    B, F = sc.batch, sc.num_faces
    # 4-byte values: z, verts and bbox (13) plus features (3D) per face in;
    # idx, weights, features (4 + D) or zbuf and idx (2) per pixel out
    per_face = 13 + (3 * dim if interp else 0)
    per_pixel = 4 + dim if interp else 2
    nbytes = 4 * (B * F * per_face + B * H * W * per_pixel)
    pairs = int(pixel_hits(sc.bbox, H, W).sum())
    ops = pairs * OPS_RASTER_PAIR
    return bound(nbytes, ops)


def soft_bound(sc, face_idx, knum):
    B, F = sc.batch, sc.num_faces
    # verts and enlarged bbox (10) per face in; idx in and mask out per pixel
    nbytes = 4 * (B * F * 10 + B * H * W * 2)
    hits = pixel_hits(sc.sm_bbox, H, W).clamp(max=knum)
    pairs = int(hits[face_idx < 0].sum())
    return bound(nbytes, pairs * OPS_SOFT_PAIR)


def raster_bwd_bound(sc, face_idx, dim):
    B, F = sc.batch, sc.num_faces
    covered = int((face_idx >= 0).sum())
    # idx at every pixel, grad (D) and weights (3) at covered pixels in;
    # verts and features (6 + 3D) per face in, and their gradients out
    nbytes = 4 * (B * H * W + covered * (dim + 3)
                  + 2 * B * F * (6 + 3 * dim))
    ops = covered * (OPS_RBWD_PIXEL + OPS_RBWD_CHANNEL * dim)
    return bound(nbytes, ops)


def soft_bwd_bound(sm_bbox, cut, grad, knum):
    B, F = sm_bbox.shape[:2]
    hits = pixel_hits(sm_bbox, H, W).clamp(max=knum)
    recorded = (cut >= 0) & (hits > 0)
    live = recorded & (grad != 0)
    # the cut at every pixel, grad where a face recorded the pixel, the
    # mask where grad is also nonzero; verts and enlarged bbox (10) per
    # face in, 6 gradients out
    nbytes = 4 * (B * H * W + int(recorded.sum()) + int(live.sum())
                  + B * F * 16)
    return bound(nbytes, int(hits[live].sum()) * OPS_SOFT_BWD_PAIR)


def grid_sample_bound(maps, points, backward):
    """(bound ms, 'bytes' or 'operations') of one bilinear grid sample of
    ``maps`` (B, C, H, W) at ``points`` (B, P) points."""
    B, C = maps.shape[:2]
    texels, pts = maps.numel(), B * points
    # forward: the texture and ix, iy in, C samples per point out;
    # backward: the texture, ix, iy and the cotangent in, dtex, dix and diy
    # out
    if backward:
        nbytes = 4 * (2 * texels + pts * (4 + C))
        ops = pts * (OPS_GS_POINT + OPS_GS_BWD_CHANNEL * C)
    else:
        nbytes = 4 * (texels + pts * (2 + C))
        ops = pts * (OPS_GS_POINT + OPS_GS_CHANNEL * C)
    return bound(nbytes, ops)


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def kernel_phases(sc):
    """Each kernel against its plain version on the card, at this size's
    shapes, then both timed. Returns ({kernel: max abs error},
    {kernel: times})."""
    errs = {}

    def record(name, err):
        errs[name] = max(errs.get(name, 0.), err)

    kw = dict(height=H, width=W, multiplier=1000., eps=1e-8)

    # interp, D = 4, with normal-z culling
    args = (sc.fz, sc.img, sc.bbox, sc.feat4)
    feat_k, idx_k, w_k = kr.rasterize_interp(*args, **kw)
    feat_p, idx_p, w_p = kr.rasterize_interp_plain(*args, **kw)
    torch.cuda.synchronize()
    mism = int((idx_k != idx_p).sum())
    ew, ef = max_err(w_k, w_p), max_err(feat_k, feat_p)
    log(f'[{sc.name}] rasterize_interp D=4: face_idx mismatches {mism}, '
        f'covered {float((idx_k >= 0).float().mean()):.4f}, '
        f'max err weights {ew:.3e} features {ef:.3e}')
    expect(mism == 0 and ew <= TOL_WEIGHTS and ef <= TOL_FEATURES,
           'rasterize_interp disagrees with its plain version')
    record('rasterize_interp', max(ew, ef))
    idx_main = idx_k

    # select, D = 40
    z_k, sidx_k = kr.rasterize_select(sc.fz, sc.img, sc.bbox, **kw)
    z_p, sidx_p = kr.rasterize_select_plain(sc.fz, sc.img, sc.bbox, **kw)
    torch.cuda.synchronize()
    mism = int((sidx_k != sidx_p).sum())
    cov = sidx_k >= 0
    ez = max_err(z_k, z_p, cov)
    expect(bool(torch.isneginf(z_k[~cov]).all()), 'select: uncovered zbuf')
    log(f'[{sc.name}] rasterize_select: face_idx mismatches {mism} '
        f'(vs interp {int((sidx_k != idx_k).sum())}), max err zbuf {ez:.3e}')
    expect(mism == 0 and ez <= TOL_WEIGHTS and bool((sidx_k == idx_k).all()),
           'rasterize_select disagrees with its plain version')
    record('rasterize_select', ez)

    # soft mask: the default knum, one that never binds, one that binds
    hits = pixel_hits(sc.sm_bbox, H, W)[idx_main < 0]
    log(f'[{sc.name}] soft mask: most enlarged-bbox hits on an uncovered '
        f'pixel {int(hits.max())}')
    for knum in (KNUM, sc.num_faces, 2):
        skw = dict(height=H, width=W, knum=knum, sigmainv=7000.,
                   multiplier=1000.)
        m_k, c_k = ks.soft_mask_forward(sc.sm_img, sc.sm_bbox, idx_main,
                                        return_cut=True, **skw)
        m_p, c_p = ks.soft_mask_forward_plain(sc.sm_img, sc.sm_bbox,
                                              idx_main, return_cut=True,
                                              **skw)
        torch.cuda.synchronize()
        em = max_err(m_k, m_p)
        cut_mism = int((c_k != c_p).sum())
        binds = int((hits > knum).sum())
        log(f'[{sc.name}] soft_mask_forward knum={knum}: pixels where knum '
            f'binds {binds}, max err {em:.3e}, cut mismatches {cut_mism}')
        expect(em <= TOL_MASK and cut_mism == 0, 'soft_mask_forward '
               f'disagrees with its plain version at knum={knum}')
        record('soft_mask_forward', em)

    # slab with culling: rows 128..319 of the 512-row image
    r0, hs = H // 4, 3 * H // 8
    f_k, i_k, w_k = kr.rasterize_interp(
        *args, row_start=r0, height=hs, width=W, total_height=H,
        multiplier=1000., eps=1e-8)
    f_p, i_p, w_p = kr.rasterize_interp_plain(
        *args, row_start=r0, height=hs, width=W, total_height=H,
        multiplier=1000., eps=1e-8)
    torch.cuda.synchronize()
    mism = int((i_k != i_p).sum())
    slab_vs_full = int((i_k != idx_main[:, r0:r0 + hs]).sum())
    ef = max(max_err(f_k, f_p), max_err(w_k, w_p))
    log(f'[{sc.name}] rasterize_interp slab rows {r0}..{r0 + hs - 1}: '
        f'face_idx mismatches {mism}, vs full image {slab_vs_full}, '
        f'max err {ef:.3e}')
    expect(mism == 0 and slab_vs_full == 0 and ef <= TOL_FEATURES,
           'rasterize_interp slab disagrees')
    record('rasterize_interp', ef)

    times = {}
    sel = (sc.fz, sc.img, sc.bbox)
    skw = dict(height=H, width=W, knum=KNUM, sigmainv=7000.,
               multiplier=1000.)
    plain_iters = 3 if sc.num_faces < 4096 else 1
    for name, fn, plain, bnd in (
            ('rasterize_interp',
             lambda: kr.rasterize_interp(*args, **kw),
             lambda: kr.rasterize_interp_plain(*args, **kw),
             raster_bound(sc, 4, True)),
            ('rasterize_select',
             lambda: kr.rasterize_select(*sel, **kw),
             lambda: kr.rasterize_select_plain(*sel, **kw),
             raster_bound(sc, 0, False)),
            ('soft_mask_forward',
             lambda: ks.soft_mask_forward(sc.sm_img, sc.sm_bbox, idx_main,
                                          **skw),
             lambda: ks.soft_mask_forward_plain(sc.sm_img, sc.sm_bbox,
                                                idx_main, **skw),
             soft_bound(sc, idx_main, KNUM))):
        times[name] = dict(ms=time_ms(fn, TIME_ITERS),
                           plain_ms=time_ms(plain, plain_iters),
                           bound_ms=bnd[0], bound_by=bnd[1])
        log(f'[{sc.name}] time {name}: ' + json.dumps(times[name]))
    return errs, times


def grad_close(label, out, ref):
    """Prints and checks a gradient against its reference entry by entry:
    |out - ref| <= GRAD_TOL * (|ref| + median nonzero |ref|). Returns the
    largest absolute error."""
    d = (out.double() - ref.double()).abs()
    r = ref.double().abs()
    nonzero = r[r != 0]
    med = float(nonzero.median()) if nonzero.numel() else 0.
    ratio = float((d / (GRAD_TOL * (r + med)).clamp(min=1e-300)).max())
    err = float(d.max())
    log(f'{label}: max abs err {err:.3e}, largest |ref| {float(r.max()):.3e}, '
        f'median nonzero |ref| {med:.3e}, worst entry at {ratio:.3e} of its '
        f'tolerance {GRAD_TOL:g} * (|ref| + median), finite '
        f'{bool(torch.isfinite(out).all())}')
    expect(med > 0. and ratio <= 1. and bool(torch.isfinite(out).all()),
           f'{label}: out of tolerance')
    return err


def grad_errors(label, out, again, ref):
    """Checks the kernel's gradients against the plain version's and two
    launches against each other; returns the largest absolute error."""
    worst = 0.
    for name, o, a, r in zip(('image verts', 'features'), out, again, ref):
        same = bool(torch.equal(o, a))
        worst = max(worst, grad_close(f'{label} grad {name}', o, r))
        log(f'{label} grad {name}: two launches bit-identical {same}')
        expect(same, f'{label}: two launches differ')
    return worst


def backward_phases(sc):
    """Each backward kernel against its plain version on the card, at this
    size's shapes, with a seeded random cotangent and the train step's
    own; then each timed with the train step's. At config2's face count
    the soft mask's plain version runs on the first batch element only.
    Returns ({kernel: max abs error}, {kernel: times}); the key
    'rasterize_backward' is D = 4, the train step's width."""
    errs = dict.fromkeys(('rasterize_backward', 'soft_mask_backward'), 0.)
    times = {}
    gen = torch.Generator('cuda').manual_seed(SEED)
    nb = sc.batch if sc.num_faces < 4096 else 1
    plain_iters = 3 if sc.num_faces < 4096 else 1

    def timed(key, fn, plain, bnd, plain_batch):
        times[key] = dict(ms=time_ms(fn, TIME_ITERS),
                          plain_ms=time_ms(plain, plain_iters),
                          bound_ms=bnd[0], bound_by=bnd[1])
        log(f'[{sc.name}] time {key} (train cotangents; plain version at '
            f'batch {plain_batch}): ' + json.dumps(times[key]))

    for dim in (4, WIDE):
        feats = sc.features(sc.fvc, dim).reshape(sc.batch, -1, 3 * dim)
        _, idx, weights = kr.rasterize_interp(
            sc.fz, sc.img, sc.bbox, feats, height=H, width=W,
            multiplier=1000., eps=1e-8)
        g_feat, g_mask, _ = sc.cotangents(dim)
        rand = torch.randn(g_feat.shape, device='cuda', generator=gen)
        for cot_name, cot in (('random', rand), ('train', g_feat)):
            args = (cot, idx, weights, sc.fvi, feats)
            out = krb.rasterize_backward(*args, eps=1e-8)
            again = krb.rasterize_backward(*args, eps=1e-8)
            ref = krb.rasterize_backward_plain(*args, eps=1e-8)
            torch.cuda.synchronize()
            errs['rasterize_backward'] = max(
                errs['rasterize_backward'], grad_errors(
                    f'[{sc.name}] rasterize_backward D={dim} {cot_name} '
                    'cotangent', out, again, ref))
        timed('rasterize_backward' + ('' if dim == 4 else f' D={dim}'),
              lambda: krb.rasterize_backward(*args, eps=1e-8),
              lambda: krb.rasterize_backward_plain(*args, eps=1e-8),
              raster_bwd_bound(sc, idx, dim), sc.batch)

    # the mask's cotangent does not depend on the feature width
    rand = torch.randn(g_mask.shape, device='cuda', generator=gen)
    skw = dict(height=H, width=W, sigmainv=7000., multiplier=1000.)
    for knum, cot_name, cot in ((KNUM, 'random', rand),
                                (2, 'train', g_mask),
                                (KNUM, 'train', g_mask)):
        mask, cut = ks.soft_mask_forward(sc.sm_img, sc.sm_bbox, idx,
                                         knum=knum, return_cut=True, **skw)
        args = (sc.sm_img, sc.sm_bbox, cut, mask, cot)
        out = ks.soft_mask_backward(*args, **skw)
        again = ks.soft_mask_backward(*args, **skw)
        ref = ks.soft_mask_backward_plain(*(a[:nb] for a in args), **skw)
        torch.cuda.synchronize()
        errs['soft_mask_backward'] = max(
            errs['soft_mask_backward'], grad_errors(
                f'[{sc.name}] soft_mask_backward knum={knum} {cot_name} '
                f'cotangent (plain on {nb} of {sc.batch})',
                (out[:nb],), (again[:nb],), (ref,)))
    timed('soft_mask_backward', lambda: ks.soft_mask_backward(*args, **skw),
          lambda: ks.soft_mask_backward_plain(*(a[:nb] for a in args),
                                              **skw),
          soft_bwd_bound(sc.sm_bbox, cut, g_mask, KNUM), nb)
    return errs, times


def grid_sample_checks(label, maps, ix, iy, cots, errs):
    """Both grid-sample kernels against their plain versions, in both
    modes, for each (name, cotangent) of ``cots``; the largest errors go
    into ``errs``."""
    for mode in ('bilinear', 'nearest'):
        out = ktex.grid_sample(maps, ix, iy, mode)
        ref = ktex.grid_sample_plain(maps, ix, iy, mode)
        torch.cuda.synchronize()
        e = max_err(out, ref)
        log(f'[{label}] grid_sample {mode}: max err {e:.3e} (tolerance '
            f'{TOL_SAMPLE:g}), bit-equal {bool(torch.equal(out, ref))}')
        expect(e <= TOL_SAMPLE, f'[{label}] grid_sample {mode} disagrees '
               'with its plain version')
        errs['grid_sample'] = max(errs['grid_sample'], e)
        for cot_name, cot in cots:
            tag = f'[{label}] grid_sample_backward {mode} {cot_name} cotangent'
            out = ktex.grid_sample_backward(maps, ix, iy, cot, mode)
            again = ktex.grid_sample_backward(maps, ix, iy, cot, mode)
            ref = ktex.grid_sample_backward_plain(maps, ix, iy, cot, mode)
            torch.cuda.synchronize()
            worst = atomic_close(f'{tag} grad texture', out[0], ref[0],
                                 maps, ix, iy, cot, mode)
            log(f'{tag} grad texture: largest difference between two '
                f'launches {max_err(out[0], again[0]):.3e}')
            for name, o, a, r in zip(('ix', 'iy'), out[1:], again[1:],
                                     ref[1:]):
                if mode == 'nearest':
                    expect(not o.any() and not r.any(),
                           f'{tag}: nonzero grad {name}')
                    log(f'{tag} grad {name}: exactly 0, as the plain '
                        'version')
                else:
                    worst = max(worst, grad_close(f'{tag} grad {name}', o, r))
                same, exact = bool(torch.equal(o, a)), bool(torch.equal(o, r))
                log(f'{tag} grad {name}: two launches bit-identical {same}, '
                    f'bit-equal to the plain version {exact}')
                expect(same, f'{tag}: two launches differ in grad {name}')
            errs['grid_sample_backward'] = max(errs['grid_sample_backward'],
                                               worst)


def atomic_close(label, out, plain, maps, ix, iy, cot, mode):
    """Checks a texture gradient summed with atomics against the plain
    version in float64, entry by entry: |out - ref| <= GRAD_TOL * (|ref| +
    median nonzero |ref|) + TOL_ATOMIC * (the sum of the entry's terms'
    magnitudes). Prints the float32 plain version's ratio under the same
    rule beside the kernel's; returns the kernel's largest absolute
    error."""
    f64 = [t.double() for t in (maps, ix, iy, cot)]
    ref = ktex.grid_sample_backward_plain(*f64, mode)[0]
    mass = ktex.grid_sample_backward_plain(*f64[:3], f64[3].abs(), mode)[0]
    r = ref.abs()
    nonzero = r[r != 0]
    med = float(nonzero.median()) if nonzero.numel() else 0.
    tol = (GRAD_TOL * (r + med) + TOL_ATOMIC * mass).clamp(min=1e-300)
    d = (out.double() - ref).abs()
    ratio = float((d / tol).max())
    plain_ratio = float(((plain.double() - ref).abs() / tol).max())
    log(f'{label}: max abs err {float(d.max()):.3e} against the float64 '
        f'plain version, largest |ref| {float(r.max()):.3e}, median nonzero '
        f'|ref| {med:.3e}, most terms\' magnitude in one entry '
        f'{float(mass.max()):.3e}; worst entry at {ratio:.3e} of its '
        f'tolerance {GRAD_TOL:g} * (|ref| + median) + {TOL_ATOMIC:g} * '
        f'magnitude (the float32 plain version at {plain_ratio:.3e}), '
        f'finite {bool(torch.isfinite(out).all())}')
    expect(med > 0. and ratio <= 1. and bool(torch.isfinite(out).all()),
           f'{label}: out of tolerance')
    return float(d.max())


def texture_phases(tsc):
    """Both grid-sample kernels against their plain versions on the card:
    at config 2's step (its 256x256 texture at the rendered UV map, with
    the step's cotangent and a random one), and at random coordinates over
    that texture and over a random 64x64 one (inside the JAX kernel's
    128x128 domain). Then both timed at the step's inputs, beside
    ``F.grid_sample``. Returns ({kernel: max abs error}, {kernel: times})."""
    tex, ix, iy, cot = tsc.sampler_inputs()
    B, C, th, tw = tex.shape
    P = ix.shape[1]
    gen = torch.Generator('cuda').manual_seed(SEED)

    def rand_coords(h, w):
        return (torch.rand(B, P, device='cuda', generator=gen) * (w - 1),
                torch.rand(B, P, device='cuda', generator=gen) * (h - 1))

    rand_cot = torch.randn(cot.shape, device='cuda', generator=gen)
    small = torch.rand(B, C, 64, 64, device='cuda', generator=gen)
    uncovered = float((cot == 0).all(-1).float().mean())
    log(f'[textured] {B}x{P} sample points, {uncovered:.4f} of them with a '
        'zero cotangent in the step')
    errs = dict.fromkeys(('grid_sample', 'grid_sample_backward'), 0.)
    grid_sample_checks('config2 UV map', tex, ix, iy,
                       (('train', cot), ('random', rand_cot)), errs)
    grid_sample_checks(f'{th}x{tw} random coords', tex,
                       *rand_coords(th, tw), (('random', rand_cot),), errs)
    grid_sample_checks('64x64 random coords', small, *rand_coords(64, 64),
                       (('random', rand_cot),), errs)

    # the library's yardstick: the same points as a normalised grid
    grid = torch.stack([(2. * ix + 1.) / tw - 1., (2. * iy + 1.) / th - 1.],
                       -1)[:, None]
    cot_lib = cot.transpose(1, 2).reshape(B, C, 1, P).contiguous()

    def lib_fwd():
        return F.grid_sample(tex, grid, 'bilinear', 'border',
                             align_corners=False)

    def lib_bwd():
        return torch.ops.aten.grid_sampler_2d_backward(
            cot_lib, tex, grid, 0, 1, False, [True, True])

    e_lib = max_err(lib_fwd()[:, :, 0].transpose(1, 2),
                    ktex.grid_sample(tex, ix, iy))
    log(f'[textured] F.grid_sample vs the kernel at the step: max diff '
        f'{e_lib:.3e}')
    shape = (f'texture {B}x{C}x{th}x{tw} at {B}x{P} points (config 2 '
             f'step, {tsc.num_faces} faces, {H}x{W})')
    times = {}
    for name, fn, plain, lib, backward in (
            ('grid_sample', lambda: ktex.grid_sample(tex, ix, iy),
             lambda: ktex.grid_sample_plain(tex, ix, iy), lib_fwd, False),
            ('grid_sample_backward',
             lambda: ktex.grid_sample_backward(tex, ix, iy, cot),
             lambda: ktex.grid_sample_backward_plain(tex, ix, iy, cot),
             lib_bwd, True)):
        bnd = grid_sample_bound(tex, P, backward)
        times[name] = dict(ms=time_ms(fn, TIME_ITERS),
                           plain_ms=time_ms(plain, 3),
                           library_ms=time_ms(lib, TIME_ITERS),
                           bound_ms=bnd[0], bound_by=bnd[1], shape=shape)
        log(f'[textured] time {name} (the step\'s cotangent): '
            + json.dumps(times[name]))
    rand_ms = time_ms(lambda: ktex.grid_sample_backward(tex, ix, iy,
                                                        rand_cot), TIME_ITERS)
    log(f'[textured] time grid_sample_backward with a random cotangent, '
        f'nonzero on the background too: {rand_ms:.4f} ms')
    return errs, times


def reset_counters():
    for c in COUNTERS:
        c.launches = 0


def read_counters(path):
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in COUNTERS}
    log(f'{path} launches: ' + json.dumps(launches))
    return launches


def main_path(scenes):
    """The forward render, as a user calls it, once per (size, width);
    returns the launches of each kernel in it."""
    reset_counters()
    outs = {}
    for sc in scenes:
        for dim in (4, WIDE):
            outs[sc.name, dim] = sc.forward(dim)
    launches = read_counters('forward path')
    for name in ('rasterize_interp', 'rasterize_select', 'soft_mask_forward'):
        expect(launches[name] > 0,
               f'{name} was not launched on the forward path')

    sphere_cover = math.pi * disc_radius() ** 2 / 4.
    for (name, dim), (feat, mask, idx, loss) in outs.items():
        sc = next(s for s in scenes if s.name == name)
        expect(tuple(feat.shape) == (sc.batch, H, W, dim)
               and tuple(mask.shape) == (sc.batch, H, W)
               and tuple(idx.shape) == (sc.batch, H, W), 'output shapes')
        cov = float((idx >= 0).float().mean())
        soft = float(mask.mean())
        log(f'[{name}] D={dim}: coverage {cov:.4f} (sphere '
            f'{sphere_cover:.4f}), mean soft mask {soft:.4f}, mask_iou vs '
            f'the sphere silhouette {float(loss):.4f}')
        expect(bool(torch.isfinite(feat).all() and torch.isfinite(mask).all()
                    and torch.isfinite(loss)), 'non-finite output')
        expect(abs(cov - sphere_cover) < 0.02 and soft >= cov
               and float(mask.min()) >= 0. and float(mask.max()) <= 1.
               and float(loss) < 0.1, 'implausible coverage or soft mask')
        expect(bool((idx == outs[name, 4][2]).all()),
               'face_idx depends on the feature width')
    return launches, outs


def train_path(scenes):
    """The train step, as a user writes it, TRAIN_STEPS chained steps per
    size; returns the launches of each kernel in it."""
    reset_counters()
    outs = [(sc, sc.train(TRAIN_STEPS)) for sc in scenes]
    launches = read_counters('train path')
    # D = 4 takes the fused route: the select mode is not on this path
    for name in ('rasterize_interp', 'soft_mask_forward',
                 'rasterize_backward', 'soft_mask_backward'):
        expect(launches[name] > 0,
               f'{name} was not launched on the train path')
    for sc, (v, losses, g) in outs:
        gmax = float(g.abs().max())
        moved = float((v - sc.args[0]).abs().max())
        log(f'[{sc.name}] train: loss {float(losses[0]):.6f} -> '
            f'{float(losses[-1]):.6f} over {TRAIN_STEPS} steps, largest '
            f'|grad| {gmax:.4e}, vertices moved by up to {moved:.3e}')
        expect(bool(torch.isfinite(g).all() and torch.isfinite(v).all())
               and all(bool(torch.isfinite(x)) for x in losses)
               and gmax > 0., f'[{sc.name}] train step: non-finite or zero '
               'gradient')
    return launches


def textured_path(tsc):
    """Config 2's textured train step, as a user writes it, TRAIN_STEPS
    chained steps; returns the launches of each kernel in it."""
    reset_counters()
    p, losses, g = tsc.train(TRAIN_STEPS)
    launches = read_counters('textured path')
    for name in ('rasterize_interp', 'rasterize_backward', 'grid_sample',
                 'grid_sample_backward'):
        expect(launches[name] > 0,
               f'{name} was not launched on the textured path')
    for name in ('soft_mask_forward', 'soft_mask_backward'):
        expect(launches[name] == 0, f'{name} ran on the textured path')
    log(f'[textured] train: loss {float(losses[0]):.6f} -> '
        f'{float(losses[-1]):.6f} over {TRAIN_STEPS} steps')
    expect(all(bool(torch.isfinite(x)) for x in losses),
           'textured step: non-finite loss')
    for name, gx, x0, x in zip(('vertices', 'texture', '6-DoF params'), g,
                               tsc.params(), p):
        gmax = float(gx.abs().max())
        log(f'[textured] grad {name}: largest |grad| {gmax:.4e}, nonzero '
            f'share {float((gx != 0).float().mean()):.4f}, moved by up to '
            f'{float((x - x0).abs().max()):.3e}')
        expect(bool(torch.isfinite(gx).all() and torch.isfinite(x).all())
               and gmax > 0., f'textured step: non-finite or zero gradient '
               f'to the {name}')
    return launches


def profile_calls(label, fn, per_call_ms, iters=10):
    """Device time of ``fn`` by kernel (``torch.profiler``), and the share
    of the call's time the card is idle."""
    warmup = 2
    traces = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warmup, active=iters),
                 on_trace_ready=lambda p: traces.append(p.key_averages())
                 ) as prof:
        for _ in range(warmup + iters):
            fn()
            torch.cuda.synchronize()
            prof.step()
    # the schedule's step markers are device-side ranges, not kernels
    kernels = [e for e in traces[0]
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not e.key.startswith('ProfilerStep')]
    if not kernels:
        log(f'{label}: no device time in the trace; busy share not '
            'measured')
        return
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    log(f'{label}: device busy {busy_ms:.4f} ms of {per_call_ms:.4f} ms per '
        f'call, idle share {1. - busy_ms / per_call_ms:.3f}, '
        f'{len(kernels)} kernels')
    for e in kernels[:12]:
        log(f'    {e.self_device_time_total / 1e3 / iters:.4f} ms in '
            f'{e.count / iters:g} launches: {e.key[:70]}')


def check_against_cpu():
    """A small render on the card against the plain versions on the CPU,
    from the same prepared vertices."""
    verts, faces, rot, trans, proj = kt.utils.interop.scene(2, 2,
                                                            device='cuda')
    fvc, fvi, fn = kt.render.mesh.prepare_vertices(
        verts, faces, proj, camera_rot=rot, camera_trans=trans)
    ff = torch.cat([fvc, torch.ones(fvc.shape[:3] + (1,), device='cuda')],
                   dim=-1)
    h, w = 96, 136
    gpu = kt.render.mesh.dibr_rasterization(h, w, fvc[..., 2], fvi, ff,
                                            fn[..., 2])
    cpu = kt.render.mesh.dibr_rasterization(h, w, fvc[..., 2].cpu(),
                                            fvi.cpu(), ff.cpu(),
                                            fn[..., 2].cpu())
    mism = int((gpu[2].cpu() != cpu[2]).sum())
    ef, em = max_err(gpu[0].cpu(), cpu[0]), max_err(gpu[1].cpu(), cpu[1])
    log(f'card vs CPU plain at 2x{h}x{w}: face_idx mismatches {mism}, '
        f'max err features {ef:.3e} soft mask {em:.3e}')
    expect(mism == 0 and ef <= TOL_CPU and em <= TOL_CPU,
           'the card disagrees with the CPU')

    def grad_of(device):
        v = verts.detach().to(device).requires_grad_(True)
        fvc, fvi, fn = kt.render.mesh.prepare_vertices(
            v, faces.to(device), proj.to(device), camera_rot=rot.to(device),
            camera_trans=trans.to(device))
        ff = torch.cat([fvc, torch.ones(fvc.shape[:3] + (1,),
                                        device=device)], dim=-1)
        feat, mask, _ = kt.render.mesh.dibr_rasterization(
            h, w, fvc[..., 2], fvi, ff, fn[..., 2])
        target = torch.roll(mask.detach(), 5, dims=2)
        loss = feat.abs().mean() + kt.metrics.render.mask_iou(mask, target)
        return torch.autograd.grad(loss, [v])[0]

    grad_close('card vs CPU plain, gradient to the vertices of L1 + '
               'mask_iou', grad_of('cuda').cpu(), grad_of('cpu'))


def check_textured_against_cpu():
    """Config 2's loss at a small size (batch 2, 320 faces, 24x40, a 16x16
    texture) on the card against the plain versions on the CPU: the loss,
    then its gradients to the vertices, the texture and the 6-DoF params
    entry by entry."""
    s = kt.utils.interop.textured_scene(2, 2, 16, seed=SEED, device='cuda')

    def grads(device):
        p = [s[k].to(device).detach().requires_grad_(True)
             for k in ('vertices', 'texture', 'cam_params')]
        loss = kt.utils.interop.textured_loss(
            *p, s['faces'].to(device), s['face_uvs'].to(device),
            s['cam_proj'].to(device), torch.zeros(2, 24, 40, 3,
                                                  device=device))
        return loss, torch.autograd.grad(loss, p)

    (lg, gpu), (lc, cpu) = grads('cuda'), grads('cpu')
    lg, lc = lg.item(), lc.item()
    rel = abs(lg - lc) / abs(lc)
    log(f'card vs CPU plain, textured loss at 2x24x40: {lg:.8f} vs {lc:.8f}, '
        f'relative difference {rel:.3e} (tolerance 1e-5)')
    expect(rel <= 1e-5, 'the textured loss on the card disagrees with the '
           'CPU')
    for name, g, c in zip(('vertices', 'texture', '6-DoF params'), gpu, cpu):
        grad_close(f'card vs CPU plain, textured gradient to the {name}',
                   g.cpu(), c)


def texture_fit(fit_texture, device='cuda', size=TFIT_SIZE, steps=TFIT_STEPS):
    """Canonical drive 1 with a texture, on ``examples/dibr_train.py``'s
    scene: an icosphere (subdivision 2) with spherical UVs seen by
    TFIT_VIEWS cameras on a ring (radius 3, 0.4 up), a striped 64x64 target
    texture. The start cameras are 6-DoF, their eyes moved by up to
    TFIT_DEG degrees in azimuth and elevation. Adam fits the camera params,
    and with ``fit_texture`` a texture that starts flat at 0.5 (else the
    target texture stays), to the target images (image L1 of
    ``textured_render``). Returns (losses, largest eye error before, and
    after)."""
    verts_np, faces_np = kt.utils.interop.icosphere(2)
    theta = np.arctan2(verts_np[:, 0], verts_np[:, 2])
    phi = np.arcsin(np.clip(verts_np[:, 1], -1., 1.))
    uvs = np.stack([theta / (2 * np.pi) + 0.5, phi / np.pi + 0.5], -1)
    stripes = np.ones((1, 3, 64, 64), np.float32)
    stripes[:, 0, ::8] = 0.1
    true_tex, uvs = kt.utils.interop.texture_from_numpy(
        stripes, uvs[None].astype(np.float32), device=device)
    faces = torch.as_tensor(faces_np, dtype=torch.int64, device=device)
    face_uvs = kt.ops.mesh.index_vertices_by_faces(uvs, faces)
    verts = torch.as_tensor(verts_np, device=device)
    proj = kt.render.camera.generate_perspective_projection(math.pi / 4.,
                                                            device=device)
    n = TFIT_VIEWS

    def cameras(azim, elev):
        a = np.linspace(0., 2 * np.pi, n, endpoint=False) + np.radians(azim)
        e = np.arctan2(0.4, 3.) + np.radians(elev)
        r = math.hypot(3., 0.4)
        eye = np.stack([r * np.cos(e) * np.sin(a), r * np.sin(e) * np.ones(n),
                        r * np.cos(e) * np.cos(a)], -1)
        return kt.render.camera.CameraExtrinsics.from_lookat(
            eye, np.zeros((n, 3)), np.tile([[0., 1., 0.]], (n, 1)),
            dtype=torch.float32, backend='matrix_6dof_rotation',
            device=device)

    def render(tex, cam_params):
        return kt.utils.interop.textured_render(
            verts, tex.expand(n, -1, -1, -1), cam_params, faces, face_uvs,
            proj, size, size)

    true_cams = cameras(0., 0.)
    rng = np.random.default_rng(SEED)
    start = cameras(*rng.uniform(-TFIT_DEG, TFIT_DEG, (2, n)))

    def eye_err(cam_params):
        cams = kt.render.camera.CameraExtrinsics(
            cam_params.detach(), backend='matrix_6dof_rotation')
        return float((cams.cam_pos() - true_cams.cam_pos()).norm(dim=1).max())

    with torch.no_grad():
        target = render(true_tex, true_cams.parameters())
    cam_params = start.parameters().clone().requires_grad_(True)
    groups = [{'params': [cam_params], 'lr': TFIT_LR_CAM}]
    tex = true_tex
    if fit_texture:
        tex = torch.full_like(true_tex, 0.5).requires_grad_(True)
        groups.append({'params': [tex], 'lr': TFIT_LR_TEX})
    opt = torch.optim.Adam(groups)
    losses = []
    for _ in range(steps):
        loss = torch.mean(torch.abs(render(tex, cam_params) - target))
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses, eye_err(start.parameters()), eye_err(cam_params)


def fit():
    """Config 1's drive: fit the unit sphere's silhouette to an
    ellipsoid's with Adam, batch 1, 256x256, silhouette loss only; the
    target is rendered by the port itself."""
    verts, faces, rot, trans, proj = kt.utils.interop.scene(1, 3,
                                                            device='cuda')

    def render(v):
        fvc, fvi, fn = kt.render.mesh.prepare_vertices(
            v, faces, proj, camera_rot=rot, camera_trans=trans)
        ones = torch.ones(fvc.shape[:3] + (1,), device='cuda')
        _, mask, _ = kt.render.mesh.dibr_rasterization(
            FIT_SIZE, FIT_SIZE, fvc[..., 2], fvi, ones, fn[..., 2])
        return mask

    with torch.no_grad():
        target = render(verts * torch.tensor(FIT_SCALE, device='cuda'))
    v = verts.clone().requires_grad_(True)
    opt = torch.optim.Adam([v], lr=FIT_LR)
    losses = []
    t0 = time.perf_counter()
    for _ in range(FIT_STEPS):
        loss = kt.metrics.render.mask_iou(render(v), target)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    secs = time.perf_counter() - t0
    log(f'fit: IoU loss {losses[0]:.6f} -> {losses[-1]:.6f} in {FIT_STEPS} '
        f'Adam steps ({losses[0] / losses[-1]:.1f}x; must fall by '
        f'{FIT_FACTOR:g}x and below {FIT_BELOW:g}), {secs:.2f} s; after 10, '
        f'25, 50 steps: {losses[9]:.6f} {losses[24]:.6f} {losses[49]:.6f}')
    expect(all(math.isfinite(x) for x in losses)
           and losses[-1] * FIT_FACTOR <= losses[0]
           and losses[-1] < FIT_BELOW, 'the fit did not converge')


def check_texture_fits():
    """The textured fit twice: texture and cameras from a flat texture (the
    image loss must fall by TFIT_FACTOR), then the cameras alone under the
    target texture (the largest eye error must fall by TFIT_EYE_FACTOR)."""
    for fit_texture in (True, False):
        label = 'texture and cameras' if fit_texture else 'cameras alone'
        t0 = time.perf_counter()
        losses, err0, err1 = texture_fit(fit_texture)
        secs = time.perf_counter() - t0
        n = len(losses)
        log(f'textured fit, {label}: image L1 {losses[0]:.6f} -> '
            f'{losses[-1]:.6f} in {n} Adam steps '
            f'({losses[0] / losses[-1]:.2f}x), {secs:.2f} s; after {n // 10}, '
            f'{n // 4}, {n // 2} steps: {losses[n // 10 - 1]:.6f} '
            f'{losses[n // 4 - 1]:.6f} {losses[n // 2 - 1]:.6f}; largest eye '
            f'error {err0:.4f} -> {err1:.4f} ({err0 / err1:.1f}x)')
        expect(all(math.isfinite(x) for x in losses), 'non-finite fit loss')
        if fit_texture:
            expect(losses[-1] * TFIT_FACTOR <= losses[0], 'the textured fit '
                   f'did not cut the loss by {TFIT_FACTOR:g}x')
        else:
            expect(err1 * TFIT_EYE_FACTOR <= err0, 'the camera fit did not '
                   f'cut the eye error by {TFIT_EYE_FACTOR:g}x')


def nn_dist(p1, p2, idx):
    """Squared distance (float64) from each point of ``p1`` to the point
    of ``p2`` that ``idx`` chose."""
    near = torch.gather(p2.double(), 1, idx.long()[..., None].expand(-1, -1,
                                                                      3))
    return kn._sq_dist(p1.double(), near)


def p2m_dist(points, fv, idx):
    """Squared distance (float64) from each point to the face ``idx``
    chose, by the selection's own formula."""
    sel = torch.gather(fv.double(), 1, idx.long()[..., None, None]
                       .expand(-1, -1, 3, 3))
    d, _ = kp.classify_and_distance(points.double(), sel[..., 0, :],
                                    sel[..., 1, :], sel[..., 2, :])
    return d


def nn_checks(label, p1, p2, errs):
    """Both NN kernels against the plain version on every query, and the
    pruned kernel against brute force; the largest difference of the
    chosen distances goes into ``errs``."""
    brute = kn.nearest_idx(p1, p2)
    pruned = kn.nearest_idx_pruned(p1, p2)
    plain = kn.nearest_idx_plain(p1, p2)
    torch.cuda.synchronize()
    m_brute = int((brute != plain).sum())
    m_pruned = int((pruned != plain).sum())
    m_pair = int((pruned != brute).sum())
    ref = nn_dist(p1, p2, plain)
    e_brute = float((nn_dist(p1, p2, brute) - ref).abs().max())
    e_pruned = float((nn_dist(p1, p2, pruned) - ref).abs().max())
    log(f'[{label}] {p1.shape[1]} queries x {p2.shape[1]} references: '
        f'index mismatches against the plain version: nearest_idx {m_brute}, '
        f'nearest_idx_pruned {m_pruned}; pruned vs brute force {m_pair}; '
        f'largest difference of the chosen distances {max(e_brute, e_pruned)}')
    expect(m_brute == 0 and m_pruned == 0 and m_pair == 0,
           f'[{label}] a nearest-neighbour kernel disagrees')
    errs['nearest_idx'] = max(errs['nearest_idx'], e_brute)
    errs['nearest_idx_pruned'] = max(errs['nearest_idx_pruned'], e_pruned)


def p2m_checks(label, points, fv, errs):
    idx, types = kp.p2m_select(points, fv)
    ridx, rtypes = kp.p2m_select_plain(points, fv)
    torch.cuda.synchronize()
    mi, mt = int((idx != ridx).sum()), int((types != rtypes).sum())
    err = float((p2m_dist(points, fv, idx)
                 - p2m_dist(points, fv, ridx)).abs().max())
    log(f'[{label}] p2m_select, {points.shape[1]} points x {fv.shape[1]} '
        f'faces: face mismatches {mi}, type mismatches {mt}, largest type '
        f'{int(types.max())}, largest difference of the chosen distances '
        f'{err}')
    expect(mi == 0 and mt == 0, f'[{label}] p2m_select disagrees with its '
           'plain version')
    errs['p2m_select'] = max(errs['p2m_select'], err)


def grid_mesh_points():
    """The grid mesh of ``tests/test_metrics.py``: points above its
    vertices and edge midpoints, where faces tie exactly and region flags
    overlap (summed types above 6)."""
    g = np.mgrid[0:5, 0:5].reshape(2, -1).T.astype(np.float32)
    verts = np.concatenate([g, np.zeros((25, 1), np.float32)], 1)
    quads = np.array([[i * 5 + j, i * 5 + j + 1, (i + 1) * 5 + j,
                       (i + 1) * 5 + j + 1]
                      for i in range(4) for j in range(4)])
    faces = np.concatenate([quads[:, [0, 1, 2]], quads[:, [1, 3, 2]]])
    mid = verts[:-1] * 0.5 + verts[1:] * 0.5 + [0, 0, 2]
    pts = np.concatenate([verts + [0, 0, 1], mid]).astype(np.float32)
    return kt.utils.interop.pointclouds_from_numpy(pts[None],
                                                   verts[faces][None])


def surface_clouds():
    """M3_N points sampled on the fit's ellipsoid and M3_N on the unit
    sphere (icosphere subdivision FIT3_TARGET_SUBDIV), seeded."""
    gen = torch.Generator('cuda').manual_seed(SEED)
    ell = kt.utils.interop.ellipsoid_points(M3_N, FIT3_TARGET_SUBDIV,
                                            FIT_SCALE, generator=gen)
    sph = kt.utils.interop.ellipsoid_points(M3_N, FIT3_TARGET_SUBDIV,
                                            (1., 1., 1.), generator=gen)
    return ell, sph


def cdist_argmin(p1, p2, rows=4096):
    """The library's yardstick for the NN kernels: ``torch.cdist`` without
    the matrix-product form, then ``argmin``, over blocks of queries."""
    return torch.cat([torch.cdist(p1[:, i:i + rows], p2, compute_mode=
                                  'donot_use_mm_for_euclid_dist').argmin(-1)
                      for i in range(0, p1.shape[1], rows)], dim=1)


def metrics_kernel_phases():
    """The three config-3 kernels against their plain versions on the card
    at config 3's shapes (both NN directions on every query), on a surface
    scene, a cloud with exact duplicates and the grid mesh's ties; then
    each timed beside its plain version and, for the NN kernels, chunked
    ``torch.cdist`` + ``argmin``. Returns ({kernel: max abs error},
    {kernel: times}, prepass ms)."""
    p1, p2, fv = kt.utils.interop.metrics_scene(SEED, M3_N, M3_N, M3_FACES)
    errs = dict.fromkeys(('nearest_idx', 'nearest_idx_pruned', 'p2m_select'),
                         0.)
    nn_checks('config3 p1->p2', p1, p2, errs)
    nn_checks('config3 p2->p1', p2, p1, errs)
    ell, sph = surface_clouds()
    nn_checks('ellipsoid->sphere', ell, sph, errs)
    nn_checks('sphere->ellipsoid', sph, ell, errs)
    half = p2[:, :M3_N // 2]
    dup = torch.cat([half, half.flip(1)], dim=1)
    nn_checks('exact duplicates', torch.cat([p1[:, :M3_N // 2], half], 1),
              dup, errs)
    p2m_checks('config3', p1, fv, errs)
    p2m_checks('grid mesh ties', *grid_mesh_points(), errs)

    lib = cdist_argmin(p1, p2)
    e_lib = int((lib.to(torch.int32) != kn.nearest_idx(p1, p2)).sum())
    lib_ms = time_ms(lambda: cdist_argmin(p1, p2), 1, warmup=False)
    log(f'[config3] torch.cdist + argmin vs nearest_idx: {e_lib} index '
        'mismatches (cdist takes a square root and sums in its own order); '
        f'{lib_ms:.1f} ms, the library time of both NN rows')

    _, _, _, _, starts, nums, keep = kn._pruned_ranges(p1, p2)
    C2 = -(-M3_N // kn.T2)
    scanned = int(keep.sum()) * kn.T1 * kn.T2
    log(f'[config3] pruned ranges p1->p2: {starts.shape[1]} tiles of '
        f'{kn.T1} queries, {C2} chunks of {kn.T2} references; mean range '
        f'{float(nums.float().mean()):.2f} chunks, largest {int(nums.max())}; '
        f'mean kept {float(keep.float().sum(-1).mean()):.2f} chunks; '
        f'{scanned} pairs scanned, {scanned / M3_N ** 2:.4f} of brute force')
    nbytes = 4 * (2 * 3 * M3_N + M3_N)
    shape = (f'1 x {M3_N} queries x {M3_N} references (config 3, '
             'bench_suite.py:191-194)')
    times = {}
    plain_ms = time_ms(lambda: kn.nearest_idx_plain(p1, p2), 2)
    for name, fn, pairs in (
            ('nearest_idx', lambda: kn.nearest_idx(p1, p2), M3_N ** 2),
            ('nearest_idx_pruned', lambda: kn.nearest_idx_pruned(p1, p2),
             scanned)):
        bnd = bound(nbytes, pairs * OPS_NN_PAIR)
        times[name] = dict(ms=time_ms(fn, TIME_ITERS), plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=bnd[0],
                           bound_by=bnd[1], shape=shape)
        log(f'[config3] time {name}: ' + json.dumps(times[name]))
    prepass_ms = time_ms(lambda: kn._pruned_ranges(p1, p2), TIME_ITERS)
    log(f'[config3] time of the pruned prepass alone: {prepass_ms:.4f} ms, '
        f'{prepass_ms / times["nearest_idx_pruned"]["ms"]:.3f} of '
        'nearest_idx_pruned')
    bnd = bound(4 * (3 * M3_N + 9 * M3_FACES + 2 * M3_N),
                M3_N * M3_FACES * OPS_P2M_PAIR)
    times['p2m_select'] = dict(
        ms=time_ms(lambda: kp.p2m_select(p1, fv), TIME_ITERS),
        plain_ms=time_ms(lambda: kp.p2m_select_plain(p1, fv), 1),
        library_ms=None, bound_ms=bnd[0], bound_by=bnd[1],
        shape=f'1 x {M3_N} points x {M3_FACES} faces (config 3)')
    log('[config3] time p2m_select: ' + json.dumps(times['p2m_select']))
    return errs, times, prepass_ms


def metrics_path():
    """Config 3's step (``bench_suite.py:196-199``), as a user calls it,
    TIME_ITERS chained iterations; checks the launches of each kernel and
    the step's values. Returns (launches, ms per iteration)."""
    p1, p2, fv = kt.utils.interop.metrics_scene(SEED, M3_N, M3_N, M3_FACES)
    reset_counters()
    p = p1
    for _ in range(TIME_ITERS):
        p = kt.utils.interop.metrics_step(p, p2, fv)
    launches = read_counters('config 3 path')
    expect(launches['nearest_idx_pruned'] == 2 * TIME_ITERS
           and launches['p2m_select'] == TIME_ITERS
           and launches['nearest_idx'] == 0,
           'config 3 step: expected 2 pruned NN and 1 p2m launch per '
           'iteration, and no brute-force NN')
    c = kt.metrics.pointcloud.chamfer_distance(p1, p2)
    d, idx, types = kt.metrics.trianglemesh.point_to_mesh_distance(p1, fv)
    analytic = 2. * math.gamma(5. / 3.) * (4. * math.pi * M3_N / 3.) ** (
        -2. / 3.)
    log(f'[config3] chamfer {float(c):.6e} ({float(c) / analytic:.4f} of '
        f'the Poisson value {analytic:.6e} for two uniform clouds), mean '
        f'point-to-mesh distance {float(d.mean()):.6e}, types '
        f'{torch.bincount(types.flatten(), minlength=7)[:7].tolist()}')
    expect(tuple(c.shape) == (1,) and tuple(d.shape) == (1, M3_N)
           and bool(torch.isfinite(p).all() and torch.isfinite(d).all())
           and float(d.min()) >= 0. and 0.95 <= float(c) / analytic <= 1.1,
           'config 3 step: implausible values')

    state = [p1]

    def step():
        state[0] = kt.utils.interop.metrics_step(state[0], p2, fv)

    ms = time_ms(step, TIME_ITERS)
    log(f'[config3] step: {ms:.4f} ms per iteration ({TIME_ITERS} chained '
        'iterations after a warm-up)')
    profile_calls('[config3] profile step', step, ms, iters=1)
    return launches, ms


def mesh_fit_path():
    """Config 3's mesh fit with gradients, as a user writes it: Adam on
    the vertices of a unit icosphere toward points sampled on an
    ellipsoid, through ``sample_points``, ``chamfer_distance``,
    ``point_to_mesh_distance`` and ``uniform_laplacian_smoothing``; then
    the F-score of FIT3_EVAL samples of the fit and of the target. Returns
    the launches of each kernel in it."""
    gen = torch.Generator('cuda').manual_seed(SEED)
    target = kt.utils.interop.ellipsoid_points(FIT3_N, FIT3_TARGET_SUBDIV,
                                               FIT_SCALE, generator=gen)
    verts, faces = kt.utils.interop.mesh_from_numpy(
        *kt.utils.interop.icosphere(FIT3_SUBDIV))
    v = verts[None].clone().requires_grad_(True)
    opt = torch.optim.Adam([v], lr=FIT3_LR)
    reset_counters()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FIT3_STEPS):
        loss = kt.utils.interop.mesh_fit_loss(v, faces, target, FIT3_N,
                                              FIT3_LAP, generator=gen)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    g = v.grad
    with torch.no_grad():
        fit_pts = kt.ops.mesh.sample_points(v, faces, FIT3_EVAL,
                                            generator=gen)[0]
        fs = kt.metrics.pointcloud.f_score(target[:, :FIT3_EVAL], fit_pts,
                                           radius=FIT3_RADIUS)
    launches = read_counters('mesh fit path')
    losses, n = [float(x) for x in losses], FIT3_STEPS
    log(f'[config3] mesh fit: loss {losses[0]:.6f} -> {losses[-1]:.6f} in '
        f'{FIT3_STEPS} Adam steps ({losses[0] / losses[-1]:.1f}x; must fall '
        f'by {FIT3_FACTOR:g}x); after {n // 10}, {n // 4}, {n // 2} steps: '
        f'{losses[n // 10 - 1]:.6f} {losses[n // 4 - 1]:.6f} '
        f'{losses[n // 2 - 1]:.6f}; {secs / n * 1e3:.4f} ms '
        f'per step ({FIT3_N} samples and target points, {faces.shape[0]} '
        f'faces); last gradient: largest |grad| {float(g.abs().max()):.4e}, '
        f'finite {bool(torch.isfinite(g).all())}; F-score at radius '
        f'{FIT3_RADIUS:g} on {FIT3_EVAL} points {float(fs):.4f}')
    expect(all(math.isfinite(x) for x in losses)
           and losses[-1] * FIT3_FACTOR <= losses[0]
           and bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0.,
           'the config 3 mesh fit did not converge')
    for name in ('nearest_idx', 'nearest_idx_pruned', 'p2m_select'):
        expect(launches[name] > 0, f'{name} was not launched on the mesh '
               'fit path')
    return launches


def check_sign_phase():
    """``check_sign`` of CHECK_N seeded points against the unit icosphere
    of subdivision 5 on the card: inside below r = 0.99, outside above
    1.01, and equal to the CPU on CHECK_CPU of the points."""
    verts, faces = kt.utils.interop.mesh_from_numpy(
        *kt.utils.interop.icosphere(5))
    rng = np.random.default_rng(SEED)
    pts = torch.tensor(rng.uniform(-1.5, 1.5, (1, CHECK_N, 3)),
                       dtype=torch.float32, device='cuda')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inside = kt.ops.mesh.check_sign(verts[None], faces, pts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    r = pts.norm(dim=-1)
    wrong_in = int((~inside[r < 0.99]).sum())
    wrong_out = int(inside[r > 1.01].sum())
    cpu = kt.ops.mesh.check_sign(verts[None].cpu(), faces.cpu(),
                                 pts[:, :CHECK_CPU].cpu())
    mism = int((inside[:, :CHECK_CPU].cpu() != cpu).sum())
    log(f'check_sign: {CHECK_N} points x {faces.shape[0]} faces in '
        f'{secs * 1e3:.1f} ms on the card; inside share '
        f'{float(inside.float().mean()):.4f} (the sphere\'s '
        f'{4. * math.pi / 3. / 27.:.4f}); points r < 0.99 not inside '
        f'{wrong_in}, r > 1.01 inside {wrong_out}; card vs CPU on '
        f'{CHECK_CPU}: {mism} mismatches')
    expect(wrong_in == 0 and wrong_out == 0 and mism == 0,
           'check_sign is wrong on the card')


def sdf_phase():
    """``sdf_to_voxelgrids`` of a sphere's SDF on the card (init_res 32, 2
    upsampling steps, 129^3) against its dense evaluation at 129^3."""
    def sphere(points):
        return torch.sqrt((points ** 2).sum(1)) - 0.4

    times = []
    for init_res, steps in ((32, 2), (128, 0)):
        t0 = time.perf_counter()
        out = kt.ops.conversions.sdf_to_voxelgrids([sphere], init_res=init_res,
                                                   upsampling_steps=steps)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if steps:
            refined = out
    same = bool(torch.equal(refined, out))
    log(f'sdf_to_voxelgrids: {tuple(refined.shape)} refined from 32^3 in '
        f'{times[0] * 1e3:.1f} ms, dense at 129^3 in {times[1] * 1e3:.1f} '
        f'ms; equal {same}, occupied {int(refined.sum())}')
    expect(same and refined.device.type == 'cuda'
           and refined.dtype == torch.float32, 'sdf_to_voxelgrids: the '
           'refinement differs from the dense evaluation')


def check_metrics_against_cpu():
    """The mesh fit's loss at a small size (icosphere subdivision 2, 2,000
    target points, 1,500 samples from fixed uniforms) on the card against
    the plain versions on the CPU: the loss, then its gradient to the
    vertices entry by entry. The selections are equal; the gradient's
    gathers add with atomics on the card, in another order."""
    verts, faces = kt.utils.interop.icosphere(2)
    rng = np.random.default_rng(SEED)
    s = rng.standard_normal((1, 2000, 3))
    target = (s / np.linalg.norm(s, axis=-1, keepdims=True)
              * FIT_SCALE).astype(np.float32)
    uniforms = [rng.random(shape).astype(np.float32)
                for shape in ((1, 1500), (1, 1500, 1), (1, 1500, 1))]

    def loss_and_grad(device):
        v, f = kt.utils.interop.mesh_from_numpy(verts[None] * 0.9, faces,
                                                device=device)
        v.requires_grad_(True)
        loss = kt.utils.interop.mesh_fit_loss(
            v, f, torch.tensor(target, device=device), 1500, FIT3_LAP,
            uniforms=[torch.tensor(u, device=device) for u in uniforms])
        return loss.item(), torch.autograd.grad(loss, [v])[0]

    (lg, gg), (lc, gc) = loss_and_grad('cuda'), loss_and_grad('cpu')
    rel = abs(lg - lc) / abs(lc)
    log(f'card vs CPU plain, config 3 fit loss: {lg:.8f} vs {lc:.8f}, '
        f'relative difference {rel:.3e} (tolerance 1e-5)')
    expect(rel <= 1e-5, 'the config 3 loss on the card disagrees with the '
           'CPU')
    grad_close('card vs CPU plain, config 3 fit gradient to the vertices',
               gg.cpu(), gc)


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device visible', file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'{torch.cuda.get_device_name(0)}')
    t0 = time.perf_counter()
    log(f'build: {_build.build_all():.1f} s for {len(_build.SOURCES)} '
        'sources')

    scenes = [Scene(name, b, s, 'cuda') for name, b, s in SIZES]
    tsc = TexturedScene(TEX_BATCH, TEX_SUBDIV, TEX_SIZE, H, W, 'cuda')
    errs = {name: 0.0 for name in KERNELS}
    times = {}
    for sc in scenes:
        sc_errs, times[sc.name] = kernel_phases(sc)
        bwd_errs, bwd_times = backward_phases(sc)
        times[sc.name].update(bwd_times)
        for name, err in {**sc_errs, **bwd_errs}.items():
            errs[name] = max(errs[name], err)
    tex_errs, tex_times = texture_phases(tsc)
    errs.update(tex_errs)
    m3_errs, m3_times, prepass_ms = metrics_kernel_phases()
    errs.update(m3_errs)

    launches, _ = main_path(scenes)
    for sc in scenes:
        for dim in (4, WIDE):
            ms = time_ms(lambda: sc.forward(dim), TIME_ITERS)
            log(f'[{sc.name}] forward D={dim}: {ms:.4f} ms per call, '
                f'{ms / sc.batch:.4f} ms/frame '
                f'(batch {sc.batch}, {sc.num_faces} faces, {H}x{W})')
            profile_calls(f'[{sc.name}] profile forward D={dim}',
                          lambda: sc.forward(dim), ms)

    train_launches = train_path(scenes)
    for name in ('rasterize_backward', 'soft_mask_backward'):
        launches[name] = train_launches[name]
    per_frame = {}
    for sc in scenes:
        ms = time_ms(lambda: sc.train(TRAIN_STEPS), 1) / TRAIN_STEPS
        per_frame[sc.name] = ms / sc.batch
        log(f'[{sc.name}] train step D=4: {ms:.4f} ms per step, '
            f'{ms / sc.batch:.4f} ms/frame (batch {sc.batch}, '
            f'{sc.num_faces} faces, {H}x{W}, {TRAIN_STEPS} chained steps)')
        profile_calls(f'[{sc.name}] profile train step',
                      lambda: sc.train(1), ms)

    tex_launches = textured_path(tsc)
    for name in ('grid_sample', 'grid_sample_backward'):
        launches[name] = tex_launches[name]
    ms = time_ms(lambda: tsc.train(TRAIN_STEPS), 1) / TRAIN_STEPS
    tex_per_frame = ms / tsc.batch
    log(f'[textured] train step: {ms:.4f} ms per step, {tex_per_frame:.4f} '
        f'ms/frame (batch {tsc.batch}, {tsc.num_faces} faces, {H}x{W}, '
        f'{TEX_SIZE}x{TEX_SIZE} texture, {TRAIN_STEPS} chained steps)')
    profile_calls('[textured] profile train step', lambda: tsc.train(1), ms)

    m3_launches, m3_ms = metrics_path()
    for name in ('nearest_idx_pruned', 'p2m_select'):
        launches[name] = m3_launches[name]
    log(f'[config3] the pruned prepass alone: {prepass_ms:.4f} ms, twice '
        f'per step: {2. * prepass_ms / m3_ms:.3f} of the step')
    launches['nearest_idx'] = mesh_fit_path()['nearest_idx']

    check_against_cpu()
    check_textured_against_cpu()
    check_metrics_against_cpu()
    fit()
    check_texture_fits()
    check_sign_phase()
    sdf_phase()

    main = scenes[0]
    rows = []
    for name, (source, replaces) in KERNELS.items():
        t = tex_times.get(name) or m3_times.get(name) or dict(
            times[main.name][name], library_ms=None,
            shape=f'batch {main.batch}, {main.num_faces} faces, {H}x{W}')
        rows.append(dict(name=name, route='cuda', source=source,
                         replaces=replaces, launches=launches[name],
                         max_abs_err=errs[name], ms=t['ms'],
                         plain_ms=t['plain_ms'], bound_ms=t['bound_ms'],
                         bound_by=t['bound_by'], library_ms=t['library_ms'],
                         shape=t['shape']))
    log(f'total {time.perf_counter() - t0:.1f} s')
    log(json.dumps({'metric': 'dibr_512x512_fwd_bwd_ms_per_frame',
                    'value': per_frame[main.name], 'unit': 'ms/frame',
                    'config2_value': per_frame[scenes[1].name]}))
    log(card)
    log(json.dumps({'metric': 'dibr_512_textured_b8_20k',
                    'value': tex_per_frame, 'unit': 'ms/frame'}))
    log(card)
    log(json.dumps({'metric': 'chamfer100k_p2m10k', 'value': m3_ms,
                    'unit': 'ms/iter'}))
    log(card)
    log(json.dumps({'kernels': rows}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
