#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``kaolin_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository, on a machine with a CUDA card and
``nvcc``::

    python3 chip_smoke.py

It builds the port's host library (``csrc/core.cpp``, ``g++``) and its
CUDA kernels from ``kaolin_tpu_torch/csrc/``, holds
each kernel against its plain PyTorch version on the card at the shapes of
the paths below, and drives seven paths, checking that every kernel of each
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
  point-to-mesh and Laplacian terms, then an F-score on 10,000 points;
- config 4's DefTet step (``bench_suite.py:205-229``: ``deftet_sparse_render``
  of 64x64 pixels and 10,000 random faces, ``knum=30``, the sum of the
  squared features, its gradient to the image coords, 20 chained
  ``fvi - 1e-9*g`` steps), timed as ``deftet_64x64_10kfaces``;
- config 5's SPC ray trace (``bench_suite.py:232-290``: 200,000 points on a
  sphere shell of radius 0.7 quantized at level 8, 256x256 primary rays
  from (0, 0, 2.5) with a 60-degree fov, ``unbatched_raytrace`` from the
  origin and direction arrays), timed as ``spc_raytrace_256_L8``; its first
  hits are held against the analytic sphere, and a trace must make one
  host sync (``torch.cuda.set_sync_debug_mode``).

The grid-sample forward, ``p2m_select``, ``nearest_idx_pruned`` and
``deftet_topk`` are also timed by the card alone (``torch.profiler``'s
device time, beside the CUDA-event time that includes the host), with
``F.grid_sample`` beside the first. ``nearest_idx_pruned`` is held against
brute force and its plain version, two launches against each other, on
config 3 both ways, surface clouds, exact duplicates, a lattice whose
queries tie exactly with 8 references far apart in Morton order, two far
clusters, a sphere-centre scene (queries within 1e-3 of the origin,
references on the unit sphere: its worst case) and the mesh fit's clouds;
its prepass on the card against the plain prepass; it is timed on config
3 both ways, the sphere-centre scene and the mesh fit, each with the
share of pairs it scanned, its launches per call and a bound that does
not depend on its design (the pairs inside each query's cube of
half-side sqrt(winner distance)), and on two clouds of NN_BIG points
against brute force, with the share it scanned. ``deftet_topk`` is held
the same way at knum 1, 30, 64 and 300, with every face doubled, on +-0.0
depths and on a full-cover scene (every face over the whole image, its
depth rising with its id), and timed on config 4 at knum 30 and 300 (with
its scratch's size) and on the full-cover scene.
``p2m_select`` is held against its plain version on config 3, on config 3
with the mesh listed twice (every distance tied), on points 0-2 ulps off
the planes of a 10,000-face mesh, on a flat 10,000-face mesh (one plane:
its cull skips nothing) and at the mesh fit's first step (5,120 faces);
it is timed on the last two and config 3, each with the share of pairs
its plane cull skipped and its bound.

It then checks the render, the gradient, the textured step and config 3's
fit loss against the plain versions on the CPU on small inputs, fits a
sphere's silhouette to an ellipsoid's with Adam (batch 1, 256x256,
silhouette loss only, ``bench_suite.py``'s config 1), fits a striped
texture and perturbed cameras to four views with Adam
(``examples/dibr_train.py``'s scene), checks ``check_sign`` and
``sdf_to_voxelgrids`` on the card, checks config 4's loss and gradients,
the tet metrics, marching tetrahedra and the pack ops against the CPU, and
times it all with CUDA events and ``torch.profiler``.

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

The four render kernels are also held against their plain versions on a
large-faces scene (an icosphere of subdivision 1, 80 faces at batch 4,
brought near enough to cover about 0.9 of the image), the forward ones
over their own per-tile face lists and over the soft mask's (the shared
binning of ``dibr_rasterization``), two launches against each other; the
counts that size their designs are logged for each size (``forward
counts`` and ``backward counts`` lines). The brute-force ``nearest_idx``
is also timed at the mesh fit's F-score shape (10,000 x 10,000 points)
and at ``examples/dibr_train.py``'s final Chamfer (2,048 x 2,048, batch
1), each with its CUDA launches and host syncs a call and beside both of
``torch.cdist``'s forms + ``argmin``, and the ``f_score`` and
``chamfer_distance`` at those sizes end to end. Both NN kernels are held
against their plain versions on two NaN scenes (config 3's clouds and
the F-score's, a NaN coordinate in a reference of the first, a middle
and the last chunk of 1024, and a NaN, an inf and a -inf query): no
reference of a chunk that holds a NaN may be taken, as in the XLA scan;
the pruned prepass on the card against its plain version on both.

Then it drives the modules with no TPU kernel (``module_phases``), each on
the card at full width, checked against the CPU (bool, integer and octree
outputs exactly; floats to the tolerances named beside them: SG_TOL,
SG_GRAD_TOL, MOD_TOL, MOD_GRAD_TOL) and timed with CUDA events and
``torch.profiler`` (device time, CUDA activities and host syncs a call,
peak memory, a bound where one means something), each with the launch
counters at 0 and read after:

- SG lighting: ``unbatched_reduced_sg_inner_product`` at ``bench_sg.py``'s
  100,000 queries x 512 lights (its seeded inputs), the sum's forward and
  its gradient to all six inputs, timed as
  ``sg_reduced_inner_100000x512_fwd`` and ``..._fwdbwd``; the first 2,000
  queries' values and gradients against the CPU at float64;
- mesh -> SPC -> convolution -> trace: config 2's mesh (icosphere
  subdivision 5, batch 8, scaled 0.9) through ``mesh_to_spc`` at level 8
  (the host library), equal to the CPU's octrees; on the first octree a
  27-offset ``Conv3d`` (32 -> 32, jump 0), an 8-offset ``Conv3d`` (jump 1)
  and an 8-offset ``ConvTranspose3d`` (jump 1), forward and backward to
  the features and the weights, against the CPU; then ``unbatched_raytrace``
  of that octree with config 5's rays (the traversal kernel, the one
  launch of this path, one host sync a trace), equal to the CPU's trace,
  its first hits within two voxel diagonals of the sphere of radius 0.9
  and 0.9 of them within one;
- voxel grids: config 2's mesh at batch 8 through
  ``trianglemeshes_to_voxelgrids`` at 128^3, ``fill``, ``extract_surface``
  (both modes), ``downsample`` by 2, ``extract_odms``, ``project_odms``,
  ``iou`` against the filled grid, marching cubes of a filled grid,
  ``subdivide_trianglemesh`` once (81,920 faces), and config 3's
  100,000-point cloud through ``pointclouds_to_voxelgrids`` at 128 and
  ``unbatched_pointcloud_to_spc`` at level 8 with 3 feature channels:
  equal to the CPU's;
- GCN: ``GraphConv`` 192 -> 192 over config 2's 10,242 vertices
  (``adjacency_matrix``), batch 8, forward and backward, with the sparse
  and the dense adjacency, against the CPU's sparse route;
- small ops: ``coords`` against the CPU, ``random_spc_octrees`` (batch 4,
  level 8: valid and deterministic), seeded ``random_tensor``, and the
  host library's Morton and octree entry points against their numpy
  versions at config 5's 200,000 points.

Then the sharded paths (``kaolin_tpu_torch.parallel``): ``parallel_world1``
joins a world of one through torchrun's variables (NCCL) and holds the
sharded render and train step on a 1 x 1 mesh at ``bench.py``'s size
against ``dibr_rasterization`` (bit-equal; the gradient to GRAD_TOL),
timing both in turns; ``parallel_world2`` starts two ranks on the one card
(this script with ``--rank``, under a deadline): NCCL first, which
refuses two ranks on one device, then gloo, which moves CUDA tensors for
``all_reduce``. Each rank runs the sharded render and train step at
meshes (1, 2) (rank 1 renders from row 256) and (2, 1), config 3's
sharded Chamfer and point-to-mesh and config 5's trace split in two, and
each is held against the one-process result on the card, with every
rank's launch counters. ``io`` writes an OBJ (``vt``, ``vn``, a Kd-only
MTL), an OFF and a checkpoint of an Adam state, loads them onto the card,
renders the OBJ and restores the checkpoint bit for bit. ``usd`` runs 21
of config 2's train steps and checkpoints the step's CUDA vertices (which
require grad) with ``visualize.Timelapse`` at iterations 0, 10 and 20,
config 3's 100,000-point cloud and a 128^3 grid of config 2's mesh once;
reads every checkpoint back onto the card bit for bit; exports config 2's
8 meshes to ``.usda`` and ``.usdc`` and reads them back; renders the mesh
read back (``face_idx`` equal to the render of what was written, the
forward kernels counted); decodes the dash3d helper's mesh payload; and
round-trips a material with values only. It logs the host ms of each
write and read and the files' bytes, and needs neither PIL nor tornado.

Last, ``examples`` runs the applications of ``kaolin_tpu_torch.examples``
on the card at the JAX examples' own sizes: the fish self-fit (128^2,
lod 16 x 8, 100 / 50 / 20 epochs, texture 64), DIB-R (150 steps, 256^2,
4 views, the final Chamfer), NGLOD (level 6, 300 steps, a 128^2 render)
and DMTet (grid 32, 20,000 samples, a 50,000-point torus). Each must fall
as the JAX tests assert and launch its kernels (the render kernels; the
brute-force NN; the traversal; the pruned NN), its first steps on the
card must match the port's on the CPU, and it logs ms a step of each
stage (CUDA events after each ``torch.optim.Adam`` step).

The grid-sample backward's texture gradient must be the same bits at two
launches (the second with the forward's interleaved copy) in every case,
and the traversal, run with a budget too small for config 5's levels,
must size them exactly, trace again and equal its plain version.

``python3 chip_smoke.py --compare LABEL [GROUP ...]`` instead prints
``nvcc -Xptxas -v`` for the render kernels' sources (and
``grid_sample.cu``, ``spc_traverse.cu``), the texture backward's counts,
``grid_sample_backward`` at the step's and a random cotangent,
``traverse`` and the config 5 trace (each with its device time, device
activities, host syncs and device time a level), and times the forward
render kernels and the forward render at D = 4 and 40, both render backwards
(bench, config 2 and the large-faces scene; rasterize at D = 4 and 40),
the bench and config 2 train steps (with their device time),
``grid_sample``, ``F.grid_sample``, ``p2m_select`` on its three scenes,
``nearest_idx_pruned`` on config 3, the sphere-centre scene and two
clouds of NN_BIG points, the pruned prepass alone, ``nearest_idx`` at
the F-score's, the DIB-R Chamfer's and config 3's shapes (with ``nvcc
-Xptxas -v`` of ``nn_distance.cu``), ``f_score`` and ``chamfer_distance``
end to end,
``deftet_topk`` on config 4 at knum 30 and 300 and on the full-cover
scene, and the textured, config 3 and config 4 steps (see ``compare``
for the groups that select them), through phase functions that call
nothing older checkouts lack: copy the script into a parent's checkout
to time it there.
"""

import contextlib
import ctypes
import inspect
import json
import math
import os
import socket
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile, schedule

import kaolin_tpu_torch as kt
from kaolin_tpu_torch.experimental.dash3d import util as dash3d_util
from kaolin_tpu_torch.kernels import _build
from kaolin_tpu_torch.kernels import deftet_topk as kd
from kaolin_tpu_torch.kernels import nn_distance as kn
from kaolin_tpu_torch.kernels import p2m_distance as kp
from kaolin_tpu_torch.kernels import rasterize as kr
from kaolin_tpu_torch.kernels import rasterize_bwd as krb
from kaolin_tpu_torch.kernels import soft_mask as ks
from kaolin_tpu_torch.kernels import spc_traverse as kst
from kaolin_tpu_torch.kernels import texture as ktex
from kaolin_tpu_torch.kernels.rasterize import _pixel_coords
from kaolin_tpu_torch.parallel import launch as par_launch
from kaolin_tpu_torch.parallel import mesh as par_mesh
from kaolin_tpu_torch.parallel import spc as par_spc
from kaolin_tpu_torch.render.mesh.dibr import _scaled_inputs
from kaolin_tpu_torch.render.mesh.rasterization import _kernel_inputs
from kaolin_tpu_torch.render.mesh.utils import _clip, _uv_coords

SEED = 0
H = W = 512
SIZES = (('bench', 4, 3), ('config2', 8, 5))   # (name, batch, subdiv)
# the backward kernels' large-faces scene: an icosphere of subdivision 1
# (80 faces) at batch 4, scaled by LARGE_SCALE, as near as cameras at
# 3.04 / 1.35 = 2.25 from its centre would see it (at 1.5 the 45-degree
# fovy sees no background and the soft mask has no pair); each face's
# rectangle spans tens of thousands of pixels
LARGE, LARGE_SCALE = ('large_faces', 4, 1), 1.35
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
# the pruned NN scan at a larger size: two uniform clouds of NN_BIG points
# drawn as config 3's are, held against the brute-force kernel
NN_BIG = 1_000_000
# examples/dibr_train.py:126-131: the final Chamfer between DIBR_CHAMFER_N
# points sampled on the fit and on the target, batch 1 (the brute-force
# kernel's, as the F-score's FIT3_EVAL)
DIBR_CHAMFER_N = 2048
# the library's direct form (cdist_argmin) is timed at sizes up to this
# many points a cloud: at config 3's 100,000 one call takes 12.5 s
CDIST_DIRECT_MAX = 10_000
# check_sign: CHECK_N seeded points in [-1.5, 1.5]^3 against the unit
# icosphere of subdivision 5, CHECK_CPU of them also on the CPU
CHECK_N, CHECK_CPU = 100_000, 4096
# config 4 (bench_suite.py:205-229): DefTet on a D4_SIDE^2 pixel grid and
# D4_FACES seeded faces, knum D4_KNUM, the step fvi - D4_LR * grad; the
# selection also at knum D4_BIG_KNUM on a D4_BIG_SIDE^2 grid
D4_SIDE, D4_FACES, D4_KNUM, D4_LR = 64, 10_000, 30, 1e-9
D4_BIG_SIDE, D4_BIG_KNUM = 32, 300
# config 5 (bench_suite.py:232-290): C5_N seeded points on a sphere shell of
# radius C5_RADIUS quantized at C5_LEVEL, C5_RES^2 primary rays from
# C5_CAM's lookat camera (eye, at, up, fov)
C5_LEVEL, C5_N, C5_RADIUS, C5_RES = 8, 200_000, 0.7, 256
C5_CAM = ((0., 0., 2.5), (0., 0., 0.), (0., 1., 0.), math.pi / 3)

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
# a test of a point against a face's plane: dot(p, un) - dot(v1, un), the
# latter once a face (3 products, 3 sums), the square and the compare
OPS_P2M_PLANE = 3 + 3 + 2
# DefTet selection: 4 compares per (pixel, face) pair for the bbox test;
# for a pair inside the bbox, 6 subtractions to the pixel, 3 edge
# functions (2 mul, 1 sub each), the normalisation (2 add, the sign and
# the eps product and sum: 4), 3 divisions, 3 compares, the depth (3 mul,
# 2 add) and 2 range compares
OPS_DEFTET_BBOX = 4
OPS_DEFTET_PAIR = 6 + 9 + 4 + 3 + 3 + 5 + 2
# SPC traversal: per nugget, 3 reciprocals and the cell (centre and
# octant code: 3 x 8); per tested child, its centre (6) and the slab test
# (3 subtractions, 3 compares, 3 x (mul, sub, mul), 6 x (mul, add), 6
# compares, 3 sign tests, the selects: 36); the exit test again at the
# last level
OPS_TRAV_NUGGET = 3 + 24
OPS_TRAV_CHILD = 6 + 36
OPS_TRAV_EXIT = 36

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
# the same order without fused multiply-adds, so the samples are held
# bit-equal, and the coordinate gradients are expected bit-equal (held to
# GRAD_TOL entry by entry). The texture gradient adds each texel's terms
# in float32 in another order than the plain version's scatter_add_ (a
# fixed one: two launches must give the same bits), and a texel may take
# 10^5 terms (the background texel of config 2's step under a random
# cotangent): it is held against the plain version in float64, every
# entry within GRAD_TOL * (|ref| + median nonzero |ref|) plus TOL_ATOMIC
# times the sum of its terms' magnitudes
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
    'deftet_topk': ('kaolin_tpu_torch/csrc/deftet_topk.cu',
                    'kaolin_tpu/kernels/deftet_topk.py:147'),
    'traverse_banded_cc': ('kaolin_tpu_torch/csrc/spc_traverse.cu',
                           'kaolin_tpu/kernels/spc_traverse.py:982'),
    'traverse_banded': ('kaolin_tpu_torch/csrc/spc_traverse.cu',
                        'kaolin_tpu/kernels/spc_traverse.py:435'),
}
COUNTERS = (kr.rasterize_interp, kr.rasterize_select, ks.soft_mask_forward,
            krb.rasterize_backward, ks.soft_mask_backward, ktex.grid_sample,
            ktex.grid_sample_backward, kn.nearest_idx, kn.nearest_idx_pruned,
            kp.p2m_select, kd.deftet_topk, kst.traverse)
# the counter of each KERNELS row whose wrapper has another name: the one
# CUDA traversal meets both TPU traversals' contract
COUNTER_OF = {'traverse_banded_cc': 'traverse', 'traverse_banded': 'traverse'}


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

    def __init__(self, name, batch, subdiv, device, scale=1.):
        self.name, self.batch = name, batch
        verts, faces, rot, trans, proj = kt.utils.interop.scene(
            batch, subdiv, device=device)
        verts = verts * scale
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
        self.valid = fn[..., 2] >= 0.
        self.fz, self.img, self.bbox = _kernel_inputs(
            fvc[..., 2], fvi, self.valid, 1000.)
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


def same_bits(a, b):
    """Two outputs equal bit for bit (floats by their bits)."""
    if a.is_floating_point():
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def kernel_phases(sc):
    """Each kernel against its plain version on the card, at this size's
    shapes, then both timed. Returns ({kernel: max abs error},
    {kernel: times})."""
    errs, idx_main = forward_checks(sc)
    args = (sc.fz, sc.img, sc.bbox, sc.feat4)
    kw = dict(height=H, width=W, multiplier=1000., eps=1e-8)

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
                           device_ms=device_ms(f'[{sc.name}] {name}', fn),
                           plain_ms=time_ms(plain, plain_iters),
                           bound_ms=bnd[0], bound_by=bnd[1])
        log(f'[{sc.name}] time {name}: ' + json.dumps(times[name]))
    return errs, times


def forward_checks(sc):
    """The forward kernels against their plain versions on the card at
    this size's shapes, over their own per-tile lists and over those of the
    soft mask's enlarged bboxes (``dibr_rasterization``'s shared binning),
    two launches against each other. Returns ({kernel: max abs error}, the
    interp mode's face_idx)."""
    errs = {}

    def record(name, err):
        errs[name] = max(errs.get(name, 0.), err)

    kw = dict(height=H, width=W, multiplier=1000., eps=1e-8)
    shared = kr.tile_bins(sc.sm_bbox, height=H, width=W, multiplier=1000.)
    expect(torch.equal(shared, kr.tile_bins_plain(sc.sm_bbox, height=H,
                                                  width=W,
                                                  multiplier=1000.)),
           f'[{sc.name}] tile_bins disagrees with its plain version')

    # interp, D = 4, with normal-z culling
    args = (sc.fz, sc.img, sc.bbox, sc.feat4)
    feat_p, idx_p, w_p = kr.rasterize_interp_plain(*args, **kw)
    z_p, sidx_p = kr.rasterize_select_plain(sc.fz, sc.img, sc.bbox, **kw)
    for lists, bkw in (('own', {}), ('shared', {'bins': shared})):
        feat_k, idx_k, w_k = kr.rasterize_interp(*args, **kw, **bkw)
        again = kr.rasterize_interp(*args, **kw, **bkw)
        torch.cuda.synchronize()
        mism = int((idx_k != idx_p).sum())
        ew, ef = max_err(w_k, w_p), max_err(feat_k, feat_p)
        same = all(same_bits(a, b) for a, b in zip((feat_k, idx_k, w_k),
                                                   again))
        log(f'[{sc.name}] rasterize_interp D=4 ({lists} lists): face_idx '
            f'mismatches {mism}, covered '
            f'{float((idx_k >= 0).float().mean()):.4f}, max err weights '
            f'{ew:.3e} features {ef:.3e}, two launches bit-identical {same}')
        expect(mism == 0 and ew <= TOL_WEIGHTS and ef <= TOL_FEATURES
               and same, 'rasterize_interp disagrees with its plain version')
        record('rasterize_interp', max(ew, ef))

        # select, D = 40
        z_k, sidx_k = kr.rasterize_select(sc.fz, sc.img, sc.bbox, **kw,
                                          **bkw)
        again = kr.rasterize_select(sc.fz, sc.img, sc.bbox, **kw, **bkw)
        torch.cuda.synchronize()
        mism = int((sidx_k != sidx_p).sum())
        cov = sidx_k >= 0
        ez = max_err(z_k, z_p, cov)
        same = same_bits(z_k, again[0]) and same_bits(sidx_k, again[1])
        expect(bool(torch.isneginf(z_k[~cov]).all()),
               'select: uncovered zbuf')
        log(f'[{sc.name}] rasterize_select ({lists} lists): face_idx '
            f'mismatches {mism} (vs interp {int((sidx_k != idx_k).sum())}), '
            f'max err zbuf {ez:.3e}, two launches bit-identical {same}')
        expect(mism == 0 and ez <= TOL_WEIGHTS and same
               and bool((sidx_k == idx_k).all()),
               'rasterize_select disagrees with its plain version')
        record('rasterize_select', ez)
    idx_main = idx_p

    # soft mask: the default knum, one that never binds, one that binds
    hits = pixel_hits(sc.sm_bbox, H, W)[idx_main < 0]
    log(f'[{sc.name}] soft mask: most enlarged-bbox hits on an uncovered '
        f'pixel {int(hits.max())}')
    for knum in (KNUM, sc.num_faces, 2):
        skw = dict(height=H, width=W, knum=knum, sigmainv=7000.,
                   multiplier=1000.)
        m_p, c_p = ks.soft_mask_forward_plain(sc.sm_img, sc.sm_bbox,
                                              idx_main, return_cut=True,
                                              **skw)
        for lists, bkw in (('own', {}), ('shared', {'bins': shared})):
            m_k, c_k = ks.soft_mask_forward(sc.sm_img, sc.sm_bbox, idx_main,
                                            return_cut=True, **skw, **bkw)
            m_a, c_a = ks.soft_mask_forward(sc.sm_img, sc.sm_bbox, idx_main,
                                            return_cut=True, **skw, **bkw)
            torch.cuda.synchronize()
            em = max_err(m_k, m_p)
            cut_mism = int((c_k != c_p).sum())
            binds = int((hits > knum).sum())
            same = same_bits(m_k, m_a) and same_bits(c_k, c_a)
            log(f'[{sc.name}] soft_mask_forward knum={knum} ({lists} '
                f'lists): pixels where knum binds {binds}, max err '
                f'{em:.3e}, cut mismatches {cut_mism}, two launches '
                f'bit-identical {same}')
            expect(em <= TOL_MASK and cut_mism == 0 and same,
                   'soft_mask_forward disagrees with its plain version at '
                   f'knum={knum}')
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

    return errs, idx_main


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
                          device_ms=device_ms(f'[{sc.name}] {key}', fn),
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
        # the forward's culling, as the train step passes it
        vkw = dict(eps=1e-8, valid_faces=sc.valid)
        for cot_name, cot in (('random', rand), ('train', g_feat)):
            args = (cot, idx, weights, sc.fvi, feats)
            out = krb.rasterize_backward(*args, **vkw)
            again = krb.rasterize_backward(*args, **vkw)
            ref = krb.rasterize_backward_plain(*args, eps=1e-8)
            torch.cuda.synchronize()
            errs['rasterize_backward'] = max(
                errs['rasterize_backward'], grad_errors(
                    f'[{sc.name}] rasterize_backward D={dim} {cot_name} '
                    'cotangent', out, again, ref))
        timed('rasterize_backward' + ('' if dim == 4 else f' D={dim}'),
              lambda: krb.rasterize_backward(*args, **vkw),
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


def pixel_rects(x0, x1, y0, y1, sx, sy):
    """Per face, the pixel rectangle the backward kernels walk: the columns
    and rows whose centres ``s * (2i + 1 - n)`` can lie in [x0, x1) x
    [y0, y1), padded by one, clipped to the image. Returns (c0, c1, r0,
    r1), empty where c1 < c0 or r1 < r0."""
    def span(v0, v1, s, n):
        lo = torch.floor((v0 / s + (n - 1)) * 0.5) - 1
        hi = torch.ceil((v1 / s + (n - 1)) * 0.5) + 1
        return lo.clamp(0, n).long(), hi.clamp(-1, n - 1).long()
    c0, c1 = span(x0, x1, sx, W)
    r0, r1 = span(-y1, -y0, sy, H)
    return c0, c1, r0, r1


def rect_sums(table, rects):
    """Per face, the sum of ``table`` (B, H, W) over its rectangle, from an
    integral image."""
    B = table.shape[0]
    c0, c1, r0, r1 = rects
    s = F.pad(table.long().cumsum(1).cumsum(2), (1, 0, 1, 0))
    b = torch.arange(B, device=table.device)[:, None]
    c1, r1 = torch.maximum(c1, c0 - 1) + 1, torch.maximum(r1, r0 - 1) + 1
    return s[b, r1, c1] - s[b, r0, c1] - s[b, r1, c0] + s[b, r0, c0]


def backward_counts(sc):
    """The counts that size the backward kernels' designs, at the train
    step's cotangents (D = 4, knum 30): the faces that own a covered pixel,
    the faces whose enlarged rectangle holds a live pixel (uncovered, inside
    some face's enlarged bbox, nonzero cotangent), the pixels per face of
    both rectangles (mean, 99th percentile), the recorded (pixel, face)
    pairs and the candidates the soft-mask backward tests (live pixels in
    each face's rectangle)."""
    _, g_mask, idx = sc.cotangents(4)
    B, F_ = sc.batch, sc.num_faces
    flat = idx.reshape(B, -1).long()
    seg = (torch.arange(B, device='cuda')[:, None] * F_ + flat)[flat >= 0]
    owned = torch.bincount(seg, minlength=B * F_)
    v = sc.fvi.reshape(B, F_, 3, 2)
    one = torch.tensor(1., device='cuda')
    rast = pixel_rects(v[..., 0].amin(-1), v[..., 0].amax(-1),
                       v[..., 1].amin(-1), v[..., 1].amax(-1), one / W,
                       one / H)
    bb = sc.sm_bbox
    soft = pixel_rects(bb[..., 0], bb[..., 2], bb[..., 1], bb[..., 3],
                       torch.tensor(1000. / W, device='cuda'),
                       torch.tensor(1000. / H, device='cuda'))
    hits = pixel_hits(bb, H, W) * (idx < 0)
    live = (hits > 0) & (g_mask != 0)
    cand = rect_sums(live, soft)
    counts = {
        'faces': B * F_,
        'faces owning a covered pixel': float((owned > 0).float().mean()),
        'owned pixels per owning face': float(owned[owned > 0].float()
                                              .mean()),
        'faces whose enlarged rectangle holds a live pixel':
            float((cand > 0).float().mean()),
        'live pixels': int(live.sum()),
        'recorded pairs': int(hits.clamp(max=KNUM).sum()),
        'recorded pairs at live pixels': int(hits.clamp(max=KNUM)[live]
                                             .sum()),
        'soft-mask candidates (live pixels in rectangles)': int(cand.sum())}
    for name, (c0, c1, r0, r1) in (('rasterize', rast), ('soft mask', soft)):
        n = ((c1 - c0 + 1).clamp(min=0) * (r1 - r0 + 1).clamp(min=0)).float()
        counts[f'{name} rectangle pixels, mean'] = float(n.mean())
        counts[f'{name} rectangle pixels, p99'] = float(
            torch.quantile(n.flatten(), 0.99))
    log(f'[{sc.name}] backward counts: ' + json.dumps(counts))
    return counts


def tile_pass(bbox, height, width, tile=16, chunk=None):
    """Per (face, 16x16 pixel tile), whether the face's bbox overlaps the
    tile's pixel-centre rectangle by the forward kernels' float test
    (``bb[0] <= x_hi && bb[2] > x_lo && bb[1] <= y_hi && bb[3] > y_lo``).
    Returns the faces per tile (B, tile rows, tile columns) int64, or with
    ``chunk`` the nonempty (tile, ``chunk``-face range) sublists too."""
    B, F_ = bbox.shape[:2]
    x0, y0 = _pixel_coords(height, width, 1000., bbox.dtype,
                           device=bbox.device)
    c0 = torch.arange(0, width, tile, device=bbox.device)
    r0 = torch.arange(0, height, tile, device=bbox.device)
    c1, r1 = (c0 + tile).clamp(max=width) - 1, (r0 + tile).clamp(
        max=height) - 1
    xp = ((bbox[..., 0, None] <= x0[c1]) & (bbox[..., 2, None] > x0[c0]))
    yp = ((bbox[..., 1, None] <= y0[r0]) & (bbox[..., 3, None] > y0[r1]))
    counts = torch.zeros((B, len(r0), len(c0)), dtype=torch.int64,
                         device=bbox.device)
    sublists = 0
    step = chunk or F_
    for s in range(0, F_, step):
        # 0/1 products summed in float32: exact below 2^24
        part = torch.bmm(yp[:, s:s + step].transpose(1, 2).float(),
                         xp[:, s:s + step].float()).long()
        counts += part
        sublists += int((part > 0).sum())
    return (counts, sublists) if chunk else counts


def forward_counts(sc, knum=KNUM):
    """The counts that size the forward kernels' per-tile face lists, for
    the rasterizer's bboxes (culled faces empty) and the soft mask's
    enlarged ones (every face): the (tile, face) overlap pairs against the
    sweep's tile x face tests, the tiles with none, the faces per tile
    (mean, 99th percentile, max) and the nonempty (tile, 1,024-face range)
    sublists; and the tiles the soft mask walks (an uncovered pixel)."""
    B, F_ = sc.batch, sc.num_faces
    _, idx, _ = kr.rasterize_interp(sc.fz, sc.img, sc.bbox, sc.feat4,
                                    height=H, width=W, multiplier=1000.,
                                    eps=1e-8)
    counts = {'faces': B * F_, 'tiles': B * ((H + 15) // 16)
              * ((W + 15) // 16)}
    counts['sweep tests'] = counts['tiles'] * F_
    unc = F.max_pool2d((idx < 0).float()[:, None], 16, ceil_mode=True)[:, 0]
    counts['tiles with an uncovered pixel'] = int(unc.sum())
    for name, bb in (('rasterize', sc.bbox), ('soft mask', sc.sm_bbox)):
        per_tile, sub = tile_pass(bb, H, W, chunk=1024)
        n = per_tile.flatten().float()
        counts[f'{name} pairs'] = int(n.sum())
        counts[f'{name} tiles with none'] = int((n == 0).sum())
        counts[f'{name} faces per tile, mean'] = float(n.mean())
        counts[f'{name} faces per tile, p99'] = float(
            torch.quantile(n, 0.99))
        counts[f'{name} faces per tile, max'] = int(n.max())
        counts[f'{name} nonempty 1024-face sublists'] = sub
    live = per_tile.flatten()[unc.flatten() > 0]
    counts['soft mask pairs on tiles with an uncovered pixel'] = int(
        live.sum())
    log(f'[{sc.name}] forward counts: ' + json.dumps(counts))
    return counts


def resource_usage(names=('rasterize', 'rasterize_bwd', 'soft_mask')):
    """``nvcc -Xptxas -v`` for ``csrc/<name>.cu`` with the build's flags:
    each kernel's registers, spills and shared memory, logged."""
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ('-shared', '-Xcompiler', '-fPIC')]
    for name in names:
        src = _build._CSRC / f'{name}.cu'
        out = _build._BUILD_DIR / f'{name}.ptxas.cubin'
        out.parent.mkdir(parents=True, exist_ok=True)
        res = subprocess.run([_build._nvcc(), *flags, '-cubin', '-Xptxas',
                              '-v', '-o', str(out), str(src)],
                             capture_output=True, text=True, timeout=600)
        for line in (res.stdout + res.stderr).splitlines():
            if 'ptxas info' in line or 'spill' in line:
                log(f'[ptxas {name}] {line.strip()}')
        expect(res.returncode == 0, f'nvcc -Xptxas -v failed on {name}.cu')


def backward_times(label, sc):
    """Both backward kernels at the train step's cotangents on ``sc``,
    rasterize at D = 4 and D = WIDE, the soft mask at knum KNUM, each timed
    with CUDA events and by the card alone. Returns {name: times}."""
    out = {}
    skw = dict(height=H, width=W, sigmainv=7000., multiplier=1000.)
    for dim in (4, WIDE):
        feats = sc.features(sc.fvc, dim).reshape(sc.batch, -1, 3 * dim)
        _, idx, weights = kr.rasterize_interp(
            sc.fz, sc.img, sc.bbox, feats, height=H, width=W,
            multiplier=1000., eps=1e-8)
        g_feat, g_mask, _ = sc.cotangents(dim)
        args = (g_feat, idx, weights, sc.fvi, feats)
        # the forward's culling, as the train step passes it, where the
        # wrapper takes it
        vkw = ({'valid_faces': sc.valid} if 'valid_faces' in
               inspect.signature(krb.rasterize_backward).parameters else {})

        def fn():
            return krb.rasterize_backward(*args, eps=1e-8, **vkw)
        key = f'rasterize_backward D={dim}, {sc.name}'
        out[key] = dict(ms=time_ms(fn, TIME_ITERS),
                        device_ms=device_ms(f'[{label}] {key}', fn))
    mask, cut = ks.soft_mask_forward(sc.sm_img, sc.sm_bbox, idx, knum=KNUM,
                                     return_cut=True, **skw)

    def soft():
        return ks.soft_mask_backward(sc.sm_img, sc.sm_bbox, cut, mask,
                                     g_mask, **skw)
    key = f'soft_mask_backward, {sc.name}'
    out[key] = dict(ms=time_ms(soft, TIME_ITERS),
                    device_ms=device_ms(f'[{label}] {key}', soft))
    return out


def forward_times(label, sc):
    """The forward kernels on ``sc`` (rasterize at D = 4 and in select
    mode, the soft mask at knum KNUM on the rasterizer's coverage) and the
    user's forward render at D = 4 and D = WIDE, each timed with CUDA
    events and by the card alone. Returns {name: times}."""
    out = {}
    kw = dict(height=H, width=W, multiplier=1000., eps=1e-8)
    _, idx, _ = kr.rasterize_interp(sc.fz, sc.img, sc.bbox, sc.feat4, **kw)
    skw = dict(height=H, width=W, knum=KNUM, sigmainv=7000.,
               multiplier=1000.)
    fns = {
        'rasterize_interp D=4': lambda: kr.rasterize_interp(
            sc.fz, sc.img, sc.bbox, sc.feat4, **kw),
        'rasterize_select': lambda: kr.rasterize_select(
            sc.fz, sc.img, sc.bbox, **kw),
        f'soft_mask_forward knum={KNUM}': lambda: ks.soft_mask_forward(
            sc.sm_img, sc.sm_bbox, idx, **skw)}
    for dim in (4, WIDE):
        fns[f'forward render D={dim}'] = (lambda d: lambda: sc.forward(d))(
            dim)
    for key, fn in fns.items():
        out[f'{key}, {sc.name}'] = dict(
            ms=time_ms(fn, TIME_ITERS),
            device_ms=device_ms(f'[{label}] {key}, {sc.name}', fn))
    return out


def nn_brute_times(label, n):
    """The brute-force ``nearest_idx`` on two uniform clouds of n points
    (B = 1), with CUDA events and by the card alone, its CUDA launches and
    host syncs a call, beside its bound and the library's two forms
    (``cdist_argmin`` up to CDIST_DIRECT_MAX points)."""
    p1, p2 = kt.utils.interop.metrics_scene(SEED, n, n, 1)[:2]

    def fn():
        return kn.nearest_idx(p1, p2)
    bnd = bound(4 * (3 * n * 2 + n), n ** 2 * OPS_NN_PAIR)
    what = f'nearest_idx, {n} x {n}'
    out = dict(ms=time_ms(fn, TIME_ITERS),
               device_ms=device_ms(f'[{label}] {what}', fn),
               launches_per_call=launches_per_call(f'[{label}] {what}', fn),
               host_syncs=host_syncs(fn), bound_ms=bnd[0], bound_by=bnd[1],
               library_ms=(time_ms(lambda: cdist_argmin(p1, p2), TIME_ITERS)
                           if n <= CDIST_DIRECT_MAX else None),
               library_mm_ms=time_ms(lambda: cdist_mm_argmin(p1, p2),
                                     TIME_ITERS))
    log(f'[{label}] time {what} points: ' + json.dumps(out))
    return out


def nn_metric_times(label):
    """End to end, through the brute-force kernel: ``f_score`` of two
    clouds of FIT3_EVAL points (the mesh fit's) and ``chamfer_distance`` of
    two of DIBR_CHAMFER_N (``examples/dibr_train.py``'s), B = 1, each with
    CUDA events and by the card alone. Returns {name: times}."""
    p1, p2 = kt.utils.interop.metrics_scene(SEED, FIT3_EVAL, FIT3_EVAL, 1)[:2]
    q1, q2 = kt.utils.interop.metrics_scene(SEED, DIBR_CHAMFER_N,
                                            DIBR_CHAMFER_N, 1)[:2]
    fns = {f'f_score, {FIT3_EVAL} x {FIT3_EVAL}':
           lambda: kt.metrics.pointcloud.f_score(p1, p2, radius=FIT3_RADIUS),
           f'chamfer_distance, {DIBR_CHAMFER_N} x {DIBR_CHAMFER_N}':
           lambda: kt.metrics.pointcloud.chamfer_distance(q1, q2)}
    out = {}
    for key, fn in fns.items():
        out[key] = dict(ms=time_ms(fn, TIME_ITERS),
                        device_ms=device_ms(f'[{label}] {key}', fn))
        log(f'[{label}] time {key}: ' + json.dumps(out[key]))
    return out


def train_step_times(label, sc):
    """``bench.py``'s train step on ``sc``: ms per step over TRAIN_STEPS
    chained steps (CUDA events) and the card's own time per step."""
    ms = time_ms(lambda: sc.train(TRAIN_STEPS), 1) / TRAIN_STEPS
    return dict(ms=ms, device_ms=device_ms(f'[{label}] train step, '
                                           f'{sc.name}', lambda: sc.train(1),
                                           iters=5))


def grid_sample_checks(label, maps, ix, iy, cots, errs):
    """Both grid-sample kernels against their plain versions, in both
    modes, for each (name, cotangent) of ``cots``; the largest errors go
    into ``errs``."""
    for mode in ('bilinear', 'nearest'):
        out = ktex.grid_sample(maps, ix, iy, mode)
        ref = ktex.grid_sample_plain(maps, ix, iy, mode)
        torch.cuda.synchronize()
        e = max_err(out, ref)
        again = ktex.grid_sample(maps, ix, iy, mode)
        same = bool(torch.equal(out, ref)) and bool(torch.equal(out, again))
        log(f'[{label}] grid_sample {mode}: max err {e:.3e}, bit-equal to '
            f'the plain version and between two launches {same}')
        expect(same, f'[{label}] grid_sample {mode} is not bit-equal to its '
               'plain version')
        errs['grid_sample'] = max(errs['grid_sample'], e)
        inter = ktex._grid_sample(maps, ix, iy, mode)[1]
        for cot_name, cot in cots:
            tag = f'[{label}] grid_sample_backward {mode} {cot_name} cotangent'
            out = ktex.grid_sample_backward(maps, ix, iy, cot, mode)
            again = ktex.grid_sample_backward(maps, ix, iy, cot, mode, inter)
            ref = ktex.grid_sample_backward_plain(maps, ix, iy, cot, mode)
            torch.cuda.synchronize()
            worst = atomic_close(f'{tag} grad texture', out[0], ref[0],
                                 maps, ix, iy, cot, mode)
            stable = same_bits(out[0], again[0])
            log(f'{tag} grad texture: two launches (the second with the '
                f'forward\'s interleaved copy) bit-identical {stable}, '
                f'largest difference {max_err(out[0], again[0]):.3e}')
            expect(stable, f'{tag}: two launches differ in grad texture')
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
                expect(same and exact, f'{tag}: grad {name} differs between '
                       'two launches or from the plain version')
            errs['grid_sample_backward'] = max(errs['grid_sample_backward'],
                                               worst)


def zero_cotangent_checks(maps, ix, iy):
    """The backward with no live point (a zero cotangent, and no channel)
    at the step's points, both modes, on a scratch that the caching
    allocator hands back holding 0x7f bytes (as an int, an index far past
    every buffer): the texture gradient must be zero, dix and diy the plain
    version's, and nothing may fault."""
    B, C, th, tw = maps.shape
    P = ix.shape[1]
    for c in (C, 0):
        m = maps[:, :c].contiguous()
        cot = torch.zeros(B, P, c, device='cuda')
        for mode in ('bilinear', 'nearest'):
            nbytes, *_, slots = ktex._backward_layout(
                B, c, th, tw, P, mode == 'nearest', False)
            junk = torch.full((nbytes,), 0x7f, dtype=torch.uint8,
                              device='cuda')
            del junk
            out = ktex.grid_sample_backward(m, ix, iy, cot, mode)
            ref = ktex.grid_sample_backward_plain(m, ix, iy, cot, mode)
            torch.cuda.synchronize()
            ok = (not out[0].any() and bool(torch.equal(out[1], ref[1]))
                  and bool(torch.equal(out[2], ref[2])))
            log(f'[textured] grid_sample_backward {mode}, C = {c}, zero '
                f'cotangent on a dirty scratch ({slots} slots of partial '
                f'tiles): zero texture gradient, dix and diy equal to the '
                f'plain version {ok}')
            expect(ok, f'[textured] grid_sample_backward {mode}, C = {c}: '
                   'a zero cotangent gave a nonzero gradient')


def atomic_close(label, out, plain, maps, ix, iy, cot, mode):
    """Checks a texture gradient, a sum in another order than the plain
    version's, against the plain version in float64, entry by entry:
    |out - ref| <= GRAD_TOL * (|ref| + median nonzero |ref|) + TOL_ATOMIC
    * (the sum of the entry's terms' magnitudes). Prints the float32 plain
    version's ratio under the same rule beside the kernel's; returns the
    kernel's largest absolute error."""
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
    grid_sample_counts('[textured step cotangent]', tex, ix, iy, cot)
    grid_sample_counts('[textured random cotangent]', tex, ix, iy, rand_cot)
    errs = dict.fromkeys(('grid_sample', 'grid_sample_backward'), 0.)
    grid_sample_checks('config2 UV map', tex, ix, iy,
                       (('train', cot), ('random', rand_cot)), errs)
    grid_sample_checks(f'{th}x{tw} random coords', tex,
                       *rand_coords(th, tw), (('random', rand_cot),), errs)
    grid_sample_checks('64x64 random coords', small, *rand_coords(64, 64),
                       (('random', rand_cot),), errs)
    zero_cotangent_checks(tex, ix, iy)

    lib_fwd, grid = library_grid_sample(tex, ix, iy)
    cot_lib = cot.transpose(1, 2).reshape(B, C, 1, P).contiguous()

    def lib_bwd():
        return torch.ops.aten.grid_sampler_2d_backward(
            cot_lib, tex, grid, 0, 1, False, [True, True])

    e_lib = max_err(lib_fwd()[:, :, 0].transpose(1, 2),
                    ktex.grid_sample(tex, ix, iy))
    log(f'[textured] F.grid_sample vs the kernel at the step: max diff '
        f'{e_lib:.3e}')
    shape = (f'texture {B}x{C}x{th}x{tw} at {B}x{P} points (config 2 '
             f'step, {tsc.num_faces} faces, {H}x{W})')
    times = {'grid_sample': dict(
        sampler_times('[textured]', tex, ix, iy),
        plain_ms=time_ms(lambda: ktex.grid_sample_plain(tex, ix, iy), 3))}
    times['grid_sample_backward'] = dict(
        ms=time_ms(lambda: ktex.grid_sample_backward(tex, ix, iy, cot),
                   TIME_ITERS),
        plain_ms=time_ms(lambda: ktex.grid_sample_backward_plain(
            tex, ix, iy, cot), 3),
        library_ms=time_ms(lib_bwd, TIME_ITERS))
    for name in times:
        bnd = grid_sample_bound(tex, P, name == 'grid_sample_backward')
        times[name].update(bound_ms=bnd[0], bound_by=bnd[1], shape=shape)
        log(f'[textured] time {name} (the step\'s cotangent): '
            + json.dumps(times[name]))
    rand_ms = time_ms(lambda: ktex.grid_sample_backward(tex, ix, iy,
                                                        rand_cot), TIME_ITERS)
    log(f'[textured] time grid_sample_backward with a random cotangent, '
        f'nonzero on the background too: {rand_ms:.4f} ms')
    return errs, times


def library_grid_sample(tex, ix, iy):
    """The library's yardstick for the grid sampler: ``F.grid_sample`` of
    the same points as a normalised grid. Returns (call, grid)."""
    th, tw = tex.shape[2:]
    grid = torch.stack([(2. * ix + 1.) / tw - 1., (2. * iy + 1.) / th - 1.],
                       -1)[:, None]

    def call():
        return F.grid_sample(tex, grid, 'bilinear', 'border',
                             align_corners=False)
    return call, grid


def sampler_times(label, tex, ix, iy):
    """``grid_sample`` and ``F.grid_sample`` on the same points, each timed
    with CUDA events and by the card alone: dict(ms, device_ms, library_ms,
    library_device_ms)."""
    lib, _ = library_grid_sample(tex, ix, iy)

    def fn():
        return ktex.grid_sample(tex, ix, iy)
    return dict(ms=time_ms(fn, TIME_ITERS),
                device_ms=device_ms(f'{label} grid_sample', fn),
                library_ms=time_ms(lib, TIME_ITERS),
                library_device_ms=device_ms(f'{label} F.grid_sample', lib))


# the texel tiles of grid_sample_backward's binning (csrc/grid_sample.cu
# TILE), and the names its kernels take in a profile (the parent design's
# one kernel, then the binned design's four)
GS_TILE = 32
GS_BWD_KERNELS = ('grid_sample_bwd_kernel', 'gs_bwd_')


def grid_sample_counts(label, maps, ix, iy, cot):
    """The counts that size ``grid_sample_backward``'s reduction at one
    bilinear input, computed from the tensors (no kernel): the points with
    a nonzero cotangent; the float adds a scatter of every nonzero term
    makes (the atomics of a design that adds each); the texels they touch
    and the most terms on one texel and channel; the (GS_TILE x GS_TILE
    texel tile, live point) pairs; the live points a tile (mean, p99,
    max); the share of live points whose taps straddle two or more
    tiles."""
    B, C, th, tw = maps.shape
    dev = ix.device
    live = (cot != 0).any(-1)
    taps, wx, wy = ktex._bilinear_taps(ix, iy, th, tw)
    ax, ay = 1 - wx, 1 - wy
    plane = (torch.arange(B, device=dev)[:, None, None] * C
             + torch.arange(C, device=dev)) * (th * tw)        # (B, 1, C)
    per_addr = torch.zeros(B * C * th * tw, dtype=torch.int64, device=dev)
    adds = 0
    for idx, w1, w2 in zip(taps, (ax, wx, ax, wx), (ay, ay, wy, wy)):
        nz = (cot * w1[..., None] * w2[..., None]) != 0
        adds += int(nz.sum())
        per_addr += torch.bincount((plane + idx[..., None])[nz],
                                   minlength=per_addr.numel())
    touched = int((per_addr.view(B, C, -1) > 0).any(1).sum())
    tiles_x = -(-tw // GS_TILE)
    keys = torch.stack([(i // tw) // GS_TILE * tiles_x + (i % tw) // GS_TILE
                        for i in taps], -1).sort(-1).values     # (B, P, 4)
    distinct = 1 + (keys[..., 1:] != keys[..., :-1]).sum(-1)
    first = torch.cat([torch.ones_like(keys[..., :1], dtype=torch.bool),
                       keys[..., 1:] != keys[..., :-1]], -1) & live[..., None]
    ntiles = tiles_x * -(-th // GS_TILE)
    tile_ids = (torch.arange(B, device=dev)[:, None, None] * ntiles
                + keys)[first]
    per_tile = torch.bincount(tile_ids, minlength=B * ntiles).double()
    nlive = int(live.sum())
    out = dict(points=live.numel(), live=nlive, atomic_adds=adds,
               texels_touched=touched, most_terms_one_texel=int(
                   per_addr.max()), tile_point_pairs=int(tile_ids.numel()),
               tiles=B * ntiles, points_a_tile_mean=float(per_tile.mean()),
               points_a_tile_p99=float(torch.quantile(per_tile, 0.99)),
               points_a_tile_max=float(per_tile.max()),
               straddle_share=float((distinct[live] >= 2).double().mean())
               if nlive else 0.)
    log(f'{label} grid_sample_backward counts: ' + json.dumps(out))
    return out


def sampler_backward_times(label, tex, ix, iy, cot, name):
    """``grid_sample_backward`` at one cotangent: ms with CUDA events, the
    card's own time and the CUDA activities a call launches."""
    def fn():
        return ktex.grid_sample_backward(tex, ix, iy, cot)
    key = f'grid_sample_backward, {name}'
    return dict(ms=time_ms(fn, TIME_ITERS),
                device_ms=device_ms(f'[{label}] {key}', fn),
                launches_per_call=launches_per_call(f'[{label}] {key}', fn))


def host_syncs(fn):
    """The synchronizing CUDA operations of one call of ``fn``, as
    ``torch.cuda.set_sync_debug_mode('warn')`` reports them."""
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    # (the mode's first use also warns that it is a prototype)
    return sum('called a synchronizing' in str(w.message) for w in caught)


def host_wall_ms(fn, calls=10, reps=5):
    """The host's ms a call to issue ``calls`` calls of ``fn`` (no sync
    among them) and the wall ms a call until the card has run them, from
    the same start, over ``reps`` repetitions after three warm-up calls:
    dict(host_ms, wall_ms), each sorted. Where host_ms comes near wall_ms,
    the host keeps the card waiting."""
    for _ in range(3):
        fn()
    host, wall = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) / calls * 1e3)
        wall.append((t2 - t0) / calls * 1e3)
    return dict(host_ms=sorted(host), wall_ms=sorted(wall))


# the kernel that ends a level of the traversal in a profile: the parent
# design's emit, the fused design's one kernel a level
TRAV_LEVEL_END = ('spc_emit_kernel', 'spc_level_kernel')


def level_device_ms(label, fn):
    """The card's time of each level of one trace: the kernels, fills and
    copies of one call of ``fn`` (``torch.profiler``) in start order, cut
    after each level's last kernel; what follows the last level (the read
    of the counts) is the last entry. None if the trace has no device
    time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    if not evs:
        log(f'{label}: no device time in the trace; not measured')
        return None
    levels, cur = [], 0.
    for e in evs:
        cur += e.time_range.elapsed_us() / 1e3
        if any(k in e.name for k in TRAV_LEVEL_END):
            levels.append(round(cur, 5))
            cur = 0.
    levels.append(round(cur, 5))
    log(f'{label}: device ms a level {levels[:-1]}, then {levels[-1]}; '
        f'{len(evs)} device activities: '
        + ', '.join(e.name[:32] for e in evs))
    return levels


def trace_times(label, name, fn):
    """One traversal or trace: ms with CUDA events, the card's own time,
    its device activities, its host syncs and each level's device time."""
    out = dict(ms=time_ms(fn, TIME_ITERS),
               device_ms=device_ms(f'[{label}] {name}', fn),
               launches_per_call=launches_per_call(f'[{label}] {name}', fn),
               host_syncs=host_syncs(fn),
               level_device_ms=level_device_ms(f'[{label}] {name}', fn))
    log(f'[{label}] time {name}: ' + json.dumps(out))
    return out


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


def textured_step_ms(tsc):
    """Config 2's textured step, ms per step over TRAIN_STEPS chained
    steps after a warm-up."""
    ms = time_ms(lambda: tsc.train(TRAIN_STEPS), 1) / TRAIN_STEPS
    log(f'[textured] train step: {ms:.4f} ms per step, '
        f'{ms / tsc.batch:.4f} ms/frame (batch {tsc.batch}, '
        f'{tsc.num_faces} faces, {H}x{W}, {TEX_SIZE}x{TEX_SIZE} texture, '
        f'{TRAIN_STEPS} chained steps)')
    return ms


def device_ms(label, fn, iters=TIME_ITERS):
    """The card's own time of one call of ``fn``: ``torch.profiler``'s
    device time of every kernel it launches, summed, over ``iters`` calls
    after a warm-up. ``None`` (not measured) if the trace holds no device
    time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per = {e.key: e.self_device_time_total / 1e3 / iters
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0}
    if not per:
        log(f'{label}: no device time in the trace; not measured')
        return None
    total = sum(per.values())
    log(f'{label}: device time {total:.4f} ms per call ('
        + ', '.join(f'{k[:40]} {v:.4f}' for k, v in per.items()) + ')')
    return total


def profile_calls(label, fn, per_call_ms, iters=10, watch=()):
    """Device time of ``fn`` by kernel (``torch.profiler``), and the share
    of the call's time the card is idle. Kernels whose names hold one of
    ``watch`` are logged beside the 12 largest."""
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
        return None
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    log(f'{label}: device busy {busy_ms:.4f} ms of {per_call_ms:.4f} ms per '
        f'call, idle share {1. - busy_ms / per_call_ms:.3f}, '
        f'{len(kernels)} kernels')
    for i, e in enumerate(kernels):
        if i < 12 or any(w in e.key for w in watch):
            log(f'    {e.self_device_time_total / 1e3 / iters:.4f} ms in '
                f'{e.count / iters:g} launches: {e.key[:70]}')
    return dict(busy_ms=busy_ms, kernels={
        e.key: e.self_device_time_total / 1e3 / iters for e in kernels})


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
    brute_again = kn.nearest_idx(p1, p2)
    pruned = kn.nearest_idx_pruned(p1, p2)
    again = kn.nearest_idx_pruned(p1, p2)
    plain = kn.nearest_idx_plain(p1, p2)
    torch.cuda.synchronize()
    m_brute = int((brute != plain).sum())
    m_pruned = int((pruned != plain).sum())
    m_pair = int((pruned != brute).sum())
    same = bool(torch.equal(pruned, again) and torch.equal(brute,
                                                           brute_again))
    ref = nn_dist(p1, p2, plain)

    def err(idx):
        # equal distances, inf or NaN on both sides included (a non-finite
        # query's), are no difference
        d = nn_dist(p1, p2, idx)
        same = (d == ref) | (d.isnan() & ref.isnan())
        return float(torch.where(same, 0., (d - ref).abs()).max())
    e_brute, e_pruned = err(brute), err(pruned)
    log(f'[{label}] {p1.shape[1]} queries x {p2.shape[1]} references: '
        f'index mismatches against the plain version: nearest_idx {m_brute}, '
        f'nearest_idx_pruned {m_pruned}; pruned vs brute force {m_pair}; '
        'largest difference of the chosen distances '
        f'{max(e_brute, e_pruned)}; two launches of each bit-identical '
        f'{same}')
    expect(m_brute == 0 and m_pruned == 0 and m_pair == 0 and same,
           f'[{label}] a nearest-neighbour kernel disagrees')
    errs['nearest_idx'] = max(errs['nearest_idx'], e_brute)
    errs['nearest_idx_pruned'] = max(errs['nearest_idx_pruned'], e_pruned)


def p2m_checks(label, points, fv, errs):
    """``p2m_select`` against its plain version on every point, and two
    launches against each other; returns the plain version's result."""
    idx, types = kp.p2m_select(points, fv)
    again = kp.p2m_select(points, fv)
    ridx, rtypes = kp.p2m_select_plain(points, fv)
    torch.cuda.synchronize()
    mi, mt = int((idx != ridx).sum()), int((types != rtypes).sum())
    same = bool(torch.equal(idx, again[0]) and torch.equal(types, again[1]))
    err = float((p2m_dist(points, fv, idx)
                 - p2m_dist(points, fv, ridx)).abs().max())
    log(f'[{label}] p2m_select, {points.shape[1]} points x {fv.shape[1]} '
        f'faces: face mismatches {mi}, type mismatches {mt}, largest type '
        f'{int(types.max())}, largest difference of the chosen distances '
        f'{err}; two launches bit-identical {same}')
    expect(mi == 0 and mt == 0 and same, f'[{label}] p2m_select disagrees '
           'with its plain version or with itself')
    errs['p2m_select'] = max(errs['p2m_select'], err)
    return ridx, rtypes


def p2m_scored(label, points, fv):
    """The number of (point, face) pairs ``p2m_select``'s scan evaluated in
    full, the rest skipped by its plane cull; logged with the share."""
    scored = torch.zeros(1, dtype=torch.int64, device='cuda')
    kp.select_cuda(points, fv, scored=scored)
    n_pairs = points.shape[0] * points.shape[1] * fv.shape[1]
    log(f'[{label}] p2m cull: {int(scored)} of {n_pairs} pairs evaluated in '
        f'full, {1. - int(scored) / n_pairs:.4f} skipped')
    return int(scored)


def p2m_bound(points, fv, idx, rows=8192):
    """(bound ms, 'bytes' or 'operations', pairs in full) of one
    ``p2m_select`` call, from its inputs and the plain version's winners
    ``idx``: the plane test on every pair, and the full evaluation of each
    pair whose face's plane lies no farther from the point than its
    winner (float64), which no test by planes can rule out."""
    best = p2m_dist(points, fv, idx)
    f64 = fv.double()
    v1 = f64[..., 0, :]
    n = torch.cross(f64[..., 1, :] - v1, f64[..., 2, :] - v1, dim=-1)
    un = n / n.norm(dim=-1, keepdim=True)
    off = (v1 * un).sum(-1)
    kept = 0
    for i in range(0, points.shape[1], rows):
        s = points[:, i:i + rows].double() @ un.transpose(1, 2) - off[:, None]
        kept += int((s * s <= best[:, i:i + rows, None]).sum())
    B, N, F = points.shape[0], points.shape[1], fv.shape[1]
    nbytes = 4 * B * (3 * N + 9 * F + 2 * N)
    return bound(nbytes, B * N * F * OPS_P2M_PLANE
                 + kept * OPS_P2M_PAIR) + (kept,)


def flat_mesh():
    """M3_FACES faces, a 50 x 100 grid of split quads over the unit square
    in the plane z = 0.5: every face shares one plane, so the plane cull
    skips no pair, the scan's worst case. (1, M3_FACES, 3, 3) on the
    card."""
    nx, ny = 100, M3_FACES // 200
    g = np.mgrid[0:ny + 1, 0:nx + 1].reshape(2, -1).T
    verts = np.concatenate([g[:, 1:] / nx, g[:, :1] / ny,
                            np.full((len(g), 1), 0.5)], 1).astype(np.float32)
    quads = np.array([[i * (nx + 1) + j, i * (nx + 1) + j + 1,
                       (i + 1) * (nx + 1) + j, (i + 1) * (nx + 1) + j + 1]
                      for i in range(ny) for j in range(nx)])
    faces = np.concatenate([quads[:, [0, 1, 2]], quads[:, [1, 3, 2]]])
    return torch.tensor(verts[faces][None], device='cuda')


def p2m_scenes():
    """The timed ``p2m_select`` scenes, (name, points, face vertices):
    config 3 (random triangles), config 3's points against the flat mesh,
    and the mesh fit's first step (its FIT3_N target points against the
    unit icosphere of subdivision FIT3_SUBDIV)."""
    p1, _, fv = kt.utils.interop.metrics_scene(SEED, M3_N, M3_N, M3_FACES)
    gen = torch.Generator('cuda').manual_seed(SEED)
    target = kt.utils.interop.ellipsoid_points(FIT3_N, FIT3_TARGET_SUBDIV,
                                               FIT_SCALE, generator=gen)
    verts, faces = kt.utils.interop.mesh_from_numpy(
        *kt.utils.interop.icosphere(FIT3_SUBDIV))
    return [('config3', p1, fv), ('flat mesh', p1, flat_mesh()),
            ('mesh fit', target, verts[faces.long()][None].contiguous())]


def p2m_times(label, scenes):
    """``p2m_select`` on each scene, equal to its plain version, timed with
    CUDA events and by the card alone: {scene: dict(ms, device_ms)}."""
    out = {}
    for name, points, fv in scenes:
        got, ref = kp.p2m_select(points, fv), kp.p2m_select_plain(points, fv)
        expect(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
               f'[{label}] p2m_select disagrees with its plain version on '
               f'the {name} scene')

        def fn():
            return kp.p2m_select(points, fv)
        out[name] = dict(ms=time_ms(fn, TIME_ITERS), device_ms=device_ms(
            f'[{label}] p2m_select, {name}', fn))
        log(f'[{label}] time p2m_select, {name} ({points.shape[1]} points x '
            f'{fv.shape[1]} faces): ' + json.dumps(out[name]))
    return out


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


def cdist_mm_argmin(p1, p2, rows=4096):
    """The library's faster yardstick: ``torch.cdist`` in its
    matrix-product form (|q|^2 - 2 q.r + |r|^2 through a float32 matrix
    product, then a square root: other roundings, so near ties may go
    another way), then ``argmin``, over blocks of queries."""
    return torch.cat([torch.cdist(p1[:, i:i + rows], p2, compute_mode=
                                  'use_mm_for_euclid_dist').argmin(-1)
                      for i in range(0, p1.shape[1], rows)], dim=1)


def nan_scenes():
    """The NaN-chunk rule's scenes, (name, queries, references): config 3's
    clouds (the pruned route's size) and the F-score's (the brute-force
    route's, slices of 256), with a NaN coordinate in a reference of the
    first chunk of 1024, a middle one and the last, partial one; the DIB-R
    example's Chamfer clouds (slices of 64, 16 to a chunk) with one in a
    middle slice of the second chunk, so that the first stays clean; each
    with a NaN, an inf and a -inf query. No reference of a chunk with a
    NaN may be taken."""
    out = []
    for name, n, at in (
            ('config3 with NaN', M3_N, (700, M3_N // 2, M3_N - 1)),
            ('f-score with NaN', FIT3_EVAL, (700, FIT3_EVAL // 2,
                                             FIT3_EVAL - 1)),
            ('dibr chamfer with NaN', DIBR_CHAMFER_N, (1500,))):
        p1, p2 = kt.utils.interop.metrics_scene(SEED + 1, n, n, 1)[:2]
        for axis, j in enumerate(at):
            p2[0, j, axis] = float('nan')
        p1[0, :3, 0] = torch.tensor([float('nan'), float('inf'),
                                     float('-inf')])
        out.append((name, p1, p2))
    return out


def lattice_ties():
    """References on a 64 x 48 x 32 lattice of step 1/64 (98,304 points,
    shuffled) and M3_N queries at cell centres: every coordinate and
    difference is exact, so each query is equidistant, exactly, from the 8
    corners of its cell, which lie far apart in Morton order where the
    cell straddles a coarse boundary: ties span chunks visited out of
    order."""
    gen = torch.Generator('cuda').manual_seed(SEED)
    axes = [torch.arange(n, device='cuda', dtype=torch.float32) / 64.
            for n in (64, 48, 32)]
    lat = torch.stack(torch.meshgrid(*axes, indexing='ij'), -1).reshape(
        1, -1, 3)
    lat = lat[:, torch.randperm(lat.shape[1], device='cuda', generator=gen)]
    cells = torch.stack([torch.randint(0, n - 1, (1, M3_N), device='cuda',
                                       generator=gen) for n in (64, 48, 32)],
                        -1)
    return (cells.float() + 0.5) / 64., lat


def far_clusters():
    """M3_N queries and M3_N references, each half in a cube of side 0.1
    at the origin and half in one at (5, 5, 5)."""
    gen = torch.Generator('cuda').manual_seed(SEED)
    a = torch.rand(1, 2 * M3_N, 3, device='cuda', generator=gen) * 0.1
    a[:, M3_N // 2:M3_N] += 5.
    a[:, M3_N + M3_N // 2:] += 5.
    return a[:, :M3_N], a[:, M3_N:]


def sphere_centre():
    """The pruned scan's adversarial scene: M3_N queries within 1e-3 of
    the origin and M3_N references on the unit sphere (seeded). Every
    distance lies within 0.2% of every other, so no box test can skip
    much: the scan's worst case."""
    gen = torch.Generator('cuda').manual_seed(SEED)
    q = (torch.rand(1, M3_N, 3, device='cuda', generator=gen) - 0.5) * 1e-3
    s = torch.randn(1, M3_N, 3, device='cuda', generator=gen)
    return q, s / s.norm(dim=-1, keepdim=True)


def fit_clouds():
    """The mesh fit's clouds at its first step: FIT3_N samples of the unit
    icosphere of subdivision FIT3_SUBDIV and its FIT3_N target points."""
    gen = torch.Generator('cuda').manual_seed(SEED)
    target = kt.utils.interop.ellipsoid_points(FIT3_N, FIT3_TARGET_SUBDIV,
                                               FIT_SCALE, generator=gen)
    verts, faces = kt.utils.interop.mesh_from_numpy(
        *kt.utils.interop.icosphere(FIT3_SUBDIV))
    pts = kt.ops.mesh.sample_points(verts[None], faces, FIT3_N,
                                    generator=gen)[0]
    return pts.contiguous(), target


def prepass_checks(label, p1, p2):
    """The card's pruned prepass against its plain version on the card:
    keys, order, records and frame bit for bit, chunk boxes by value (NaN
    where a box holds only NaN records; their keys, in w, bit for bit)."""
    got, ref = kn.prepass(p1, p2), kn._prepass_plain(p1, p2)
    torch.cuda.synchronize()
    same = [torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                        b.view(torch.int32) if b.is_floating_point() else b)
            for a, b in zip(got[:4] + got[5:], ref[:4] + ref[5:])]
    box, rbox = got[4][..., :3], ref[4][..., :3]
    same.append(torch.equal(box.isnan(), rbox.isnan())
                and torch.equal(box.nan_to_num(0.), rbox.nan_to_num(0.))
                and torch.equal(got[4][..., 3].contiguous().view(torch.int32),
                                ref[4][..., 3].contiguous().view(torch.int32)))
    log(f'[{label}] pruned prepass, card vs plain (keys, order, query '
        f'records, reference records, frame, chunk boxes): {same}')
    expect(all(same), f'[{label}] the pruned prepass disagrees with its '
           'plain version')


def launches_per_call(label, fn, iters=5):
    """CUDA activities (kernels, copies, fills) per call of ``fn``, by
    ``torch.profiler``; None (not measured) if the trace holds none."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per = {e.key: e.count / iters for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0}
    if not per:
        log(f'{label}: no device activity in the trace; launches not '
            'measured')
        return None
    log(f'{label}: {sum(per.values()):g} launches per call ('
        + ', '.join(f'{k[:40]} x{v:g}' for k, v in per.items()) + ')')
    return sum(per.values())


def nn_times(label, p1, p2):
    """``nearest_idx_pruned`` equal to its plain version, then timed with
    CUDA events and by the card alone, with its launches per call (the
    prepass's included): dict(ms, device_ms, launches_per_call)."""
    expect(torch.equal(kn.nearest_idx_pruned(p1, p2),
                       kn.nearest_idx_plain(p1, p2)),
           f'[{label}] nearest_idx_pruned disagrees with its plain version')

    def fn():
        return kn.nearest_idx_pruned(p1, p2)
    out = dict(ms=time_ms(fn, TIME_ITERS),
               device_ms=device_ms(f'[{label}] nearest_idx_pruned', fn),
               launches_per_call=launches_per_call(
                   f'[{label}] nearest_idx_pruned', fn))
    log(f'[{label}] time nearest_idx_pruned ({p1.shape[1]} queries x '
        f'{p2.shape[1]} references): ' + json.dumps(out))
    return out


def prepass_times(label, p1, p2):
    """The pruned scan's prepass alone, with CUDA events and by the card
    alone: dict(ms, device_ms)."""
    def fn():
        return kn.prepass(p1, p2)
    out = dict(ms=time_ms(fn, TIME_ITERS),
               device_ms=device_ms(f'[{label}] the pruned prepass', fn))
    log(f'[{label}] time of the pruned prepass: ' + json.dumps(out))
    return out


def nn_scanned(label, p1, p2):
    """The share of (query, reference) pairs the pruned scan read, the
    rest skipped by its box tests."""
    scanned = torch.zeros(1, dtype=torch.int64, device='cuda')
    kn.scan_cuda(p1, p2, scanned=scanned)
    pairs = int(scanned) * kn.TQ * kn.CH
    share = pairs / (p1.shape[0] * p1.shape[1] * p2.shape[1])
    log(f'[{label}] pruned scan: {int(scanned)} chunks of {kn.TQ} x {kn.CH} '
        f'pairs scanned, {share:.6f} of all pairs')
    return share


def nn_big_times(label, iters=3):
    """``nearest_idx_pruned`` on two uniform clouds of NN_BIG points, equal
    to the brute-force kernel, then timed with CUDA events and by the card
    alone: dict(ms, device_ms)."""
    p1, p2 = kt.utils.interop.metrics_scene(SEED, NN_BIG, NN_BIG, 1)[:2]
    expect(torch.equal(kn.nearest_idx_pruned(p1, p2), kn.nearest_idx(p1, p2)),
           f'[{label}] nearest_idx_pruned disagrees with nearest_idx at '
           f'{NN_BIG} points')

    def fn():
        return kn.nearest_idx_pruned(p1, p2)
    out = dict(ms=time_ms(fn, iters),
               device_ms=device_ms(f'[{label}] nearest_idx_pruned, '
                                   f'{NN_BIG} points', fn, iters=iters))
    log(f'[{label}] time nearest_idx_pruned ({NN_BIG} queries x {NN_BIG} '
        'references, equal to nearest_idx): ' + json.dumps(out))
    return out, (p1, p2)


def nn_bound(label, p1, p2, rows=2048):
    """(bound ms, 'bytes' or 'operations', pairs) of one nearest-neighbour
    call that does not depend on the kernel's design: both clouds read and
    the indices written once, and 9 operations for each (query, reference)
    pair whose reference lies in the cube of half-side sqrt(winner
    distance) around the query (float64, from the plain winners): no test
    by axis-aligned boxes can rule those out."""
    h = nn_dist(p1, p2, kn.nearest_idx_plain(p1, p2)).sqrt()
    q, r = p1.double(), p2.double()
    pairs = 0
    for b in range(p1.shape[0]):
        for i in range(0, p1.shape[1], rows):
            hh = h[b, i:i + rows, None]
            inside = None
            for c in range(3):
                ax = (r[b, None, :, c] - q[b, i:i + rows, None, c]).abs() <= hh
                inside = ax if inside is None else inside & ax
            pairs += int(inside.sum())
    B, N1, N2 = p1.shape[0], p1.shape[1], p2.shape[1]
    out = bound(4 * B * (3 * N1 + 3 * N2 + N1), pairs * OPS_NN_PAIR) + (pairs,)
    log(f'[{label}] nearest_idx_pruned bound {out[0]:.6f} ms by {out[1]} '
        f'({pairs} pairs inside the winners\' cubes, '
        f'{pairs / (B * N1 * N2):.6f} of all)')
    return out


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
    nn_checks('lattice ties', *lattice_ties(), errs)
    nn_checks('two far clusters', *far_clusters(), errs)
    nn_checks('sphere centre', *sphere_centre(), errs)
    fit_pts, fit_target = fit_clouds()
    nn_checks('mesh fit samples->target', fit_pts, fit_target, errs)
    nn_checks('mesh fit target->samples', fit_target, fit_pts, errs)
    c1, c2 = kt.utils.interop.metrics_scene(SEED, DIBR_CHAMFER_N,
                                            DIBR_CHAMFER_N, 1)[:2]
    nn_checks('dibr chamfer p1->p2', c1, c2, errs)
    nn_checks('dibr chamfer p2->p1', c2, c1, errs)
    for name, a, b in nan_scenes():
        nn_checks(name, a, b, errs)
        prepass_checks(name, a, b)
    for name, a, b in (('config3', p1, p2), ('sphere centre',
                                             *sphere_centre())):
        prepass_checks(name, a, b)
    ref = p2m_checks('config3', p1, fv, errs)
    p2m_checks('config3 mesh doubled', p1, torch.cat([fv, fv], dim=1), errs)
    p2m_checks('points 0-2 ulps off the planes',
               *kt.utils.interop.near_plane_scene(SEED, M3_N, M3_FACES),
               errs)
    p2m_checks('grid mesh ties', *grid_mesh_points(), errs)
    scenes = p2m_scenes()
    scored, bounds = {}, {}
    for name, points, faces in scenes:
        ridx = ref[0] if name == 'config3' else p2m_checks(name, points,
                                                           faces, errs)[0]
        scored[name] = p2m_scored(name, points, faces)
        bounds[name] = p2m_bound(points, faces, ridx)
        log(f'[{name}] p2m_select bound {bounds[name][0]:.4f} ms by '
            f'{bounds[name][1]} ({bounds[name][2]} pairs whose plane lies '
            'within the winner\'s distance)')
    scene_times = p2m_times('config3', scenes)

    lib = cdist_argmin(p1, p2)
    e_lib = int((lib.to(torch.int32) != kn.nearest_idx(p1, p2)).sum())
    lib_ms = time_ms(lambda: cdist_argmin(p1, p2), 1, warmup=False)
    log(f'[config3] torch.cdist + argmin vs nearest_idx: {e_lib} index '
        'mismatches (cdist takes a square root and sums in its own order); '
        f'{lib_ms:.1f} ms, the library time of both NN rows')
    lib_mm = cdist_mm_argmin(p1, p2)
    e_mm = int((lib_mm.to(torch.int32) != kn.nearest_idx(p1, p2)).sum())
    lib_mm_ms = time_ms(lambda: cdist_mm_argmin(p1, p2), 3)
    log(f'[config3] torch.cdist (matrix-product form) + argmin vs '
        f'nearest_idx: {e_mm} index mismatches; {lib_mm_ms:.4f} ms')

    nbytes = 4 * (2 * 3 * M3_N + M3_N)
    shape = (f'1 x {M3_N} queries x {M3_N} references (config 3, '
             'bench_suite.py:191-194)')
    times = {}
    plain_ms = time_ms(lambda: kn.nearest_idx_plain(p1, p2), 2)
    bnd = bound(nbytes, M3_N ** 2 * OPS_NN_PAIR)
    times['nearest_idx'] = dict(
        ms=time_ms(lambda: kn.nearest_idx(p1, p2), TIME_ITERS),
        plain_ms=plain_ms, library_ms=lib_ms, library_mm_ms=lib_mm_ms,
        bound_ms=bnd[0], bound_by=bnd[1], shape=shape)
    log('[config3] time nearest_idx: ' + json.dumps(times['nearest_idx']))
    # the shapes the main paths give it: the mesh fit's F-score and the
    # DIB-R example's Chamfer
    times['nearest_idx'].update({f'fscore_{k}': v for k, v in
                                 nn_brute_times('config3 fit',
                                                FIT3_EVAL).items()})
    times['nearest_idx'].update({
        f'chamfer{DIBR_CHAMFER_N}_{k}': v for k, v in
        nn_brute_times('dibr chamfer', DIBR_CHAMFER_N).items()})
    nn_metric_times('end to end')
    nn = {}
    for name, a, b in (('config3', p1, p2), ('config3 p2->p1', p2, p1),
                       ('sphere centre', *sphere_centre()),
                       ('mesh fit', fit_pts, fit_target)):
        nn[name] = dict(nn_times(name, a, b),
                        scanned=nn_scanned(name, a, b),
                        **dict(zip(('bound_ms', 'bound_by', 'cube_pairs'),
                                   nn_bound(name, a, b))))
    nn_scanned(f'{NN_BIG} points', *nn_big_times(f'{NN_BIG} points')[1])
    times['nearest_idx_pruned'] = dict(
        nn['config3'], plain_ms=plain_ms, library_ms=lib_ms,
        library_mm_ms=lib_mm_ms, shape=shape)
    log('[config3] time nearest_idx_pruned: '
        + json.dumps(times['nearest_idx_pruned']))
    prepass_ms = time_ms(lambda: kn.prepass(p1, p2), TIME_ITERS)
    prepass_dev = device_ms('[config3] the pruned prepass alone',
                            lambda: kn.prepass(p1, p2))
    prepass_n = launches_per_call('[config3] the pruned prepass alone',
                                  lambda: kn.prepass(p1, p2))
    log(f'[config3] time of the pruned prepass alone: {prepass_ms:.4f} ms '
        f'(device {prepass_dev}), {prepass_n} launches a call, '
        f'{prepass_ms / times["nearest_idx_pruned"]["ms"]:.3f} of '
        'nearest_idx_pruned')
    bnd = bounds['config3']
    times['p2m_select'] = dict(
        scene_times['config3'],
        plain_ms=time_ms(lambda: kp.p2m_select_plain(p1, fv), 1),
        library_ms=None, bound_ms=bnd[0], bound_by=bnd[1],
        cull_skipped=1. - scored['config3'] / (M3_N * M3_FACES),
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


def deftet_bound(pc, fvi, valid, knum):
    """(bound ms, 'bytes' or 'operations', bbox pairs) of one
    ``deftet_topk`` call: 4 compares for every (pixel, face) pair and the
    scoring of each pair whose bbox holds the pixel."""
    B, P, _ = pc.shape
    F = fvi.shape[1]
    bbox = kd.face_bboxes(fvi, valid)
    pairs = 0
    for p0 in range(0, P, 512):
        px = pc[:, p0:p0 + 512, None, 0]
        py = pc[:, p0:p0 + 512, None, 1]
        pairs += int(((px >= bbox[:, None, :, 0]) & (px < bbox[:, None, :, 2])
                      & (py >= bbox[:, None, :, 1])
                      & (py < bbox[:, None, :, 3])).sum())
    # coords and ranges (4) per pixel, z and image coords (9) per face and
    # its valid byte in; knum ids per pixel out
    nbytes = 4 * B * (4 * P + 9 * F + P * knum) + B * F
    ops = B * P * F * OPS_DEFTET_BBOX + pairs * OPS_DEFTET_PAIR
    return bound(nbytes, ops) + (pairs,)


def deftet_checks(label, args, knum, errs):
    """``deftet_topk`` against its plain version: every id equal."""
    out = kd.deftet_topk(*args, knum, 1e-8)
    again = kd.deftet_topk(*args, knum, 1e-8)
    ref = kd.deftet_topk_plain(*args, knum, 1e-8)
    torch.cuda.synchronize()
    bad = int((out != ref).sum())
    same = bool(torch.equal(out, again))
    err = float((out.double() - ref.double()).abs().max())
    log(f'[config4] {label}: {args[0].shape[1]} pixels x {args[2].shape[1]} '
        f'faces, knum {knum}: {bad} id mismatches of {out.numel()}; '
        f'{int((out >= 0).sum())} ids kept, {int((out >= 0).all(-1).sum())} '
        f'pixels full; two launches bit-identical {same}')
    expect(bad == 0 and same, f'[config4] {label}: deftet_topk disagrees '
           'with its plain version or with itself')
    errs['deftet_topk'] = max(errs['deftet_topk'], err)
    return out


def full_cover(scene):
    """DefTet's adversarial scene: config 4's pixels and ranges, and
    D4_FACES faces that each cover the whole image, the depth of face f
    -1 + f / D4_FACES: every (pixel, face) pair passes every test, and
    every face enters its pixel's list at the top. Returns the selection's
    arguments (pixel coords, ranges, z, image coords, valid mask)."""
    pc, rr = scene[:2]
    tri = torch.tensor([[-3., -3.], [3., -3.], [0., 3.]], device='cuda')
    fvi = tri.expand(1, D4_FACES, 3, 2).contiguous()
    z = -1. + torch.arange(D4_FACES, device='cuda',
                           dtype=torch.float32) / D4_FACES
    fvz = z[None, :, None].expand(1, D4_FACES, 3).contiguous()
    return pc, rr, fvz, fvi, torch.ones((1, D4_FACES), dtype=torch.bool,
                                        device='cuda')


def deftet_times(label, args, knum=D4_KNUM):
    """``deftet_topk`` at ``knum`` equal to its plain version, then timed
    with CUDA events and by the card alone: dict(ms, device_ms)."""
    expect(torch.equal(kd.deftet_topk(*args, knum, 1e-8),
                       kd.deftet_topk_plain(*args, knum, 1e-8)),
           f'[{label}] deftet_topk disagrees with its plain version')

    def fn():
        return kd.deftet_topk(*args, knum, 1e-8)
    out = dict(ms=time_ms(fn, TIME_ITERS),
               device_ms=device_ms(f'[{label}] deftet_topk', fn))
    log(f'[{label}] time deftet_topk ({args[0].shape[1]} pixels x '
        f'{args[2].shape[1]} faces, knum {knum}): ' + json.dumps(out))
    return out


def deftet_scratch_mb(args, knum):
    """MB of the device-memory scratch one ``deftet_topk`` call takes."""
    nbytes = ctypes.c_longlong()
    B, P = args[0].shape[:2]
    _build.launch(kd._lib(), 'deftet_topk_scratch', B, P, args[2].shape[1],
                  knum, ctypes.addressof(nbytes))
    return nbytes.value / 1e6


def deftet_kernel_phases(scene):
    """``deftet_topk`` against its plain version on the card: config 4's
    scene at knum 30, its faces on a D4_BIG_SIDE^2 grid at knum 300,
    every face doubled (exact ties across knum), and faces at depths +0.0
    and -0.0; then the kernel and its plain version timed at config 4.
    Returns ({kernel: max abs error}, {kernel: times})."""
    pc, rr, fvz, fvi, _ = scene
    valid = torch.ones(fvz.shape[:2], dtype=torch.bool, device='cuda')
    errs = {'deftet_topk': 0.}
    deftet_checks('config 4', (pc, rr, fvz, fvi, valid), D4_KNUM, errs)
    pc2, rr2 = kt.utils.interop.deftet_scene(seed=SEED, side=D4_BIG_SIDE,
                                             num_faces=D4_FACES)[:2]
    deftet_checks('knum 300', (pc2, rr2, fvz, fvi, valid), D4_BIG_KNUM, errs)
    dup = (torch.cat([fvz, fvz.flip(1)], 1), torch.cat([fvi, fvi.flip(1)], 1))
    deftet_checks('every face twice', (pc, rr, *dup, torch.cat([valid] * 2,
                                                               1)),
                  D4_KNUM, errs)
    zr = torch.tensor([-1., 1.], device='cuda').expand_as(pc).contiguous()
    tri = torch.tensor([[-3., -3.], [3., -3.], [0., 3.]], device='cuda')
    zeros = torch.tensor([-0., 0., -0., 0., -0.5, 0.5], device='cuda')
    out = deftet_checks(
        'depths -0.0 and +0.0', (pc, zr, zeros[None, :, None].expand(
            1, 6, 3).contiguous(), tri.expand(1, 6, 3, 2).contiguous(),
            torch.ones((1, 6), dtype=torch.bool, device='cuda')), 5, errs)
    expect(bool((out == torch.tensor([5, 1, 3, 0, 2], dtype=torch.int32,
                                     device='cuda')).all()),
           '[config4] +0.0 does not rank above -0.0')
    args = (pc, rr, fvz, fvi, valid)
    for knum in (1, 64):
        deftet_checks(f'knum {knum}', args, knum, errs)
    cover = full_cover(scene)
    out = deftet_checks('full cover', cover, D4_KNUM, errs)
    expect(bool((out == torch.arange(D4_FACES - 1, D4_FACES - 1 - D4_KNUM,
                                     -1, device='cuda',
                                     dtype=torch.int32)).all()),
           '[config4] full cover: the faces of largest depth are not '
           'first')
    b_ms, b_by, pairs = deftet_bound(pc, fvi, valid, D4_KNUM)
    times = {'deftet_topk': dict(
        deftet_times('config4', args),
        plain_ms=time_ms(lambda: kd.deftet_topk_plain(*args, D4_KNUM, 1e-8),
                         2),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        shape=f'1 x {pc.shape[1]} pixels x {D4_FACES} faces, knum '
              f'{D4_KNUM} (config 4, bench_suite.py:205-229)')}
    log(f'[config4] {pairs} (pixel, face) pairs pass the bbox test, '
        f'{pairs / (pc.shape[1] * D4_FACES):.4f} of all')
    c_ms, c_by, c_pairs = deftet_bound(cover[0], cover[3], cover[4], D4_KNUM)
    log(f'[full cover] deftet_topk bound {c_ms:.4f} ms by {c_by} ({c_pairs} '
        'pairs pass the bbox test)')
    deftet_times('full cover', cover)
    for knum in (D4_KNUM, D4_BIG_KNUM):
        log(f'[config4] deftet_topk scratch at knum {knum}: '
            f'{deftet_scratch_mb(args, knum):.3f} MB')
    deftet_times('config4 knum 300', args, D4_BIG_KNUM)
    log('[config4] time deftet_topk: ' + json.dumps(times['deftet_topk']))
    return errs, times


def axis_rays(n, seed):
    """Rays along +-x, +-y, +-z (the other components 0.0 or -0.0) from
    origins on the level-8 cell planes (multiples of 2^-7) across the
    ray; and rays of general direction from origins on those planes."""
    rng = np.random.default_rng(seed)
    axis = rng.integers(0, 3, n)
    sign = rng.choice([-1., 1.], n)
    d = np.where(rng.random((n, 3)) < 0.5, 0., -0.)
    d[np.arange(n), axis] = sign
    o = np.round(rng.uniform(-1, 1, (n, 3)) * 128.) / 128.
    o[np.arange(n), axis] = -1.5 * sign
    lo = np.round(rng.uniform(-1, 1, (n, 3)) * 128.) / 128.
    ld = rng.normal(size=(n, 3))
    ld[: n // 2, 0] = 0.
    ld /= np.linalg.norm(ld, axis=-1, keepdims=True)
    return [tuple(torch.tensor(a, dtype=torch.float32, device='cuda')
                  for a in pair) for pair in ((o, d), (lo, ld))]


def traverse_checks(label, spc, o, d, with_exit, errs):
    """The traversal against its plain version: ids, depths and counts
    equal."""
    octree, ph, _, exsum = spc
    out = kst.traverse(octree, exsum, ph, o, d, C5_LEVEL, with_exit)
    ref = kst.traverse_plain(octree, exsum, ph, o, d, C5_LEVEL, with_exit)
    torch.cuda.synchronize()
    same = [bool(torch.equal(a, b)) for a, b in zip(out[:3], ref[:3])]
    err = float((out[2].double() - ref[2].double()).abs().max()) \
        if out[3] else 0.
    log(f'[config5] {label}: {o.shape[0]} rays, level {C5_LEVEL}, exit '
        f'{with_exit}: {out[3]} hits (plain {ref[3]}), per level {out[4]}; '
        f'ray ids, point ids, depths equal {same}, largest depth difference '
        f'{err}')
    expect(all(same) and out[3] == ref[3] and out[4] == ref[4],
           f'[config5] {label}: the traversal disagrees with its plain '
           'version')
    for name in ('traverse_banded_cc', 'traverse_banded'):
        errs[name] = max(errs[name], err)
    return out


@contextlib.contextmanager
def small_budget(nuggets):
    """The traversal's budget set to ``nuggets`` a level for a block."""
    saved = kst.BUDGET_PER_RAY, kst.BUDGET_MIN
    kst.BUDGET_PER_RAY, kst.BUDGET_MIN = 0, nuggets
    try:
        yield
    finally:
        kst.BUDGET_PER_RAY, kst.BUDGET_MIN = saved


def forced_overflow(spc, o, d):
    """The traversal with a budget far below config 5's levels: the card
    sizes each level exactly and traces again, counted in
    ``traverse.resized``; its outputs must equal the plain version's, and
    with a cap below the count too."""
    octree, ph, _, exsum = spc
    for cap in (None, 1000):
        before = kst.traverse.resized
        with small_budget(4096):
            out = kst.traverse(octree, exsum, ph, o, d, C5_LEVEL, True, cap)
        ref = kst.traverse_plain(octree, exsum, ph, o, d, C5_LEVEL, True,
                                 cap)
        torch.cuda.synchronize()
        same = all(bool(torch.equal(a, b)) for a, b in zip(out[:3], ref[:3]))
        log(f'[config5] forced overflow (budget 4096 nuggets a level, cap '
            f'{cap}): traced again {kst.traverse.resized - before} time(s), '
            f'{out[3]} hits, per level {out[4]}; equal to the plain version '
            f'{same and out[3:] == ref[3:]}')
        expect(kst.traverse.resized == before + 1 and same
               and out[3:] == ref[3:], '[config5] the forced overflow did '
               'not size the levels exactly, or disagrees with the plain '
               'version')


def traverse_bound(spc, o, d, with_exit, hits):
    """(bound ms, 'bytes' or 'operations') of one level-C5_LEVEL trace: per
    level, each nugget's ray and cell set-up and the slab test of each
    existing child of its node (and the exit test at the last level);
    the nuggets of each level come from traces to that level."""
    octree, ph, _, exsum = spc
    R = o.shape[0]
    children = kt.ops.spc.uint8_bits_sum
    nuggets, cands = [R], [R * int(children(octree[:1]))]
    for l in range(1, C5_LEVEL):
        pidx = kst.traverse(octree, exsum, ph, o, d, l)[1]
        nuggets.append(pidx.shape[0])
        cands.append(int(children(octree[pidx.long()]).sum()))
    ops = (sum(nuggets) * OPS_TRAV_NUGGET + sum(cands) * OPS_TRAV_CHILD
           + (cands[-1] * OPS_TRAV_EXIT if with_exit else 0))
    ncols = 2 if with_exit else 1
    # the octree, exsum and point hierarchy and the rays in; ids and depths
    # of every hit out
    nbytes = (octree.numel() + 4 * exsum.numel() + 2 * ph.numel() + 24 * R
              + hits * (8 + 4 * ncols))
    log(f'[config5] nuggets per level {nuggets}, children tested {cands}')
    return bound(nbytes, ops)


def traverse_kernel_phases(spc, rays):
    """The traversal against its plain version on the card at config 5
    (with and without exit depths), and on axis-aligned and lattice-plane
    rays; then the traversal and its plain version timed at config 5.
    Returns ({kernel: max abs error}, {kernel: times})."""
    octree, ph, _, exsum = spc
    o, d = rays
    errs = {'traverse_banded_cc': 0., 'traverse_banded': 0.}
    out = traverse_checks('config 5', spc, o, d, False, errs)
    traverse_checks('config 5', spc, o, d, True, errs)
    for label, (ao, ad) in zip(('axis-aligned', 'lattice-plane'),
                               axis_rays(o.shape[0], SEED)):
        traverse_checks(label, spc, ao, ad, False, errs)
        traverse_checks(label, spc, ao, ad, True, errs)
    forced_overflow(spc, o, d)
    b_ms, b_by = traverse_bound(spc, o, d, False, out[3])
    t = dict(ms=time_ms(lambda: kst.traverse(octree, exsum, ph, o, d,
                                             C5_LEVEL), TIME_ITERS),
             plain_ms=time_ms(lambda: kst.traverse_plain(
                 octree, exsum, ph, o, d, C5_LEVEL), 2),
             library_ms=None, bound_ms=b_ms, bound_by=b_by,
             shape=f'{o.shape[0]} rays, level {C5_LEVEL}, {ph.shape[0]} '
                   'points (config 5, bench_suite.py:232-290)')
    log('[config5] time traverse: ' + json.dumps(t))
    return errs, {'traverse_banded_cc': t, 'traverse_banded': t}


def deftet_step(scene, fvi):
    """Config 4's step (``bench_suite.py:218-224``): the loss, its
    gradient to the image coords and ``fvi - 1e-9 * g``."""
    pc, rr, fvz, _, ff = scene
    fvi = fvi.detach().requires_grad_(True)
    loss = kt.utils.interop.deftet_loss(pc, rr, fvz, fvi, ff, knum=D4_KNUM)
    g, = torch.autograd.grad(loss, [fvi])
    return fvi.detach() - D4_LR * g, loss, g


def deftet_path(scene):
    """Config 4's step, as a user writes it, TRAIN_STEPS chained steps;
    checks the launches and the values. Returns (launches, ms per
    step)."""
    reset_counters()
    fvi, losses = scene[3], []
    for _ in range(TRAIN_STEPS):
        fvi, loss, g = deftet_step(scene, fvi)
        losses.append(loss.detach())
    launches = read_counters('config 4 path')
    expect(launches['deftet_topk'] == TRAIN_STEPS
           and sum(launches.values()) == TRAIN_STEPS,
           'config 4 step: expected one deftet_topk launch per step and no '
           'other kernel')
    gmax = float(g.abs().max())
    log(f'[config4] step: loss {float(losses[0]):.6f} -> '
        f'{float(losses[-1]):.6f} over {TRAIN_STEPS} steps, largest |grad| '
        f'{gmax:.4e}, nonzero share {float((g != 0).float().mean()):.4f}')
    expect(all(bool(torch.isfinite(x)) for x in losses) and gmax > 0.
           and bool(torch.isfinite(g).all()), 'config 4 step: non-finite '
           'or zero gradient')
    state = [scene[3]]

    def step():
        state[0] = deftet_step(scene, state[0])[0]

    ms = time_ms(step, TIME_ITERS)
    log(f'[config4] step: {ms:.4f} ms per iteration ({TIME_ITERS} chained '
        'iterations after a warm-up)')
    profile_calls('[config4] profile step', step, ms)
    return launches, ms


def crosses_cell_edge(o, d, t_end):
    """For each ray (float64 origins and directions), whether on its way
    to ``t_end`` it passes, inside the octree's cube, within 1e-5 of a
    level-C5_LEVEL cell of a cell edge, where it lies on two cell planes
    at once: there the slab test's boundary touches (``|lt| <= r``) go
    either way by rounding, and a ray can miss the cells beyond the
    edge."""
    n = 2 ** C5_LEVEL
    planes = -1. + torch.arange(n + 1, dtype=torch.float64,
                                device=o.device) * (2. / n)
    out = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for a in range(3):
        t = (planes[None, :] - o[:, a:a + 1]) / d[:, a:a + 1]
        on_way = torch.isfinite(t) & (t >= 0.) & (t <= t_end[:, None])
        for c in range(3):
            on_way &= (o[:, c:c + 1] + t * d[:, c:c + 1]).abs() <= 1.
        for b in range(3):
            if b != a:
                cell = (o[:, b:b + 1] + t * d[:, b:b + 1] + 1.) * (n / 2.)
                out |= (on_way & ((cell - cell.round()).abs() < 1e-5)).any(-1)
    return out


def first_hit_check(spc, o, d, ridx, depth):
    """Config 5's end-to-end check against the analytic sphere of radius
    C5_RADIUS. A ray whose analytic entry point lies in an occupied
    level-C5_LEVEL voxel must hit, and its first hit (``mark_first_hit``)
    lies at most the voxel's reach before that point: ``t* - diag / cos <=
    t <= t*``, with diag the voxel diagonal and cos the angle to the
    normal there (an earlier voxel may hold points of the sphere out to a
    diagonal from it). Only a ray that passes through a cell edge on its
    way (``crosses_cell_edge``) may miss its entry voxel. Rays through
    empty voxels of the shell reach its far side. No ray passing farther
    than a diagonal from the sphere hits."""
    octree, _, _, exsum = spc
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        first = kt.render.spc.mark_first_hit(ridx)
    r = ridx[first].long()
    t = depth[first, 0].double()
    od, dd = o.double(), d.double()
    b = (od * dd).sum(-1)
    disc = b * b - ((od * od).sum(-1) - C5_RADIUS ** 2)
    tstar = -b - torch.sqrt(disc.clamp(min=0.))
    entry = (od + tstar[:, None] * dd).float()
    occupied = (disc >= 0) & (kt.ops.spc.unbatched_query(
        octree, exsum, entry, C5_LEVEL) >= 0)
    diag = math.sqrt(3.) * 2. / 2 ** C5_LEVEL
    cos = -((entry.double() * dd).sum(-1)) / C5_RADIUS
    first_t = torch.full_like(tstar, math.inf)
    first_t[r] = t
    gap = first_t - tstar
    early = occupied & (gap < -diag / cos.clamp(min=1e-12) - 1e-5)
    late = occupied & (gap > 1e-5)            # no hit counts as late
    edge = torch.zeros_like(late)
    edge[late] = crosses_cell_edge(od[late], dd[late], tstar[late])
    within = float((gap[occupied].abs() <= diag).float().mean())
    far = torch.isfinite(first_t) & (
        torch.sqrt((od * od).sum(-1) - b * b) > C5_RADIUS + diag)
    log(f'[config5] first hits: {r.shape[0]} rays hit, {int(occupied.sum())} '
        f'rays enter the sphere in an occupied voxel; their first hit lies '
        f'within one voxel diagonal ({diag:.5f}) of the analytic entry for '
        f'{within:.4f} of them, {int(early.sum())} before t* - diag / cos, '
        f'{int(late.sum())} after t* or never ({int(edge.sum())} of them '
        f'through a cell edge); {int((disc >= 0).sum() - occupied.sum())} '
        f'rays enter through empty voxels; {int(far.sum())} hits farther '
        'than a diagonal from the sphere')
    expect(int(early.sum()) == 0 and bool((edge == late).all())
           and int(far.sum()) == 0,
           '[config5] first hits disagree with the analytic sphere')


def raytrace_path(spc, rays):
    """Config 5's trace (``unbatched_raytrace`` from origin and direction
    arrays), as a user calls it; checks the launches, the hits and the
    first hits against the analytic sphere. Returns (launches, ms per
    trace, (ridx, pidx, depth))."""
    octree, ph, pyr, exsum = spc
    o, d = rays
    reset_counters()
    ridx, pidx, depth = kt.render.spc.unbatched_raytrace(
        octree, ph, pyr, exsum, o, d, C5_LEVEL)
    launches = read_counters('config 5 path')
    expect(launches['traverse'] == 1 and sum(launches.values()) == 1,
           'config 5 trace: expected one traversal and no other kernel')
    lo, hi = int(pyr[1, C5_LEVEL]), int(pyr[1, C5_LEVEL + 1])
    expect(bool((ridx[1:] >= ridx[:-1]).all()) and bool((pidx >= lo).all())
           and bool((pidx < hi).all()) and bool((depth > 0).all())
           and bool(torch.isfinite(depth).all()),
           'config 5 trace: hits out of order or out of range')
    first_hit_check(spc, o, d, ridx, depth)

    def trace():
        kt.render.spc.unbatched_raytrace(octree, ph, pyr, exsum, o, d,
                                         C5_LEVEL)

    ms = time_ms(trace, TIME_ITERS)
    log(f'[config5] trace: {ms:.4f} ms per trace ({o.shape[0]} rays, level '
        f'{C5_LEVEL}, {ridx.shape[0]} hits; {TIME_ITERS} traces after a '
        'warm-up)')
    syncs = host_syncs(trace)
    activities = launches_per_call('[config5] trace', trace)
    log(f'[config5] trace: {syncs} host sync(s), {activities} launches, '
        'fills and copies a trace')
    expect(syncs == 1, f'config 5 trace: {syncs} host syncs, expected 1')
    profile_calls('[config5] profile trace', trace, ms)
    return launches, ms, (ridx, pidx, depth)


def check_deftet_against_cpu():
    """Config 4's loss and its gradients to the image coords and the
    features on a small scene (24x24 pixels, 600 faces), on the card
    against the plain versions on the CPU."""
    def loss_and_grads(device):
        pc, rr, fvz, fvi, ff = kt.utils.interop.deftet_scene(
            seed=SEED, side=24, num_faces=600, device=device)
        fvi.requires_grad_(True)
        ff.requires_grad_(True)
        loss = kt.utils.interop.deftet_loss(pc, rr, fvz, fvi, ff)
        return (loss.item(),) + torch.autograd.grad(loss, [fvi, ff])

    card, cpu = loss_and_grads('cuda'), loss_and_grads('cpu')
    rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    log(f'card vs CPU plain, config 4 loss: {card[0]:.8f} vs {cpu[0]:.8f}, '
        f'relative difference {rel:.3e} (tolerance 1e-5)')
    expect(rel <= 1e-5, 'the config 4 loss on the card disagrees with the '
           'CPU')
    for name, g, ref in zip(('image coords', 'features'), card[1:], cpu[1:]):
        grad_close(f'card vs CPU plain, config 4 gradient to the {name}',
                   g.cpu(), ref)


def check_tets_against_cpu():
    """``equivolume`` and ``amips`` of a perturbed tet grid (with their
    gradients) and ``marching_tetrahedra`` of a sphere's SDF on
    ``tet_grid(16)``, on the card against the CPU."""
    verts, tets = kt.ops.conversions.tet_grid(16)
    rng = np.random.default_rng(SEED)
    moved = verts + rng.uniform(-0.02, 0.02, verts.shape).astype(np.float32)
    for name, fn in (
            ('equivolume', lambda tv, rest: kt.metrics.tetmesh.equivolume(
                tv)),
            ('amips', lambda tv, rest: kt.metrics.tetmesh.amips(
                tv, kt.ops.mesh.inverse_vertices_offset(rest)))):
        def value_and_grad(device):
            v = torch.tensor(moved, device=device, requires_grad=True)
            t = torch.tensor(tets, device=device)
            val = fn(v[t][None], torch.tensor(verts, device=device)[t][None])
            return val.item(), torch.autograd.grad(val.sum(), [v])[0]

        card, cpu = value_and_grad('cuda'), value_and_grad('cpu')
        rel = abs(card[0] - cpu[0]) / abs(cpu[0])
        log(f'card vs CPU, {name} of a perturbed tet grid ({tets.shape[0]} '
            f'tets): {card[0]:.8e} vs {cpu[0]:.8e}, relative difference '
            f'{rel:.3e} (tolerance 1e-5)')
        expect(rel <= 1e-5, f'{name} on the card disagrees with the CPU')
        grad_close(f'card vs CPU, {name} gradient', card[1].cpu(), cpu[1])
    sdf = np.linalg.norm(verts - [0.02, -0.01, 0.03], axis=-1) - 0.3
    v, f, ti, vc, fc, tic = (x[0] for dev in ('cuda', 'cpu')
                             for x in kt.ops.conversions.marching_tetrahedra(
                                 torch.tensor(verts, device=dev)[None],
                                 torch.tensor(tets), torch.tensor(
                                     sdf, dtype=torch.float32,
                                     device=dev)[None], return_tet_idx=True))
    err = float((v.cpu() - vc).abs().max())
    radius = (v.cpu() - torch.tensor([0.02, -0.01, 0.03])).norm(dim=-1)
    log(f'card vs CPU, marching_tetrahedra of a sphere SDF on tet_grid(16): '
        f'{v.shape[0]} vertices, {f.shape[0]} faces; faces equal '
        f'{bool(torch.equal(f.cpu(), fc))}, tet_idx equal '
        f'{bool(torch.equal(ti.cpu(), tic))}, largest vertex difference '
        f'{err:.3e}; vertex radius {float(radius.min()):.4f} .. '
        f'{float(radius.max()):.4f} (sphere 0.3)')
    expect(torch.equal(f.cpu(), fc) and torch.equal(ti.cpu(), tic)
           and err <= 1e-6 and float((radius - 0.3).abs().max()) < 1 / 16.,
           'marching_tetrahedra on the card disagrees with the CPU')


def check_pack_ops_against_cpu(hits):
    """The pack ops over config 5's hits (packs of one ray's hits, depth
    as the feature, the depths' spread as the density), on the card
    against the CPU; and the card's primary rays against the CPU's."""
    ridx, _, depth = hits

    def pack_ops(device):
        r, x = ridx.to(device), depth.to(device)
        b = kt.render.spc.mark_pack_boundaries(r)
        tau = (x - x.mean()).abs()
        feats, trans = kt.render.spc.exponential_integration(x, tau, b)
        return (b, kt.render.spc.diff(x, b), kt.render.spc.sum_reduce(x, b),
                kt.render.spc.cumsum(x, b, exclusive=True),
                kt.render.spc.cumprod(x, b, reverse=True), feats, trans)

    card, cpu = pack_ops('cuda'), pack_ops('cpu')
    same_b = bool(torch.equal(card[0].cpu(), cpu[0]))
    # largest difference over the largest |value|: exp rounds otherwise on
    # the card, and 1 - exp(-tau) of a small tau cancels
    errs = [float((a.cpu().double() - c.double()).abs().max()
                  / c.double().abs().max().clamp(min=1e-300))
            for a, c in zip(card[1:], cpu[1:])]
    log(f'card vs CPU, pack ops over {ridx.shape[0]} hits in '
        f'{int(cpu[0].sum())} packs: boundaries equal {same_b}; largest '
        'differences over the largest |value| (diff, sum_reduce, cumsum, '
        'cumprod, exponential_integration\'s two outputs): '
        f'{errs} (tolerance 1e-5)')
    expect(same_b and max(errs) <= 1e-5, 'the pack ops on the card disagree '
           'with the CPU')
    card = kt.render.spc.generate_primary_rays(C5_RES, C5_RES, *C5_CAM)
    cpu = kt.render.spc.generate_primary_rays(C5_RES, C5_RES, *C5_CAM,
                                              device='cpu')
    diffs = int((card[1].cpu() != cpu[1]).sum())
    log(f'card vs CPU, config 5 primary rays: {diffs} of '
        f'{cpu[1].numel()} direction components differ, largest '
        f'{float((card[1].cpu() - cpu[1]).abs().max()):.3e}')
    expect(float((card[1].cpu() - cpu[1]).abs().max()) < 1e-6,
           'the primary rays on the card disagree with the CPU')


# ---------------------------------------------------------------------------
# The modules with no TPU kernel (render/lighting/sg.py, ops/spc/convolution,
# the native host library, the voxel grids, the GCN, subdivision and the
# conversions): each phase runs the port's functions on the card at full
# width, checks the card against the CPU, and times them (module_times).
# ---------------------------------------------------------------------------

# bench_sg.py's size: SG_QUERIES queries x SG_LIGHTS lights in chunks of
# SG_CHUNK; the first SG_CHECK queries are held against the CPU at float64
SG_QUERIES, SG_LIGHTS, SG_CHUNK, SG_CHECK = 100_000, 512, 512, 2000
# float operations per (query, light) pair of the SG inner product: the
# lobe sum (3 adds), its norm (3 mul, 2 add, sqrt), the sharpness sum and
# the exponent (2), exp, the amplitudes (3 mul), expo (3 mul), -2 dm, exp,
# 1 - exp, the 2 pi, other and 1 / dm products (3 x 3), the sum over the
# lights (3); the backward is counted as twice the forward's
OPS_SG_PAIR = 3 + 6 + 2 + 1 + 3 + 3 + 3 + 9 + 3
# card vs CPU: the SG values within SG_TOL of the largest |value|, the
# gradients within SG_GRAD_TOL of their largest |entry| (float32 on the
# card against float64 on the CPU; the gradients to the lights sum
# SG_CHECK queries' terms)
SG_TOL, SG_GRAD_TOL = 1e-5, 1e-4
# config 2's mesh (icosphere subdivision 5, batch 8) scaled by MESH_SCALE
# into [-1, 1]: mesh_to_spc at SPC_LEVEL, the convolutions' CONV_CH
# channels on its first octree, voxel grids at VOX_RES
MESH_BATCH, MESH_SUBDIV, MESH_SCALE = 8, 5, 0.9
SPC_LEVEL, CONV_CH, VOX_RES = 8, 32, 128
# the convolutions and the GCN, card vs CPU (float32 both, other orders of
# the matrix products' sums): values within MOD_TOL of the largest
# |value|, gradients within MOD_GRAD_TOL of their largest |entry|
MOD_TOL, MOD_GRAD_TOL = 1e-5, 1e-4
# Pixel2Mesh's hidden width over config 2's 10,242 vertices
GCN_CH = 192
# config 3's cloud (bench_suite.py:191) and config 5's points
C3_N = 100_000
MOD_ITERS = 5


def _rel_err(out, ref):
    ref = ref.detach().double()
    return float((out.detach().double().cpu() - ref.cpu()).abs().max()
                 / ref.abs().max().clamp(min=1e-300).cpu())


def module_times(label, fn, iters=MOD_ITERS, bound_ms=None, bound_by=None):
    """A module's call on the card: ms by CUDA events, the card's own time,
    CUDA activities and host syncs a call, the peak memory it adds (MB),
    and its bound where one is given."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    out = dict(ms=time_ms(fn, iters, warmup=False),
               device_ms=device_ms(f'[modules] {label}', fn, iters),
               launches_per_call=launches_per_call(f'[modules] {label}', fn,
                                                   2),
               host_syncs=host_syncs(fn), peak_mb=round(peak, 3),
               bound_ms=bound_ms, bound_by=bound_by)
    log(f'[modules] time {label}: ' + json.dumps(out))
    return out


def host_ms(fn, reps=3):
    """The best of ``reps`` host-clock times of ``fn`` (host work)."""
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def no_kernel_path(label, fn):
    """Runs ``fn`` with the launch counters at 0 and checks that it
    launched none of the ported kernels (these modules have none);
    returns what ``fn`` returns."""
    reset_counters()
    out = fn()
    launches = read_counters(f'{label} path')
    expect(sum(launches.values()) == 0,
           f'{label}: launched a kernel of the TPU table')
    return out


def sg_inputs(device):
    """bench_sg.py's inputs, drawn in its order from default_rng(0), as
    float32 on ``device``: (amplitude, direction, sharpness) of the
    queries, then of the lights."""
    rng = np.random.default_rng(SEED)

    def unit(n):
        v = rng.normal(size=(n, 3))
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    arrays = (rng.uniform(0.5, 1.5, (SG_QUERIES, 3)), unit(SG_QUERIES),
              rng.uniform(1., 8., (SG_QUERIES,)),
              rng.uniform(0.5, 1.5, (SG_LIGHTS, 3)), unit(SG_LIGHTS),
              rng.uniform(1., 8., (SG_LIGHTS,)))
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in arrays]


def sg_phase():
    """``unbatched_reduced_sg_inner_product`` at bench_sg.py's size: the
    sum's forward and its gradient to all six inputs, timed; the first
    SG_CHECK queries' values and gradients against the CPU at float64."""
    fn = kt.render.lighting.unbatched_reduced_sg_inner_product
    inputs = sg_inputs('cuda')
    leaves = [t.clone().requires_grad_() for t in inputs]

    def fwd():
        return fn(*inputs, chunk=SG_CHUNK).sum()

    def fwdbwd():
        return torch.autograd.grad(fn(*leaves, chunk=SG_CHUNK).sum(), leaves)

    def check():
        out = fn(*inputs, chunk=SG_CHUNK)
        grads = fwdbwd()
        expect(out.shape == (SG_QUERIES, 3) and bool(torch.isfinite(out).all())
               and all(bool(torch.isfinite(g).all()) for g in grads),
               'SG: values or gradients not finite')

        def sub(device, dtype):
            xs = [(t[:SG_CHECK] if i < 3 else t).to(device, dtype)
                  .requires_grad_() for i, t in enumerate(inputs)]
            y = fn(*xs, chunk=SG_CHUNK)
            return (y,) + torch.autograd.grad(y.sum(), xs)

        card, cpu = sub('cuda', torch.float32), sub('cpu', torch.float64)
        errs = [_rel_err(out[:SG_CHECK], cpu[0])] + [
            _rel_err(a, b) for a, b in zip(card, cpu)]
        log(f'[sg] card vs CPU (float64), first {SG_CHECK} queries x '
            f'{SG_LIGHTS} lights: value error {errs[0]:.3e} in the full '
            f'call, {errs[1]:.3e} in a call on those queries (tolerance '
            f'{SG_TOL}), gradient errors {[f"{e:.3e}" for e in errs[2:]]} '
            f'(tolerance {SG_GRAD_TOL}), of the largest |entry|')
        expect(max(errs[:2]) <= SG_TOL and max(errs[2:]) <= SG_GRAD_TOL,
               'SG: the card disagrees with the CPU')

    no_kernel_path('[sg]', check)
    ops = SG_QUERIES * SG_LIGHTS * OPS_SG_PAIR
    times = {'fwd': module_times('sg fwd', fwd, bound_ms=ops / PEAK_F32 * 1e3,
                                 bound_by='operations'),
             'fwdbwd': module_times('sg fwdbwd', fwdbwd,
                                    bound_ms=3 * ops / PEAK_F32 * 1e3,
                                    bound_by='operations')}
    for t in times.values():
        t['pairs_per_s'] = SG_QUERIES * SG_LIGHTS / (t['ms'] * 1e-3)
    return times


def config2_mesh(device):
    """Config 2's mesh: the unit icosphere of subdivision MESH_SUBDIV
    (20,480 faces) tiled MESH_BATCH times, as bench_suite.py tiles it,
    scaled by MESH_SCALE."""
    v, f = kt.utils.interop.icosphere(MESH_SUBDIV)
    verts = np.tile(v[None] * MESH_SCALE, (MESH_BATCH, 1, 1))
    return (torch.tensor(verts, dtype=torch.float32, device=device),
            torch.tensor(f, dtype=torch.int64, device=device))


def _kernel_vectors(lo, hi):
    r = np.arange(lo, hi + 1)
    return np.stack(np.meshgrid(r, r, r, indexing='ij'),
                    -1).reshape(-1, 3).astype(np.int16)


def _conv_layers(device):
    gen = torch.Generator().manual_seed(SEED)
    k27, k8 = _kernel_vectors(-1, 1), _kernel_vectors(0, 1)
    return (kt.ops.spc.Conv3d(CONV_CH, CONV_CH, k27, 0, generator=gen,
                              device=device),
            kt.ops.spc.Conv3d(CONV_CH, CONV_CH, k8, 1, generator=gen,
                              device=device),
            kt.ops.spc.ConvTranspose3d(CONV_CH, CONV_CH, k8, 1, generator=gen,
                                       device=device))


def conv_calls(spc, layers, x8, x7):
    """The three convolutions' forward and backward on one octree: (name,
    fn) pairs; fn returns (output, gradients to the features, the weight
    and the bias)."""
    octree, ph, pyr, exsum = spc
    calls = []
    for name, layer, level, x in (('conv3d 27, jump 0', layers[0],
                                   SPC_LEVEL, x8),
                                  ('conv3d 8, jump 1', layers[1], SPC_LEVEL,
                                   x8),
                                  ('conv_transpose3d 8, jump 1', layers[2],
                                   SPC_LEVEL - 1, x7)):
        def run(layer=layer, level=level, x=x):
            leaf = x.detach().requires_grad_()
            y, _ = layer(octree, ph, level, pyr, exsum, leaf)
            return (y,) + torch.autograd.grad(
                (y * y).sum() * 0.5, [leaf, layer.weight, layer.bias])
        calls.append((name, run))
    return calls


def spc_of(octree, lengths):
    _, pyr, exsum = kt.ops.spc.scan_octrees(octree, lengths)
    return (octree, kt.ops.spc.generate_points(octree, pyr, exsum), pyr,
            exsum)


def spc_conv_trace_phase(rays):
    """Config 2's mesh -> ``mesh_to_spc`` at SPC_LEVEL (the host library)
    -> on the first octree the three convolutions, forward and backward
    -> ``unbatched_raytrace`` of that octree with config 5's rays. The
    traversal is the one kernel of the TPU table on this path."""
    verts, faces = config2_mesh('cuda')
    reset_counters()
    spc = kt.ops.conversions.mesh_to_spc(verts, faces, SPC_LEVEL)
    octree = spc.octrees[:int(spc.lengths[0])]
    one = spc_of(octree, spc.lengths[:1])
    _, ph, pyr, exsum = one
    n8, n7 = int(pyr[0, 0, SPC_LEVEL]), int(pyr[0, 0, SPC_LEVEL - 1])
    rng = np.random.default_rng(SEED)
    x8 = torch.tensor(rng.normal(size=(n8, CONV_CH)), dtype=torch.float32,
                      device='cuda')
    x7 = torch.tensor(rng.normal(size=(n7, CONV_CH)), dtype=torch.float32,
                      device='cuda')
    layers = _conv_layers('cuda')
    calls = conv_calls(one, layers, x8, x7)
    outs = [fn() for _, fn in calls]
    o, d = rays
    ridx, pidx, depth = kt.render.spc.unbatched_raytrace(
        octree, ph, pyr[0], exsum, o, d, SPC_LEVEL)
    launches = read_counters('mesh -> spc -> conv -> trace path')
    expect(launches['traverse'] == 1 and sum(launches.values()) == 1,
           'mesh -> spc -> trace: expected one traversal and no other kernel')

    # the octrees: one per (equal) mesh, each equal to the CPU's
    cpu_octree = kt.ops.conversions.unbatched_mesh_to_spc(
        verts[0].cpu(), faces.cpu(), SPC_LEVEL)
    lengths = [int(n) for n in spc.lengths]
    expect(spc.octrees.device.type == 'cuda' and len(set(lengths)) == 1
           and torch.equal(spc.octrees.cpu(), cpu_octree.repeat(MESH_BATCH)),
           'mesh_to_spc: the octrees differ from the CPU\'s')
    log(f'[spc] mesh_to_spc at level {SPC_LEVEL}: {MESH_BATCH} octrees of '
        f'{lengths[0]} bytes, levels {pyr[0, 0, :SPC_LEVEL + 1].tolist()}, '
        'equal to the CPU\'s')
    # the convolutions against the CPU (float32), every output and gradient
    cpu_spc = spc_of(cpu_octree, spc.lengths[:1])
    cpu_layers = _conv_layers('cpu')
    for cl, layer in zip(cpu_layers, layers):
        cl.load_state_dict({k: v.cpu() for k, v in layer.state_dict().items()})
    cpu_outs = [fn() for _, fn in conv_calls(cpu_spc, cpu_layers, x8.cpu(),
                                             x7.cpu())]
    for (name, _), card, cpu in zip(calls, outs, cpu_outs):
        errs = [_rel_err(a, b) for a, b in zip(card, cpu)]
        log(f'[spc] card vs CPU, {name} ({card[0].shape[0]} outputs, '
            f'{CONV_CH} -> {CONV_CH}): output error {errs[0]:.3e} (tolerance '
            f'{MOD_TOL}), gradient errors {[f"{e:.3e}" for e in errs[1:]]} '
            f'(tolerance {MOD_GRAD_TOL}), of the largest |entry|')
        expect(errs[0] <= MOD_TOL and max(errs[1:]) <= MOD_GRAD_TOL,
               f'{name}: the card disagrees with the CPU')
    # the trace: against the CPU's on the same rays, and the sphere
    c_ridx, c_pidx, c_depth = kt.render.spc.unbatched_raytrace(
        cpu_spc[0], cpu_spc[1], cpu_spc[2][0], cpu_spc[3], o.cpu(), d.cpu(),
        SPC_LEVEL)
    same = (ridx.shape == c_ridx.shape and torch.equal(ridx.cpu(), c_ridx)
            and torch.equal(pidx.cpu(), c_pidx))
    depth_err = float((depth.cpu() - c_depth).abs().max()) if same else None
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        first = kt.render.spc.mark_first_hit(ridx)
    r = ridx[first].long()
    p = o.double()[r] + depth[first, 0].double()[:, None] * d.double()[r]
    diag = math.sqrt(3.) * 2. / 2 ** SPC_LEVEL
    off = (p.norm(dim=-1) - MESH_SCALE).abs() / diag
    within = float((off <= 1.).float().mean())
    log(f'[spc] trace of the mesh\'s octree, {o.shape[0]} rays: '
        f'{ridx.shape[0]} hits, {r.shape[0]} rays hit; card equal to the '
        f'CPU {same} (largest depth difference {depth_err}); first hits: '
        f'{within:.4f} within one voxel diagonal ({diag:.5f}) of the sphere '
        f'of radius {MESH_SCALE}, the farthest {float(off.max()):.3f} '
        'diagonals')
    expect(same and depth_err <= 1e-5 and r.shape[0] > 0
           and float(off.max()) <= 2. and within >= 0.9,
           'mesh -> spc trace: hits disagree with the CPU or the sphere')

    times = {'mesh_to_spc': dict(
        host_ms=host_ms(lambda: kt.ops.conversions.mesh_to_spc(
            verts, faces, SPC_LEVEL)), octree_bytes=lengths[0])}
    for name, fn in calls:
        times[name] = module_times(f'{name}, fwd+bwd', fn)

    def trace():
        kt.render.spc.unbatched_raytrace(octree, ph, pyr[0], exsum, o, d,
                                         SPC_LEVEL)

    times['trace'] = module_times('trace of the mesh\'s octree', trace)
    expect(times['trace']['host_syncs'] == 1,
           'mesh -> spc trace: expected one host sync a trace')
    return times, launches


def _bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def voxel_phase():
    """Config 2's mesh at batch 8 -> ``trianglemeshes_to_voxelgrids`` at
    VOX_RES -> ``fill`` -> ``extract_surface`` (both modes) ->
    ``downsample`` by 2 -> ``extract_odms`` -> ``project_odms`` -> ``iou``
    against the filled grid; marching cubes of the filled grids;
    ``subdivide_trianglemesh`` once; config 3's cloud through
    ``pointclouds_to_voxelgrids`` and ``unbatched_pointcloud_to_spc``.
    Each on the card, batch entry 0 against the CPU."""
    verts, faces = config2_mesh('cuda')
    cv = kt.ops.conversions
    vx = kt.ops.voxelgrid
    rng = np.random.default_rng(SEED)
    cloud = rng.random((1, C3_N, 3)).astype(np.float32)
    feats = rng.normal(size=(C3_N, 3)).astype(np.float32)

    def pipeline(v, f, pc, ft):
        vg = cv.trianglemeshes_to_voxelgrids(v, f, VOX_RES)
        filled = vx.fill(vg)
        odms = vx.extract_odms(filled)
        proj = vx.project_odms(odms)
        mc_v, mc_f = cv.voxelgrids_to_trianglemeshes(filled[:1])
        sub_v, sub_f = kt.ops.mesh.subdivide_trianglemesh(v, f, 1)
        pspc = cv.unbatched_pointcloud_to_spc(pc[0] * 2. - 1., SPC_LEVEL, ft)
        return dict(vg=vg, filled=filled,
                    wide=vx.extract_surface(filled, 'wide'),
                    thin=vx.extract_surface(filled, 'thin'),
                    down=vx.downsample(filled, 2), odms=odms, proj=proj,
                    iou=kt.metrics.voxelgrid.iou(proj, filled),
                    mc_v=mc_v[0], mc_f=mc_f[0], sub_v=sub_v, sub_f=sub_f,
                    pvg=cv.pointclouds_to_voxelgrids(pc, VOX_RES),
                    spc_octree=pspc.octrees, spc_feats=pspc.features)

    card = no_kernel_path('[voxel]', lambda: pipeline(
        verts, faces, torch.tensor(cloud, device='cuda'),
        torch.tensor(feats, device='cuda')))
    cpu = pipeline(verts[:1].cpu(), faces.cpu(), torch.tensor(cloud),
                   torch.tensor(feats))
    for key in ('vg', 'filled', 'wide', 'thin', 'down', 'odms', 'proj',
                'iou'):
        a = card[key]
        expect(all(torch.equal(a[b], a[0]) for b in range(1, a.shape[0])),
               f'{key}: the batch\'s equal meshes differ')
    exact = {k: bool(torch.equal(card[k][:1].cpu(), cpu[k])) for k in (
        'vg', 'filled', 'wide', 'thin', 'down', 'odms', 'proj', 'iou',
        'pvg')}
    exact.update({k: bool(torch.equal(card[k].cpu(), cpu[k])) for k in (
        'mc_v', 'mc_f', 'sub_f', 'spc_octree')})
    sub_err = _rel_err(card['sub_v'][:1], cpu['sub_v'])
    feat_err = float((card['spc_feats'].cpu().double()
                      - cpu['spc_feats'].double()).abs().max())
    log(f'[voxel] card vs CPU, exact: {json.dumps(exact)}; subdivision '
        f'vertices {sub_err:.3e} of the largest (tolerance {MOD_TOL}), '
        f'SPC features {feat_err:.3e} (tolerance 1e-6)')
    expect(all(exact.values()) and sub_err <= MOD_TOL and feat_err <= 1e-6,
           'voxel grids: the card disagrees with the CPU')
    filled = card['filled']
    occupied = float(filled.float().mean())
    log(f'[voxel] {MESH_BATCH} grids of {VOX_RES}^3: surface '
        f'{int(card["vg"][0].sum())} voxels, filled {occupied:.4f} of the '
        f'grid (a ball fills 0.5236), wide / thin shells '
        f'{int(card["wide"][0].sum())} / {int(card["thin"][0].sum())}, iou '
        f'of the carved hull {float(card["iou"][0]):.4f}; marching cubes '
        f'{card["mc_v"].shape[0]} vertices, {card["mc_f"].shape[0]} faces; '
        f'subdivision {card["sub_f"].shape[0]} faces; the cloud: '
        f'{int(card["pvg"].sum())} voxels, an octree of '
        f'{card["spc_octree"].shape[0]} bytes')
    expect(0.45 < occupied < 0.56
           and card['sub_f'].shape[0] == 4 * faces.shape[0]
           and bool((card['iou'] > 0.5).all()), 'voxel grids: implausible '
           'fill, subdivision or hull')

    def bound(nbytes):
        return nbytes / PEAK_BYTES * 1e3

    vg, odms = card['vg'], card['odms']
    cl = torch.tensor(cloud, device='cuda')
    ft = torch.tensor(feats, device='cuda')
    passes = (
        ('trianglemeshes_to_voxelgrids', lambda: cv.trianglemeshes_to_voxelgrids(
            verts, faces, VOX_RES), _bytes(verts, faces, vg)),
        ('fill', lambda: vx.fill(vg), _bytes(vg, filled)),
        ('extract_surface wide', lambda: vx.extract_surface(filled, 'wide'),
         2 * _bytes(filled)),
        ('extract_surface thin', lambda: vx.extract_surface(filled, 'thin'),
         2 * _bytes(filled)),
        ('downsample 2', lambda: vx.downsample(filled, 2),
         _bytes(filled, card['down'])),
        ('extract_odms', lambda: vx.extract_odms(filled),
         _bytes(filled, odms)),
        ('project_odms', lambda: vx.project_odms(odms),
         _bytes(odms, card['proj'])),
        ('iou', lambda: kt.metrics.voxelgrid.iou(card['proj'], filled),
         2 * _bytes(filled)),
        ('voxelgrids_to_trianglemeshes mc', lambda: cv.
         voxelgrids_to_trianglemeshes(filled[:1]),
         _bytes(filled[:1], card['mc_v'], card['mc_f'])),
        ('subdivide_trianglemesh', lambda: kt.ops.mesh.subdivide_trianglemesh(
            verts, faces, 1), _bytes(verts, faces, card['sub_v'],
                                     card['sub_f'])),
        ('pointclouds_to_voxelgrids', lambda: cv.pointclouds_to_voxelgrids(
            cl, VOX_RES), _bytes(cl, card['pvg'])),
        ('unbatched_pointcloud_to_spc', lambda: cv.unbatched_pointcloud_to_spc(
            cl[0] * 2. - 1., SPC_LEVEL, ft), None))
    times = {}
    for name, fn, nbytes in passes:
        times[name] = module_times(
            name, fn, bound_ms=None if nbytes is None else bound(nbytes),
            bound_by=None if nbytes is None else 'bytes')
    return times


def gcn_phase():
    """``GraphConv`` (GCN_CH -> GCN_CH) over config 2's icosphere (the
    port's ``adjacency_matrix``), batch MESH_BATCH, forward and backward,
    with the sparse and the dense adjacency; both against the CPU's
    sparse route."""
    _, faces = config2_mesh('cuda')
    nv = int(faces.max()) + 1
    idx, val = kt.ops.mesh.adjacency_matrix(nv, faces, sparse=True)
    adjs = {'sparse': torch.sparse_coo_tensor(idx, val, (nv, nv)),
            'dense': kt.ops.mesh.adjacency_matrix(nv, faces)}
    layer = kt.ops.gcn.GraphConv(GCN_CH, GCN_CH, generator=torch.Generator()
                                 .manual_seed(SEED), device='cuda')
    x = torch.tensor(np.random.default_rng(SEED).normal(
        size=(MESH_BATCH, nv, GCN_CH)), dtype=torch.float32, device='cuda')

    def call(layer, adj, x):
        leaf = x.detach().requires_grad_()
        y = layer(leaf, adj)
        return (y,) + torch.autograd.grad((y * y).sum() * 0.5,
                                          [leaf, *layer.parameters()])

    cpu_layer = kt.ops.gcn.GraphConv(GCN_CH, GCN_CH, device='cpu')
    cpu_layer.load_state_dict({k: v.cpu() for k, v in
                               layer.state_dict().items()})
    cpu = call(cpu_layer, adjs['sparse'].cpu(), x.cpu())
    times = {}
    for name, adj in adjs.items():
        card = no_kernel_path(f'[gcn] {name}', lambda: call(layer, adj, x))
        errs = [_rel_err(a, b) for a, b in zip(card, cpu)]
        log(f'[gcn] card ({name}) vs CPU (sparse), {nv} vertices, batch '
            f'{MESH_BATCH}, {GCN_CH} -> {GCN_CH}: output error '
            f'{errs[0]:.3e} (tolerance {MOD_TOL}), gradient errors '
            f'{[f"{e:.3e}" for e in errs[1:]]} (tolerance {MOD_GRAD_TOL})')
        expect(errs[0] <= MOD_TOL and max(errs[1:]) <= MOD_GRAD_TOL,
               f'GraphConv ({name}): the card disagrees with the CPU')
        times[name] = module_times(f'GraphConv {name}, fwd+bwd',
                                   lambda: call(layer, adj, x))
    return times


def small_ops_phase():
    """``coords`` and ``random`` on the card against the CPU (and
    ``random_spc_octrees`` at batch 4, level 8: valid, deterministic
    octrees), and the host library's Morton and octree entry points
    against their numpy versions at config 5's points."""
    from kaolin_tpu_torch import native
    from kaolin_tpu_torch.ops.spc.points import _morton_np, _octree_bytes
    rng = np.random.default_rng(SEED)
    ang = rng.uniform(-3., 3., (2, C5_N)).astype(np.float32)
    dist = rng.uniform(0.5, 3., C5_N).astype(np.float32)

    def coords(device):
        az, el, d = (torch.tensor(a, device=device) for a in (*ang, dist))
        xyz = kt.ops.spherical2cartesian(az, el, d)
        return xyz + kt.ops.cartesian2spherical(*xyz)

    card = list(no_kernel_path('[ops] coords', lambda: coords('cuda')))
    cpu = list(coords('cpu'))
    # the elevation as its sine: arcsin turns an ulp of its argument near
    # +-1 into up to 5e-4 radians
    card[4], cpu[4] = torch.sin(card[4]), torch.sin(cpu[4])
    errs = [_rel_err(a, b) for a, b in zip(card, cpu)]
    log(f'[ops] card vs CPU, coords of {C5_N} points (x, y, z, azimuth, '
        f'sin elevation, distance): errors {[f"{e:.3e}" for e in errs]} of '
        'the largest (tolerance 1e-6)')
    expect(max(errs) <= 1e-6, 'coords: the card disagrees with the CPU')

    def octrees():
        return kt.ops.random.random_spc_octrees(
            4, SPC_LEVEL, key=torch.Generator().manual_seed(SEED))

    (oct_a, len_a), (oct_b, _) = no_kernel_path('[ops] random', octrees), \
        octrees()
    max_level, pyr, exsum = kt.ops.spc.scan_octrees(oct_a, len_a)
    ph = kt.ops.spc.generate_points(oct_a, pyr, exsum)
    expect(oct_a.device.type == 'cuda' and torch.equal(oct_a, oct_b)
           and max_level == SPC_LEVEL and bool((oct_a > 0).all())
           and pyr[:, 1, SPC_LEVEL].tolist() == len_a.tolist()
           and ph.shape[0] == int(pyr[:, 1, -1].sum()),
           'random_spc_octrees: invalid or not deterministic')
    kt.ops.random.manual_seed(SEED)
    r1 = kt.ops.random.random_tensor(-1., 1., (C5_N,))
    kt.ops.random.manual_seed(SEED)
    r2 = kt.ops.random.random_tensor(-1., 1., (C5_N,))
    expect(r1.device.type == 'cuda' and torch.equal(r1, r2)
           and float(r1.abs().max()) <= 1., 'random_tensor: not seeded')
    log(f'[ops] random_spc_octrees, batch 4, level {SPC_LEVEL}: '
        f'{len_a.tolist()} bytes, valid and deterministic')

    spc5 = np.random.default_rng(SEED).normal(size=(C5_N, 3))
    spc5 = spc5 / np.linalg.norm(spc5, axis=-1, keepdims=True) * C5_RADIUS
    q = kt.ops.spc.quantize_points(torch.tensor(spc5, dtype=torch.float32),
                                   C5_LEVEL).numpy()
    morton = native.points_to_morton_fast(q)
    octree = native.points_to_octree_fast(q, C5_LEVEL)
    same = (np.array_equal(morton, _morton_np(q))
            and np.array_equal(native.morton_to_points_fast(morton), q)
            and np.array_equal(octree, _octree_bytes(np.unique(morton),
                                                     C5_LEVEL)))
    times = {name: host_ms(fn) for name, fn in (
        ('points_to_morton_fast', lambda: native.points_to_morton_fast(q)),
        ('_morton_np', lambda: _morton_np(q)),
        ('points_to_octree_fast', lambda: native.points_to_octree_fast(
            q, C5_LEVEL)),
        ('_octree_bytes', lambda: _octree_bytes(np.unique(_morton_np(q)),
                                                C5_LEVEL)))}
    log(f'[ops] host library at config 5\'s {C5_N} points: equal to numpy '
        f'{same}; host ms ' + json.dumps(times))
    expect(same, 'the host library disagrees with its numpy versions')
    times['coords'] = module_times('coords', lambda: coords('cuda'))
    return times


def module_phases(rays):
    """Every phase of the modules with no TPU kernel; returns their times
    and the launches of the mesh -> spc -> trace path."""
    t0 = time.perf_counter()
    times = {'sg': sg_phase()}
    times['spc'], launches = spc_conv_trace_phase(rays)
    times['voxel'] = voxel_phase()
    times['gcn'] = gcn_phase()
    times['ops'] = small_ops_phase()
    log(f'[modules] all phases {time.perf_counter() - t0:.1f} s')
    log('[modules] times: ' + json.dumps(times))
    return times, launches


COMPARE_GROUPS = ('render', 'texture', 'metrics', 'deftet', 'spc')


def compare(label, groups=COMPARE_GROUPS):
    """``--compare LABEL [GROUP ...]``: the timings that set two checkouts
    side by side, through the phase functions above, which call only what
    every revision of the port since config 4 has. Groups (all by
    default): ``render``: ``resource_usage`` of the render sources, the
    design counts, ``forward_times``, ``backward_times`` and
    ``train_step_times`` on the bench and config 2 sizes (the kernels also
    on the large-faces scene); ``texture``: ``resource_usage`` of
    ``grid_sample.cu``, ``grid_sample_counts`` at the step's cotangent, a
    random one and random coordinates over the 256x256 and 64x64
    textures, ``sampler_times``, ``grid_sample_backward`` at the step's
    and the random cotangent, the textured step (with its device time
    and the backward's kernels in it); ``metrics``: ``resource_usage`` of
    ``nn_distance.cu``, ``nn_brute_times`` at FIT3_EVAL, DIBR_CHAMFER_N
    and M3_N points, ``nn_metric_times``, ``p2m_times`` on
    ``p2m_scenes``, ``nn_times`` (with ``host_wall_ms``) and
    ``prepass_times`` on config 3, ``nn_times`` on the sphere-centre
    scene, ``nn_big_times``, the config 3 step (``metrics_path``, with
    ``host_wall_ms`` of one step); ``deftet``: ``deftet_times`` on config
    4 at knum 30 and 300 and on the full-cover scene, the config 4 step
    (``deftet_path``); ``spc``: ``resource_usage`` of
    ``spc_traverse.cu``, ``traverse`` and the config 5 trace
    (``unbatched_raytrace``), each with its device time, device
    activities, host syncs and device time a level. Prints one JSON line
    per measurement tagged ``label``. Copy this script into another
    checkout's root to time that checkout; compare two checkouts in turns
    (a, b, b, a) on one machine, since two machines may hold different
    cards."""
    card = card_line()
    log(card)

    def report(name, values):
        log(json.dumps({'tree': label, 'name': name, **values}))

    if 'render' in groups:
        resource_usage()
        for name, b, s in (*SIZES, LARGE):
            sc = Scene(name, b, s, 'cuda',
                       LARGE_SCALE if (name, b, s) == LARGE else 1.)
            forward_counts(sc)
            backward_counts(sc)
            for key, t in forward_times(label, sc).items():
                report(key, t)
            for key, t in backward_times(label, sc).items():
                report(key, t)
            if (name, b, s) != LARGE:
                report(f'train_step, {name}', train_step_times(label, sc))
            del sc
    if 'texture' in groups:
        resource_usage(('grid_sample',))
        tsc = TexturedScene(TEX_BATCH, TEX_SUBDIV, TEX_SIZE, H, W, 'cuda')
        tex, ix, iy, cot = tsc.sampler_inputs()
        gen = torch.Generator('cuda').manual_seed(SEED)
        rand_cot = torch.randn(cot.shape, device='cuda', generator=gen)
        grid_sample_counts('[step cotangent]', tex, ix, iy, cot)
        grid_sample_counts('[random cotangent]', tex, ix, iy, rand_cot)
        B, P = ix.shape
        for size, maps in ((TEX_SIZE, tex), (64, torch.rand(
                B, tex.shape[1], 64, 64, device='cuda', generator=gen))):
            rx = torch.rand(B, P, device='cuda', generator=gen) * (size - 1)
            ry = torch.rand(B, P, device='cuda', generator=gen) * (size - 1)
            grid_sample_counts(f'[{size}x{size} random coords]', maps, rx,
                               ry, rand_cot)
        report('grid_sample', sampler_times(f'[{label}]', tex, ix, iy))
        report('grid_sample_backward, step cotangent',
               sampler_backward_times(label, tex, ix, iy, cot,
                                      'step cotangent'))
        report('grid_sample_backward, random cotangent',
               sampler_backward_times(label, tex, ix, iy, rand_cot,
                                      'random cotangent'))
        ms = textured_step_ms(tsc)
        prof = profile_calls(f'[{label}] profile textured step',
                             lambda: tsc.train(1), ms, watch=GS_BWD_KERNELS)
        in_step = (sum(v for k, v in prof['kernels'].items()
                       if any(w in k for w in GS_BWD_KERNELS))
                   if prof else None)
        report('textured_step', dict(
            ms=ms, device_ms=device_ms(f'[{label}] textured step',
                                       lambda: tsc.train(1), iters=5),
            grid_sample_backward_in_step_ms=in_step))
        del tsc
    if 'metrics' in groups:
        resource_usage(('nn_distance',))
        for n in (FIT3_EVAL, DIBR_CHAMFER_N, M3_N):
            report(f'nearest_idx, {n} x {n}', nn_brute_times(label, n))
        for key, t in nn_metric_times(label).items():
            report(key, t)
        for name, t in p2m_times(label, p2m_scenes()).items():
            report(f'p2m_select, {name}', t)
        p1, p2, fv = kt.utils.interop.metrics_scene(SEED, M3_N, M3_N,
                                                    M3_FACES)
        report('nearest_idx_pruned, config3', dict(
            nn_times(label, p1, p2),
            **host_wall_ms(lambda: kn.nearest_idx_pruned(p1, p2))))
        report('prepass, config3', prepass_times(label, p1, p2))
        report('nearest_idx_pruned, sphere centre',
               nn_times(label, *sphere_centre()))
        report(f'nearest_idx_pruned, {NN_BIG} points',
               nn_big_times(label)[0])
        report('config3_step', dict(
            ms=metrics_path()[1], **host_wall_ms(
                lambda: kt.utils.interop.metrics_step(p1, p2, fv))))
    if 'deftet' in groups:
        d4 = kt.utils.interop.deftet_scene(seed=SEED, side=D4_SIDE,
                                           num_faces=D4_FACES)
        valid = torch.ones(d4[2].shape[:2], dtype=torch.bool, device='cuda')
        report('deftet_topk, config4', deftet_times(label, (*d4[:4], valid)))
        report('deftet_topk, config4 knum 300',
               deftet_times(label, (*d4[:4], valid), D4_BIG_KNUM))
        report('deftet_topk, full cover', deftet_times(label, full_cover(d4)))
        report('config4_step', {'ms': deftet_path(d4)[1]})
    if 'spc' in groups:
        resource_usage(('spc_traverse',))
        octree, ph, pyr, exsum = kt.utils.interop.sphere_shell_spc(
            level=C5_LEVEL, n=C5_N, seed=SEED, radius=C5_RADIUS)
        o, d = kt.render.spc.generate_primary_rays(C5_RES, C5_RES, *C5_CAM)
        report('traverse, config5', trace_times(
            label, 'traverse, config5', lambda: kst.traverse(
                octree, exsum, ph, o, d, C5_LEVEL)))
        report('config5 trace', trace_times(
            label, 'config5 trace', lambda: kt.render.spc.unbatched_raytrace(
                octree, ph, pyr, exsum, o, d, C5_LEVEL)))
    log(card)
    return 0


# ---------------------------------------- parallel/ and io/ (the sharded paths)

# seconds a world of ranks on the card may take before it is killed; the
# NCCL probe's world takes torch's start-up twice and one init
PAR_DEADLINE, PROBE_DEADLINE = 300., 90.
PAR_MESHES = ((1, 2), (2, 1))
PAR_ITERS = 5
TOL_SUM = 1e-5       # float32 sums taken in another order (per-rank halves)
RENDER_PATH = ('rasterize_interp', 'soft_mask_forward', 'rasterize_backward',
               'soft_mask_backward')


def free_port():
    with contextlib.closing(socket.socket()) as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def block_rows(mesh, batch):
    """(this rank's batch rows, its first image row, its rows)."""
    ndata, di = par_mesh.axis(mesh, 'data')
    npix, pi = par_mesh.axis(mesh, 'pix')
    lb, lh = batch // ndata, H // npix
    return slice(di * lb, (di + 1) * lb), pi * lh, lh


def sharded_loss(mesh, feat, mask, target, batch):
    """``bench.py``'s loss (L1 of the features to 0 plus ``mask_iou`` to the
    disc) of the whole images from this rank's block: the per-image sums
    and the L1 sum are summed over the mesh (``mesh_sum``, one
    all_reduce)."""
    rows, _, _ = block_rows(mesh, batch)
    idx = torch.arange(rows.start, rows.stop, device=mask.device)
    mul, add = mask * target, mask + target
    lb = mask.shape[0]
    zeros = mask.new_zeros(batch)
    sums = par_mesh.mesh_sum(mesh, torch.cat([
        zeros.index_add(0, idx, mul.reshape(lb, -1).sum(dim=1)),
        zeros.index_add(0, idx, (add - mul).reshape(lb, -1).sum(dim=1)),
        feat.abs().sum()[None]]))
    l1 = sums[-1] / (batch * H * W * feat.shape[-1])
    return l1 + (1. - (sums[:batch] / (sums[batch:2 * batch] + 1e-10)).mean())


def sharded_forward(sc, mesh, verts):
    _, faces, rot, trans, proj = sc.args
    fvc, fvi, fn = kt.render.mesh.prepare_vertices(
        verts, faces, proj, camera_rot=rot, camera_trans=trans)
    return kt.parallel.sharded_dibr_rasterization(
        mesh, H, W, fvc[..., 2], fvi, sc.features(fvc, 4), fn[..., 2])


def sharded_step(sc, mesh, verts):
    """The train step through the sharded render: (loss, gradient to the
    whole vertices, this rank's block)."""
    verts = verts.detach().requires_grad_(True)
    feat, mask, idx = sharded_forward(sc, mesh, verts)
    rows, r0, lh = block_rows(mesh, sc.batch)
    loss = sharded_loss(mesh, feat, mask, sc.target[rows, r0:r0 + lh],
                        sc.batch)
    g, = torch.autograd.grad(loss, [verts])
    return loss.detach(), g, (feat.detach(), mask.detach(), idx)


def plain_step(sc, verts):
    verts = verts.detach().requires_grad_(True)
    loss = sc.train_loss(verts)
    g, = torch.autograd.grad(loss, [verts])
    return loss.detach(), g


def check_launches(label, launches, names):
    for name in names:
        expect(launches[name] > 0, f'{label}: {name} was not launched')


def parallel_world1(sc):
    """``init_distributed`` through torchrun's variables (NCCL, a world of
    one), ``make_mesh()`` (1 x 1), the sharded render and its train step
    at ``bench.py``'s size against ``dibr_rasterization``, both timed.
    Returns {name: ms}."""
    saved = {k: os.environ.get(k) for k in ('MASTER_ADDR', 'MASTER_PORT',
                                            'WORLD_SIZE', 'RANK',
                                            'LOCAL_RANK', 'LOCAL_WORLD_SIZE')}
    os.environ.update(MASTER_ADDR='localhost', MASTER_PORT=str(free_port()),
                      WORLD_SIZE='1', RANK='0', LOCAL_RANK='0',
                      LOCAL_WORLD_SIZE='1')
    try:
        rank, world = kt.parallel.init_distributed()
        backend = dist.get_backend()
        x = torch.ones(1, device='cuda')
        dist.all_reduce(x)
        mesh = kt.parallel.make_mesh()
        log(f'[parallel_world1] init_distributed: rank {rank} of {world}, '
            f'backend {backend}, one all_reduce on the card {float(x)}, '
            f'mesh {tuple(mesh.mesh.shape)} {mesh.mesh_dim_names} '
            f'({mesh.device_type})')
        expect((rank, world) == (0, 1) and backend == 'nccl'
               and float(x) == 1. and tuple(mesh.mesh.shape) == (1, 1),
               'parallel_world1: not a one-rank NCCL world')
        verts = sc.args[0]
        reset_counters()
        loss, g, (feat, mask, idx) = sharded_step(sc, mesh, verts)
        launches = read_counters('parallel_world1 path')
        check_launches('parallel_world1', launches, RENDER_PATH)
        ref_feat, ref_mask, ref_idx, _ = sc.forward(4)
        ref_loss, ref_g = plain_step(sc, verts)
        torch.cuda.synchronize()
        same = (torch.equal(idx, ref_idx) and torch.equal(mask, ref_mask)
                and torch.equal(feat, ref_feat))
        rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        log(f'[parallel_world1] sharded vs dibr_rasterization: face_idx, '
            f'mask and features bit-equal {same}; loss {float(loss):.7f} vs '
            f'{float(ref_loss):.7f} (rel {rel:.2e})')
        expect(same and rel <= TOL_SUM,
               'parallel_world1: the sharded render differs')
        grad_close('[parallel_world1] train-step grad', g, ref_g)
        # in turns (plain, sharded, sharded, plain): the host's spread
        calls = {'fwd': (lambda: sc.forward(4),
                         lambda: sharded_forward(sc, mesh, verts)),
                 'step': (lambda: plain_step(sc, verts),
                          lambda: sharded_step(sc, mesh, verts))}
        times = {}
        for name, (plain, sharded) in calls.items():
            turns = [time_ms(fn, TIME_ITERS)
                     for fn in (plain, sharded, sharded, plain)]
            times[f'plain_{name}'] = (turns[0], turns[3])
            times[f'sharded_{name}'] = (turns[1], turns[2])
            log(f'[parallel_world1] time {name} (batch {sc.batch}, '
                f'{sc.num_faces} faces, {H}x{W}, ms per call, in turns '
                f'plain / sharded / sharded / plain): '
                + ' / '.join(f'{t:.4f}' for t in turns))
        return times
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def rank_render(out):
    sc = Scene('bench', *SIZES[0][1:], 'cuda')
    for data, pix in PAR_MESHES:
        mesh = kt.parallel.make_mesh(data=data, pix=pix)
        key = f'{data}x{pix}'
        _, r0, _ = block_rows(mesh, sc.batch)
        reset_counters()
        loss, g, (feat, mask, idx) = sharded_step(sc, mesh, sc.args[0])
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in COUNTERS}
        out.update({f'{key}_loss': loss, f'{key}_grad': g,
                    f'{key}_feat': feat, f'{key}_mask': mask,
                    f'{key}_idx': idx, f'{key}_row_start': r0,
                    **{f'{key}_n_{k}': v for k, v in launches.items()}})
        out[f'{key}_fwd_ms'] = time_ms(
            lambda: sharded_forward(sc, mesh, sc.args[0]), PAR_ITERS)
        out[f'{key}_step_ms'] = time_ms(
            lambda: sharded_step(sc, mesh, sc.args[0]), PAR_ITERS)


def rank_metrics(out):
    p1, p2, fv = kt.utils.interop.metrics_scene(SEED, M3_N, M3_N, M3_FACES)
    mesh = kt.parallel.make_mesh()
    reset_counters()
    a, b = p1.clone().requires_grad_(True), p2.clone().requires_grad_(True)
    c = kt.parallel.sharded_chamfer_distance(mesh, a, b)
    g1, g2 = torch.autograd.grad(c.sum(), [a, b])
    a, f = p1.clone().requires_grad_(True), fv.clone().requires_grad_(True)
    d, i, t = kt.parallel.sharded_point_to_mesh_distance(mesh, a, f)
    gp, gf = torch.autograd.grad(d.sum(), [a, f])
    torch.cuda.synchronize()
    out.update(chamfer=c, chamfer_g1=g1, chamfer_g2=g2, p2m_dist=d,
               p2m_idx=i, p2m_type=t, p2m_gp=gp, p2m_gf=gf,
               **{f'metrics_n_{c.__name__}': c.launches for c in COUNTERS})

    def step():
        kt.parallel.sharded_chamfer_distance(mesh, p1, p2)
        kt.parallel.sharded_point_to_mesh_distance(mesh, p1, fv)
    out['metrics_ms'] = time_ms(step, PAR_ITERS)


def rank_trace(out):
    octree, ph, _, exsum = kt.utils.interop.sphere_shell_spc(
        level=C5_LEVEL, n=C5_N, seed=SEED, radius=C5_RADIUS)
    o, d = kt.render.spc.generate_primary_rays(C5_RES, C5_RES, *C5_CAM)
    mesh = kt.parallel.make_mesh(data=1, pix=2)
    sched, cap = par_spc.plan_sharded_raytrace(2, octree, ph, exsum, o, d,
                                               C5_LEVEL)
    reset_counters()
    ridx, pidx, depth, count = kt.parallel.sharded_raytrace(
        mesh, octree, ph, exsum, o, d, C5_LEVEL, cap, cap_schedule=sched)
    n = int(count[0])
    out.update(trace_ridx=ridx[:n], trace_pidx=pidx[:n],
               trace_depth=depth[:n], trace_count=count, trace_cap=cap,
               trace_n_traverse=kst.traverse.launches)
    out['trace_ms'] = time_ms(lambda: kt.parallel.sharded_raytrace(
        mesh, octree, ph, exsum, o, d, C5_LEVEL, cap, cap_schedule=sched),
        PAR_ITERS)


def rank_main(task, backend, out_dir):
    """One rank of ``parallel_world2`` (``chip_smoke.py --rank``): joins
    the world on card 0 with ``backend``; ``probe`` makes one all_reduce,
    ``work`` runs the sharded render and its train step at meshes (1, 2)
    and (2, 1), config 3's sharded metrics and config 5's split trace, and
    writes its blocks, gradients, launch counts and times to
    ``out_dir/rank_<r>.npz``."""
    rank, world = kt.parallel.init_distributed(backend=backend,
                                               local_device_ids=[0])
    if task == 'probe':
        x = torch.ones(1, device='cuda')
        dist.all_reduce(x)
        torch.cuda.synchronize()
        log(f'[rank {rank}] {backend}: all_reduce on card 0 gave {float(x)}')
        dist.destroy_process_group()
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    start = time.perf_counter()
    rank_render(out)
    rank_metrics(out)
    rank_trace(out)
    out['rank_s'] = time.perf_counter() - start
    np.savez(os.path.join(out_dir, f'rank_{rank}.npz'),
             **{k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                    else np.asarray(v)) for k, v in out.items()})
    dist.destroy_process_group()
    log(f'[rank {rank}] done in {out["rank_s"]:.1f} s')
    return 0


def run_world(task, backend, out_dir, deadline):
    outs = par_launch.run_ranks(
        2, [sys.executable, os.path.abspath(__file__), '--rank', task,
            backend, out_dir], deadline=deadline, master_port=free_port(),
        env={'OMP_NUM_THREADS': '4'})     # the host's 8 cores, halved
    for rank, text in enumerate(outs):
        for line in text.splitlines():
            log(f'    {line}')


def parallel_world2(scenes):
    """Two ranks on the one card: NCCL first (it refuses two ranks on one
    device), else gloo, which moves CUDA tensors for ``all_reduce``. Each
    rank's render, train-step gradient, metrics and trace against the
    one-process result on the card, and its launch counts. Returns the
    ranks' times."""
    import tempfile
    backend = 'nccl'
    with tempfile.TemporaryDirectory() as probe_dir:
        try:
            run_world('probe', 'nccl', probe_dir, PROBE_DEADLINE)
            log('[parallel_world2] NCCL runs two ranks on one card')
        except par_launch.RankError as exc:
            why = [ln.strip() for ln in str(exc).splitlines()
                   if 'Duplicate GPU' in ln or 'Error' in ln][:3]
            log(f'[parallel_world2] NCCL refused two ranks on one card: '
                f'{" | ".join(why) or str(exc)[:400]}; gloo over CUDA '
                'tensors instead')
            backend = 'gloo'
    with tempfile.TemporaryDirectory() as out_dir:
        start = time.perf_counter()
        run_world('work', backend, out_dir, PAR_DEADLINE)
        wall = time.perf_counter() - start
        outs = [dict(np.load(os.path.join(out_dir, f'rank_{r}.npz')))
                for r in range(2)]
    log(f'[parallel_world2] backend {backend}: the world took {wall:.1f} s')

    sc = scenes[0]
    ref_feat, ref_mask, ref_idx, _ = sc.forward(4)
    _, ref_g = plain_step(sc, sc.args[0])
    for data, pix in PAR_MESHES:
        key = f'{data}x{pix}'
        got = {}
        for name in ('feat', 'mask', 'idx'):
            rows = [np.concatenate([o[f'{key}_{name}'] for o in outs[
                d * pix:(d + 1) * pix]], axis=1) for d in range(data)]
            got[name] = torch.from_numpy(np.concatenate(rows, axis=0))
        mism = int((got['idx'] != ref_idx.cpu()).sum())
        err = max(max_err(got['mask'], ref_mask.cpu()),
                  max_err(got['feat'], ref_feat.cpu()))
        starts = [int(o[f'{key}_row_start']) for o in outs]
        log(f'[parallel_world2] mesh {key}: rows from {starts}, face_idx '
            f'mismatches {mism}, mask and features max err {err:.3e}')
        expect(mism == 0 and err <= TOL_FEATURES,
               f'parallel_world2 {key}: the gathered render differs')
        for r, o in enumerate(outs):
            check_launches(f'parallel_world2 {key} rank {r}',
                           {n: int(o[f'{key}_n_{n}']) for n in RENDER_PATH},
                           RENDER_PATH)
            grad_close(f'[parallel_world2] {key} rank {r} train-step grad',
                       torch.from_numpy(o[f'{key}_grad']).to(ref_g.device),
                       ref_g)
        expect(starts == ([0, H // 2] if pix == 2 else [0, 0]),
               'parallel_world2: unexpected row slabs')

    p1, p2, fv = kt.utils.interop.metrics_scene(SEED, M3_N, M3_N, M3_FACES)
    a, b = p1.clone().requires_grad_(True), p2.clone().requires_grad_(True)
    c = kt.metrics.pointcloud.chamfer_distance(a, b)
    g1, g2 = torch.autograd.grad(c.sum(), [a, b])
    c = c.detach()
    a, f = p1.clone().requires_grad_(True), fv.clone().requires_grad_(True)
    d, i, t = kt.metrics.trianglemesh.point_to_mesh_distance(a, f)
    gp, gf = torch.autograd.grad(d.sum(), [a, f])
    cat = {k: torch.from_numpy(np.concatenate([o[k] for o in outs], axis=1))
           for k in ('p2m_dist', 'p2m_idx', 'p2m_type')}
    for r, o in enumerate(outs):
        rel = abs(float(o['chamfer'][0]) - float(c)) / float(c)
        log(f'[parallel_world2] rank {r}: chamfer {float(o["chamfer"][0]):.7e}'
            f' vs {float(c):.7e} (rel {rel:.2e}), pruned NN launches '
            f'{int(o["metrics_n_nearest_idx_pruned"])}, p2m_select launches '
            f'{int(o["metrics_n_p2m_select"])}')
        expect(rel <= TOL_SUM, f'parallel_world2 rank {r}: the sharded '
               'chamfer differs')
        check_launches(f'parallel_world2 metrics rank {r}', {
            n: int(o[f'metrics_n_{n}']) for n in ('nearest_idx_pruned',
                                                  'p2m_select')},
            ('nearest_idx_pruned', 'p2m_select'))
        for name, out, ref in (('chamfer grad p1', 'chamfer_g1', g1),
                               ('chamfer grad p2', 'chamfer_g2', g2),
                               ('p2m grad points', 'p2m_gp', gp),
                               ('p2m grad faces', 'p2m_gf', gf)):
            grad_close(f'[parallel_world2] rank {r} {name}',
                       torch.from_numpy(o[out]).to(ref.device), ref)
    mism = (int((cat['p2m_idx'] != i.cpu()).sum())
            + int((cat['p2m_type'] != t.cpu()).sum()))
    err = max_err(cat['p2m_dist'], d.detach().cpu())
    log(f'[parallel_world2] point-to-mesh gathered: face and type '
        f'mismatches {mism}, max err {err:.3e}')
    expect(mism == 0 and err == 0., 'parallel_world2: sharded p2m differs')

    octree, ph, pyramid, exsum = kt.utils.interop.sphere_shell_spc(
        level=C5_LEVEL, n=C5_N, seed=SEED, radius=C5_RADIUS)
    o5, d5 = kt.render.spc.generate_primary_rays(C5_RES, C5_RES, *C5_CAM)
    ridx, pidx, depth = kt.render.spc.unbatched_raytrace(
        octree, ph, pyramid, exsum, o5, d5, C5_LEVEL)
    per = o5.shape[0] // 2
    rays = torch.from_numpy(np.concatenate(
        [o['trace_ridx'] + r * per for r, o in enumerate(outs)]))
    pts = torch.from_numpy(np.concatenate([o['trace_pidx'] for o in outs]))
    dep = torch.from_numpy(np.concatenate([o['trace_depth'] for o in outs]))
    same = (torch.equal(rays, ridx.cpu()) and torch.equal(pts, pidx.cpu())
            and torch.equal(dep, depth.cpu()))
    counts = [int(o['trace_count'][0]) for o in outs]
    log(f'[parallel_world2] trace split in two: hits {counts} (one process '
        f'{ridx.shape[0]}), ids and depths equal {same}, traversal launches '
        f'{[int(o["trace_n_traverse"]) for o in outs]}, cap '
        f'{[int(o["trace_cap"]) for o in outs]}')
    expect(same, 'parallel_world2: the split trace differs')
    for r, o in enumerate(outs):
        check_launches(f'parallel_world2 trace rank {r}',
                       {'traverse': int(o['trace_n_traverse'])},
                       ('traverse',))

    times = {}
    for r, o in enumerate(outs):
        times[r] = {k: float(o[k]) for k in o if k.endswith('_ms')}
        log(f'[parallel_world2] time rank {r} of 2 sharing one card '
            f'(backend {backend}, ms per call): ' + ', '.join(
                f'{k} {v:.4f}' for k, v in times[r].items()))
    return backend, times


def io_phase(main_scene):
    """OBJ (with ``vt``, ``vn`` and a Kd-only MTL), OFF and a checkpoint of
    an Adam state written to a temp dir, loaded onto the card and checked
    against the arrays written; the OBJ rendered through the forward DIB-R
    (face_idx equal to the bench scene's first image); the checkpoint
    restored bit-exactly."""
    import tempfile
    verts, faces = kt.utils.interop.icosphere(SIZES[0][2])
    uvs = np.stack([0.5 + np.arctan2(verts[:, 2], verts[:, 0]) / (2 * np.pi),
                    0.5 + np.arcsin(np.clip(verts[:, 1], -1, 1)) / np.pi],
                   axis=1).astype(np.float32)
    kd = np.array([0.8, 0.5, 0.2], np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        obj_path = os.path.join(tmp, 'ico.obj')
        with open(os.path.join(tmp, 'ico.mtl'), 'w') as f:
            f.write('newmtl skin\nKd %.9g %.9g %.9g\n' % tuple(kd))
        lines = ['mtllib ico.mtl']
        lines += ['v %.9g %.9g %.9g' % tuple(v) for v in verts]
        lines += ['vt %.9g %.9g' % tuple(u) for u in uvs]
        lines += ['vn %.9g %.9g %.9g' % tuple(v) for v in verts]
        lines += ['usemtl skin']
        lines += ['f ' + ' '.join(f'{i + 1}/{i + 1}/{i + 1}' for i in fc)
                  for fc in faces]
        with open(obj_path, 'w') as f:
            f.write('\n'.join(lines) + '\n')
        off_path = os.path.join(tmp, 'ico.off')
        with open(off_path, 'w') as f:
            f.write(f'OFF\n{len(verts)} {len(faces)} 0\n'
                    + ''.join('%.9g %.9g %.9g\n' % tuple(v) for v in verts)
                    + ''.join('3 %d %d %d\n' % tuple(fc) for fc in faces))
        mesh = kt.io.obj.import_mesh(obj_path, with_materials=True,
                                     with_normals=True, device='cuda')
        off_mesh = kt.io.off.import_mesh(off_path, device='cuda')
        f64 = faces.astype(np.int64)
        want = dict(vertices=verts, faces=f64, uvs=uvs, face_uvs_idx=f64,
                    vertex_normals=verts, face_normals=f64,
                    materials_order=np.array([[0, 0]]))
        ok = all(getattr(mesh, k).device.type == 'cuda' and np.array_equal(
            getattr(mesh, k).cpu().numpy(), v) for k, v in want.items())
        ok = ok and np.array_equal(mesh.materials[0]['Kd'].cpu().numpy(), kd)
        ok_off = (off_mesh.vertices.device.type == 'cuda'
                  and np.array_equal(off_mesh.vertices.cpu().numpy(), verts)
                  and np.array_equal(off_mesh.faces.cpu().numpy(), f64))
        log(f'[io] OBJ ({len(verts)} vertices, {len(faces)} faces, vt, vn, '
            f'Kd-only MTL) on the card equal to the arrays written {ok}; '
            f'OFF {ok_off}')
        expect(ok and ok_off, 'io: a loaded mesh differs from the arrays')

        _, _, rot, trans, proj = main_scene.args
        reset_counters()
        fvc, fvi, fn = kt.render.mesh.prepare_vertices(
            mesh.vertices[None], mesh.faces, proj, camera_rot=rot[:1],
            camera_trans=trans[:1])
        feat_uv = kt.ops.mesh.index_vertices_by_faces(mesh.uvs[None],
                                                      mesh.face_uvs_idx)
        feat, soft, idx = kt.render.mesh.dibr_rasterization(
            H, W, fvc[..., 2], fvi, feat_uv, fn[..., 2])
        launches = read_counters('io render path')
        check_launches('io render', launches, ('rasterize_interp',
                                               'soft_mask_forward'))
        ref_idx = main_scene.forward(4)[2][:1]
        same = torch.equal(idx, ref_idx)
        cov = float((idx >= 0).float().mean())
        log(f'[io] the loaded OBJ rendered: coverage {cov:.4f}, face_idx '
            f'equal to the bench scene\'s first image {same}, uv in '
            f'[{float(feat.min()):.3f}, {float(feat.max()):.3f}]')
        expect(same and bool(torch.isfinite(feat).all()
                             and torch.isfinite(soft).all()),
               'io: the loaded mesh renders otherwise')

        p = mesh.vertices.clone().requires_grad_(True)
        opt = torch.optim.Adam([p], lr=1e-3)
        for _ in range(3):
            opt.zero_grad()
            (p ** 2).sum().backward()
            opt.step()
        state = {'params': p.detach(), 'opt': opt.state_dict(), 'step': 3}
        mgr = kt.utils.checkpoint.CheckpointManager(os.path.join(tmp, 'ck'),
                                                    max_to_keep=2)
        for step in (1, 2, 3):
            mgr.save(step, state)
        back = mgr.restore(mgr.latest_step(), device='cuda')
        leaves, _ = kt.utils.checkpoint._flatten(state)
        got, _ = kt.utils.checkpoint._flatten(back)
        exact = len(leaves) == len(got) and all(
            (torch.is_tensor(a) and a.dtype == b.dtype
             and b.device.type == 'cuda' and torch.equal(a.to(b.device), b))
            or (not torch.is_tensor(a) and a == b)
            for a, b in zip(leaves, got))
        log(f'[io] checkpoint of an Adam state ({len(leaves)} leaves): steps '
            f'kept {mgr.all_steps()}, restored on the card bit-exactly '
            f'{exact}')
        expect(exact and mgr.all_steps() == [2, 3],
               'io: the checkpoint round trip differs')


# the iterations of config 2's train step that Timelapse checkpoints
USD_CHECKPOINTS = (0, 10, 20)


def usd_render_idx(sc, verts):
    """``face_idx`` of config 2's forward render of ``verts``."""
    _, faces, rot, trans, proj = sc.args
    fvc, fvi, fn = kt.render.mesh.prepare_vertices(
        verts, faces, proj, camera_rot=rot, camera_trans=trans)
    return kt.render.mesh.dibr_rasterization(
        H, W, fvc[..., 2], fvi, sc.features(fvc, 4), fn[..., 2])[2]


def usd_phase(sc):
    """USD I/O, ``Timelapse`` and the dash3d helper on the card at config
    2's size: config 2's train step (``sc``) checkpointed by
    ``Timelapse.add_mesh_batch`` at USD_CHECKPOINTS from its CUDA vertex
    tensor (which requires grad), config 3's cloud and one VOX_RES^3 grid
    of config 2's mesh checkpointed once; everything read back onto the
    card bit-equal, at every time written; config 2's 8 meshes exported to
    ``.usda`` and ``.usdc`` and read back; the mesh read back at the last
    checkpoint rendered (``face_idx`` equal to the render of what was
    written, the forward kernels counted); the viewer's mesh payload
    decoded; a material with values only round-tripped. Host ms of each
    write and read, with the file sizes; returns them."""
    import tempfile
    usd = kt.io.usd
    pil_before = 'PIL' in sys.modules
    faces = sc.faces
    out = {'checkpoint_ms': {}}
    with tempfile.TemporaryDirectory() as tmp:
        logdir = os.path.join(tmp, 'logs')
        tl = kt.visualize.Timelapse(logdir)
        written = {}
        reset_counters()
        v = sc.args[0]
        for it in range(USD_CHECKPOINTS[-1] + 1):
            v = v.detach().requires_grad_(True)
            loss = sc.train_loss(v)
            if it in USD_CHECKPOINTS:
                expect(v.device.type == 'cuda' and v.requires_grad,
                       'usd: the checkpointed vertices are not the step\'s')
                t0 = time.perf_counter()
                tl.add_mesh_batch(iteration=it, category='config2',
                                  vertices_list=list(v),
                                  faces_list=[faces] * sc.batch)
                out['checkpoint_ms'][it] = (time.perf_counter() - t0) * 1e3
                written[it] = v.detach().clone()
            g, = torch.autograd.grad(loss, [v])
            v = v.detach() - TRAIN_LR * g
        check_launches('usd train', read_counters('usd train path'),
                       ('rasterize_interp', 'soft_mask_forward',
                        'rasterize_backward', 'soft_mask_backward'))
        log(f'[usd] Timelapse.add_mesh_batch of config 2\'s {sc.batch} '
            f'meshes ({sc.num_faces} faces) at iterations '
            f'{list(USD_CHECKPOINTS)}: host ms '
            + json.dumps(out['checkpoint_ms']))

        cloud = kt.utils.interop.metrics_scene(SEED, M3_N, M3_N, 1)[0][0]
        verts, mesh_faces = config2_mesh('cuda')
        grid = kt.ops.conversions.trianglemeshes_to_voxelgrids(
            verts[:1], mesh_faces, VOX_RES)[0]
        t0 = time.perf_counter()
        tl.add_pointcloud_batch(iteration=0, category='config3',
                                pointcloud_list=[cloud])
        out['cloud_ms'] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        tl.add_voxelgrid_batch(iteration=0, category='voxels',
                               voxelgrid_list=[grid])
        out['grid_ms'] = (time.perf_counter() - t0) * 1e3
        log(f'[usd] add_pointcloud_batch of config 3\'s {M3_N} points '
            f'{out["cloud_ms"]:.1f} ms, add_voxelgrid_batch of a '
            f'{VOX_RES}^3 grid ({int((grid > 0.5).sum())} cells) '
            f'{out["grid_ms"]:.1f} ms (host)')

        def same(got, ref, dtype):
            return (got.device.type == 'cuda' and got.dtype == dtype
                    and torch.equal(got, ref))

        t0 = time.perf_counter()
        ok = True
        back = {}
        for i in range(sc.batch):
            stage = usd.Stage.load(os.path.join(logdir, 'config2',
                                                f'mesh_{i}.usda'))
            for it in USD_CHECKPOINTS:
                mesh = usd.import_mesh(stage, time=it, device='cuda')
                back[it, i] = mesh.vertices
                ok = ok and same(mesh.vertices, written[it][i],
                                 torch.float32) and same(
                    mesh.faces, faces, torch.int64)
        out['read_meshes_ms'] = (time.perf_counter() - t0) * 1e3
        pc = usd.import_pointcloud(os.path.join(logdir, 'config3',
                                                'pointcloud_0.usda'),
                                   time=0, device='cuda')
        vg = usd.import_voxelgrid(os.path.join(logdir, 'voxels',
                                               'voxelgrid_0.usda'),
                                  time=0, device='cuda')
        ok_pc = same(pc.points, cloud, torch.float32)
        ok_vg = same(vg, grid > 0.5, torch.bool)
        log(f'[usd] read back on the card: the meshes at every '
            f'checkpoint bit-equal {ok} ({out["read_meshes_ms"]:.1f} ms), '
            f'the cloud {ok_pc}, the grid {ok_vg}')
        expect(ok and ok_pc and ok_vg, 'usd: a checkpoint reads back '
               'otherwise than written')

        last = written[USD_CHECKPOINTS[-1]]
        for ext in ('usda', 'usdc'):
            path = os.path.join(tmp, f'config2.{ext}')
            t0 = time.perf_counter()
            usd.export_meshes(path, vertices=list(last),
                              faces=[faces] * sc.batch)
            write_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            meshes = usd.import_meshes(path, device='cuda')
            torch.cuda.synchronize()
            read_ms = (time.perf_counter() - t0) * 1e3
            exact = len(meshes) == sc.batch and all(
                same(m.vertices, last[i], torch.float32)
                and same(m.faces, faces, torch.int64)
                for i, m in enumerate(meshes))
            out[ext] = dict(write_ms=write_ms, read_ms=read_ms,
                            bytes=os.path.getsize(path))
            log(f'[usd] export_meshes of config 2\'s {sc.batch} meshes to '
                f'.{ext}: ' + json.dumps(out[ext])
                + f', read back bit-equal {exact}')
            expect(exact, f'usd: the .{ext} export reads back otherwise')

        reset_counters()
        idx = usd_render_idx(sc, torch.stack(
            [back[USD_CHECKPOINTS[-1], i] for i in range(sc.batch)]))
        check_launches('usd render', read_counters('usd render path'),
                       ('rasterize_interp', 'soft_mask_forward'))
        ref_idx = usd_render_idx(sc, last)
        same_idx = torch.equal(idx, ref_idx)
        log(f'[usd] the re-imported meshes rendered: face_idx equal to the '
            f'render of the vertices written {same_idx}, coverage '
            f'{float((idx >= 0).float().mean()):.4f}')
        expect(same_idx, 'usd: the re-imported mesh renders otherwise')

        helper = dash3d_util.StreamingGeometryHelper(logdir)
        payload, snap = helper.parse_encode_mesh('config2', 0, 12)
        head = np.array([0, 0, int(snap), 0], np.int32).tobytes()
        msg = dash3d_util.decode_binary_message(
            head + payload)
        item = msg['items'][0]
        ok_view = (snap == 10 and len(msg['items']) == 1
                   and np.array_equal(item['vertices'],
                                      written[10][0].cpu().numpy())
                   and np.array_equal(item['faces'], faces.cpu().numpy()))
        log(f'[usd] dash3d mesh payload at time 12: snapped to {snap}, '
            f'{len(payload)} bytes, decoded to the arrays written {ok_view}')
        expect(ok_view, 'usd: the viewer\'s payload decodes otherwise')

        mat = kt.io.materials.PBRMaterial(
            name='skin', diffuse_color=(0.8, 0.5, 0.2), roughness_value=0.4,
            metallic_value=0.1, is_specular_workflow=True)
        mat_path = os.path.join(tmp, 'material.usda')
        mat.write_to_usd(mat_path, '/World/Looks/skin')
        mat_back = kt.io.materials.PBRMaterial.read_from_usd(
            mat_path, '/World/Looks/skin', device='cuda')
        ok_mat = mat_back.to_dict() == mat.to_dict()
        log(f'[usd] a material with values only round-tripped {ok_mat}; '
            f'PIL imported {"PIL" in sys.modules}, tornado imported '
            f'{"tornado" in sys.modules}')
        expect(ok_mat, 'usd: the material round trip differs')
        expect(pil_before or 'PIL' not in sys.modules,
               'usd: the phase imported PIL')
        expect('tornado' not in sys.modules, 'usd: the phase imported tornado')
    log('[usd] times: ' + json.dumps(out))
    log(card_line())
    return out


# the applications (kaolin_tpu_torch/examples) at the JAX examples' own
# sizes. DMTet runs at lr 3e-4, tests/test_dmtet_example.py's rate, not its
# default 1e-3: at 1e-3 on grid 32 one of the first Adam steps (lr * g / |g|
# on every weight) can erase every sign crossing, which no gradient brings
# back, and float32 rounding decides which run does. In the first 6 steps
# the JAX example lost its surface on 6 of 8 seeds and the port on the CPU
# on 6 of 6 (tests/dmtet_lr_survey.py, CPU); in float64 from the same
# weights and draws the two keep to each other's histories, surviving or
# not alike (tests/test_torch_examples.py)
EX_FISH = dict(res=128, epochs=100, lod_x=16, lod_y=8, key_size=4,
               texture_res=64, texture_epochs=20)
EX_DIBR = dict(steps=150, res=256, num_views=4)
EX_NGLOD = dict(level=6, steps=300, render_res=128)
EX_DMTET = dict(grid_res=32, iterations=1000, num_samples=20000, lr=3e-4)
EX_DMTET_POINTS = 50_000
# the card's first steps against the port's on the CPU: the fish at its
# full size, 3 / 2 / 2 epochs, on a ground truth moved off the centre (on
# the demo's symmetric one origin_x's gradient is rounding, and Adam's
# first step lr * g / |g| turns it into +-lr); DIB-R's first 3 steps at
# 64^2 (at the timed 256^2 the CPU takes 28 s a step); NGLOD's first 3 at
# full size; DMTet's first 3 training steps at grid 32 with 5,000 samples
# of 20,000 points, both sides from the same decoder (pre-trained once on
# the card, copied to each) and the same draws, so that only the step is
# held (the full run's pre-training alone moves the two sides 1e-3 apart:
# 1,000 Adam steps grow float32 rounding), and before each step the CPU
# takes the card's state (decoder, Adam's moments, schedule): run apart
# for 3 steps the two read 1.9e-4 to 0.11 apart over five runs, since
# Adam's first update (lr * g / |g|) turns rounding in a gradient entry
# near 0 into +-lr, and a step can then spike on one side only. Within a
# step, rounding moves a few samples to a neighbouring face (a cumulative
# area moves past a draw, an SDF near 0 changes sign), each moving the
# loss by a little and the gradient by a step; so the first step is also
# held stage by stage, each stage on the card's own inputs copied to the
# CPU (EX_DMTET_STAGE_TOL, relative to the largest entry): the decoder on
# the lattice; the marching tetrahedra (faces and masks equal, the
# vertices); the sampler (the same face for all but EX_DMTET_FLIPS of
# the samples, 2 to 4 of 5,000 read; the same point where the face is
# the same); the Chamfer of those samples (loss and gradient). A wrong
# stage differs there in its leading digit. The steps' losses are held to
# 2e-3: those few samples read 1.9e-4 to 5.5e-4 apart.
EX_FISH_PARITY = dict(epochs=3, texture_epochs=2)
EX_DIBR_PARITY = dict(steps=3, res=64, num_views=4)
EX_NGLOD_PARITY = 3
EX_DMTET_PARITY = dict(grid_res=32, iterations=3, num_samples=5000)
EX_DMTET_PARITY_POINTS = 20_000
EX_RTOL = {'fish': 1e-3, 'dibr': 1e-3, 'nglod': 1e-3, 'dmtet': 2e-3}
EX_DMTET_STAGE_TOL = {'decoder': 1e-5, 'mt_verts': 1e-5, 'samples': 1e-5,
                      'chamfer': 1e-5, 'chamfer_grad': 1e-4}
EX_DMTET_FLIPS = 1e-2
# the falls the JAX tests assert (tests/test_fish.py,
# tests/test_examples_smoke.py); DMTet's mean of its last 5 losses against
# its first 5: 0.0023 on the card at lr 3e-4, held to 0.01 (the JAX torus
# test holds a 14-grid to 0.1)
EX_FISH_FALL, EX_FISH_IOU = 0.9, 0.7
EX_DIBR_FALL = 0.7
EX_NGLOD_FALL, EX_NGLOD_DEPTH, EX_NGLOD_VOXELS = 0.5, 2.0 - 0.6, 2
EX_DMTET_FALL, EX_DMTET_FACES = 0.01, 100
# the kernels (launch counters) each application's run must launch
EX_KERNELS = {
    'fish': ('rasterize_interp', 'soft_mask_forward', 'soft_mask_backward',
             'grid_sample', 'grid_sample_backward'),
    'dibr': ('rasterize_interp', 'rasterize_backward', 'soft_mask_forward',
             'soft_mask_backward', 'grid_sample', 'grid_sample_backward',
             'nearest_idx'),
    'nglod': ('traverse',),
    'dmtet': ('nearest_idx_pruned',),
}


class StepClock:
    """Records a CUDA event after every ``torch.optim.Adam.step`` while
    open, per optimizer; ``stages()`` gives each optimizer's steps and its
    ms a step (from its first step's end to its last's), in the order the
    optimizers were made. No host sync is added."""

    event = staticmethod(lambda: torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        self.events = {}
        self._step = torch.optim.Adam.step
        clock = self

        def step(opt, *args, **kwargs):
            out = clock._step(opt, *args, **kwargs)
            ev = clock.event()
            ev.record()
            # keyed by the optimizer itself: the dict keeps it alive, so a
            # later optimizer cannot take its id
            clock.events.setdefault(opt, []).append(ev)
            return out

        torch.optim.Adam.step = step
        return self

    def __exit__(self, *exc):
        torch.optim.Adam.step = self._step

    def stages(self):
        torch.cuda.synchronize()
        return [(len(evs), evs[0].elapsed_time(evs[-1]) / (len(evs) - 1)
                 if len(evs) > 1 else float('nan'))
                for evs in self.events.values()]


def _rel_diff(card, cpu):
    card, cpu = np.asarray(card, np.float64), np.asarray(cpu, np.float64)
    expect(card.shape == cpu.shape and np.isfinite(card).all(),
           'examples: the parity runs differ in length or are not finite')
    return float(np.max(np.abs(card - cpu) / np.abs(cpu)))


def _run_app(name, fn, labels, out):
    """``fn()`` with the counters at 0 and the step clock on; checks that
    the app launched its kernels (EX_KERNELS) and logs ms a step of each
    of its optimizers (``labels``, in the order they were made) into
    ``out[name]``; returns ``fn()``'s result."""
    reset_counters()
    with StepClock() as clock:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = read_counters(f'examples {name}')
    check_launches(f'examples {name}', launches, EX_KERNELS[name])
    out[name] = {'seconds': seconds,
                 'launches': {k: launches[k] for k in EX_KERNELS[name]}}
    stages = clock.stages()
    expect(len(stages) == len(labels), f'examples {name}: {len(stages)} '
           f'optimizers for {len(labels)} stages')
    for label, (n, ms) in zip(labels, stages):
        out[name][label] = {'steps': n, 'ms_per_step': ms}
        log(f'[examples] {name} {label}: {n} steps, {ms:.4f} ms a step')
    log(f'[examples] {name}: {seconds:.2f} s in all')
    return result


def _parity(name, card, cpu, out):
    out[name]['parity_rel'] = rel = _rel_diff(card, cpu)
    log(f'[examples] {name}: card vs CPU, first {len(card)} steps, max rel '
        f'diff {rel:.3e} (tolerance {EX_RTOL[name]})')
    expect(rel <= EX_RTOL[name],
           f'examples: {name} on the card differs from the CPU')


def fish_app(out, device='cuda', cpu='cpu'):
    from kaolin_tpu_torch.examples import fish
    stages = ('body', 'dorsal_fin', 'texture')
    data, hyper, gt_soft, body, fins, texture, history = _run_app(
        'fish', lambda: fish.synthetic_self_fit(**EX_FISH, device=device),
        stages, out)
    out['fish']['first_last'] = {}
    for stage in stages:
        losses = [l for s, l in history if s == stage]
        out['fish']['first_last'][stage] = (losses[0], losses[-1])
        log(f'[examples] fish {stage}: loss {losses[0]:.5f} -> '
            f'{losses[-1]:.5f}')
        expect(np.isfinite(losses).all()
               and losses[-1] < EX_FISH_FALL * losses[0],
               f'examples: the fish {stage} loss did not fall')
    out['fish']['iou'] = iou = fish.body_iou(body, gt_soft, hyper)
    log(f'[examples] fish body IoU {iou:.4f}')
    expect(iou > EX_FISH_IOU, f'examples: fish body IoU {iou}')
    pdata, _ = fish.synthetic_data(
        EX_FISH['res'], EX_FISH['lod_x'], EX_FISH['lod_y'],
        EX_FISH['key_size'], origin_xy=(-0.55, 0.1),
        fin_uv=((0.25, 1.), (0.7, 1.)), device=cpu)
    phyper = fish.self_fit_hyper(EX_FISH['lod_x'], EX_FISH['lod_y'],
                                 EX_FISH['key_size'],
                                 EX_FISH['texture_res'], **EX_FISH_PARITY)
    _parity('fish',
            [l for _, l in fish.fit_fish(pdata, phyper, device=device)[3]],
            [l for _, l in fish.fit_fish(pdata, phyper, device=cpu)[3]],
            out)


def dibr_app(out, device='cuda', cpu='cpu'):
    from kaolin_tpu_torch.examples import dibr_train
    losses, chamfer = _run_app(
        'dibr', lambda: dibr_train.main(**EX_DIBR, device=device),
        ('train',), out)
    out['dibr'].update(first_last=(float(losses[0]), float(losses[-1])),
                       chamfer=chamfer)
    log(f'[examples] dibr: loss {losses[0]:.5f} -> {losses[-1]:.5f}, '
        f'chamfer {chamfer:.6f}')
    expect(np.isfinite(losses).all() and losses[-1] < EX_DIBR_FALL
           * losses[0] and np.isfinite(chamfer),
           'examples: the DIB-R loss did not fall or its chamfer is not '
           'finite')
    _parity('dibr', dibr_train.main(**EX_DIBR_PARITY, device=device)[0],
            dibr_train.main(**EX_DIBR_PARITY, device=cpu)[0], out)


def nglod_app(out, device='cuda', cpu='cpu'):
    from kaolin_tpu_torch.examples import nglod_train
    losses, depth = _run_app(
        'nglod', lambda: nglod_train.main(**EX_NGLOD, device=device),
        ('fit',), out)
    res, level = EX_NGLOD['render_res'], EX_NGLOD['level']
    centre = float(depth[res // 2, res // 2])
    hits = np.isfinite(depth)
    out['nglod'].update(first_last=(float(losses[0]), float(losses[-1])),
                        centre_depth=centre, coverage=float(hits.mean()))
    log(f'[examples] nglod: loss {losses[0]:.3e} -> {losses[-1]:.3e}, '
        f'centre depth {centre:.4f} (analytic {EX_NGLOD_DEPTH}), '
        f'coverage {hits.mean():.4f}')
    expect(np.isfinite(losses).all()
           and losses[-1] < EX_NGLOD_FALL * losses[0],
           'examples: the NGLOD loss did not fall')
    expect(np.isfinite(centre) and abs(centre - EX_NGLOD_DEPTH)
           <= EX_NGLOD_VOXELS * 2. / 2 ** level,
           f'examples: NGLOD centre depth {centre}')
    expect(hits.any() and not hits.all(),
           'examples: NGLOD rendered no hit or no miss')
    _parity('nglod', losses[:EX_NGLOD_PARITY],
            nglod_train.main(level, EX_NGLOD_PARITY, res, device=cpu)[0],
            out)


def _dmtet_parity_inputs(device, cpu):
    """EX_DMTET_PARITY's lattice, its topology and the normalised torus
    (as ``train_dmtet`` normalises it), on ``device`` and on ``cpu``."""
    from kaolin_tpu_torch.examples import dmtet_train
    points = dmtet_train.torus_points(EX_DMTET_PARITY_POINTS)
    points = ((points - (points.max(0) + points.min(0)) / 2)
              / (points.max(0) - points.min(0)).max() * 0.9)
    tv, tets = kt.ops.conversions.tet_grid(EX_DMTET_PARITY['grid_res'])
    return {dev: (torch.as_tensor(tv, device=dev),
                  dmtet_train.tet_topology(tets, dev),
                  torch.as_tensor(points, dtype=torch.float32,
                                  device=dev)[None])
            for dev in (device, cpu)}


def dmtet_parity(weights, device, cpu):
    """The losses of EX_DMTET_PARITY's first training steps
    (``train_dmtet``'s optimizer and step) on ``device`` from the decoder
    ``weights`` (numpy, the JAX layout), and on ``cpu`` each from the
    card's state before that step (the decoder, Adam's moments and the
    schedule, copied over) and the same draws."""
    from kaolin_tpu_torch.examples import dmtet_train, utils
    inputs = _dmtet_parity_inputs(device, cpu)
    grid, iterations, n = (EX_DMTET_PARITY[k] for k in (
        'grid_res', 'iterations', 'num_samples'))
    sides = (device, cpu)
    decs = [dmtet_train.decoder_from_numpy(weights, device=dev)
            for dev in sides]
    opts = [dmtet_train.dmtet_optimizer(dec, EX_DMTET['lr']) for dec in decs]
    key = torch.Generator().manual_seed(1)
    losses = ([], [])
    for _ in range(iterations):
        decs[1].load_state_dict(decs[0].state_dict())
        for host, card in zip(opts[1], opts[0]):
            host.load_state_dict(card.state_dict())
        draws = tuple(utils.uniform(key, shape, 'cpu') for shape in (
            (1, n), (1, n, 1), (1, n, 1)))
        for dev, dec, opt, out in zip(sides, decs, opts, losses):
            out.append(float(dmtet_train.dmtet_step(
                dec, *opt, *inputs[dev], draws, grid, num_samples=n)))
    log(f'[examples] dmtet: the first {iterations} steps\' losses, card '
        f'{losses[0]}, CPU {losses[1]}')
    return losses


def dmtet_stages(weights, device, cpu):
    """The first step of ``dmtet_parity`` stage by stage: each stage on
    the card, and on the CPU from the card's inputs to it. Returns each
    stage's difference (relative to the CPU's largest magnitude) and the
    share of samples whose face differs."""
    from kaolin_tpu_torch.examples import dmtet_train, utils
    inputs = _dmtet_parity_inputs(device, cpu)
    grid, n = EX_DMTET_PARITY['grid_res'], EX_DMTET_PARITY['num_samples']
    key = torch.Generator().manual_seed(1)
    draws = tuple(utils.uniform(key, shape, 'cpu') for shape in (
        (1, n), (1, n, 1), (1, n, 1)))

    def rel(card, host):
        return float((card.cpu() - host).abs().max() / host.abs().max())

    diff = {}
    with torch.no_grad():
        outs = [dmtet_train.decoder_apply(
            dmtet_train.decoder_from_numpy(weights, device=dev),
            inputs[dev][0]) for dev in (device, cpu)]
        diff['decoder'] = rel(*outs)
        tv = inputs[device][0]
        deformed = tv + torch.tanh(outs[0][:, 1:]) / grid
        mts = [dmtet_train.marching_tetrahedra_fixed(
            deformed.to(dev), inputs[dev][1], outs[0][:, 0].to(dev))
            for dev in (device, cpu)]
        (verts, _, faces, fmask, _), host = mts
        same = all(torch.equal(a.cpu(), b) for a, b in zip(
            mts[0][1:], host[1:]))
        diff['mt_verts'] = rel(verts, host[0]) if same else float('inf')
        areas = torch.where(fmask, kt.ops.mesh.face_areas(
            verts[None], faces)[0], 0.)
        samples = [utils.sample_points(
            verts[None].to(dev), faces.to(dev), n, draws,
            areas=areas[None].to(dev)) for dev in (device, cpu)]
        agree = samples[0][1].cpu() == samples[1][1]
        diff['flips'] = float(1 - agree.float().mean())
        diff['samples'] = rel(samples[0][0][agree], samples[1][0][agree])
    chamfers = []
    for dev in (device, cpu):
        pred = samples[0][0].detach().to(dev).requires_grad_()
        loss = kt.metrics.pointcloud.chamfer_distance(
            pred, inputs[dev][2]).mean()
        loss.backward()
        chamfers.append((loss.detach(), pred.grad))
    diff['chamfer'] = rel(chamfers[0][0], chamfers[1][0])
    diff['chamfer_grad'] = rel(chamfers[0][1], chamfers[1][1])
    return diff


def dmtet_app(out, device='cuda', cpu='cpu'):
    from kaolin_tpu_torch.examples import dmtet_train
    points = dmtet_train.torus_points(EX_DMTET_POINTS)
    params, hist = _run_app(
        'dmtet', lambda: dmtet_train.train_dmtet(points, **EX_DMTET,
                                                 device=device),
        ('pre_train_sphere', 'train'), out)
    start, end = float(np.mean(hist[:5])), float(np.mean(hist[-5:]))
    tv, tets = kt.ops.conversions.tet_grid(EX_DMTET['grid_res'])
    with torch.no_grad():
        tv = torch.as_tensor(tv, device=device)
        sdf = dmtet_train.decoder_apply(params, tv)[:, 0]
        faces = int(kt.ops.conversions.marching_tetrahedra_fixed(
            tv, tets, sdf)[3].sum())
    out['dmtet'].update(first_last=(start, end), faces=faces,
                        max_loss=float(max(hist)),
                        every_100=[float(h) for h in hist[::100]])
    log(f'[examples] dmtet: loss (mean of 5) {start:.5f} -> {end:.5f} '
        f'({end / start:.4f}), max {max(hist):.5f}, {faces} active faces; '
        f'every 100th: {out["dmtet"]["every_100"]}')
    # the checks start from a decoder pre-trained once on the card
    key = torch.Generator().manual_seed(0)
    dec, _ = dmtet_train.pre_train_sphere(
        dmtet_train.init_decoder(key, device=device), key)
    weights = {'w': [layer.weight.detach().cpu().numpy().T
                     for layer in dec.layers]}
    out['dmtet']['stages'] = stages = dmtet_stages(weights, device, cpu)
    log(f'[examples] dmtet: the first step stage by stage, card vs CPU on '
        f'the card\'s inputs: {json.dumps(stages)} (tolerances '
        f'{json.dumps(EX_DMTET_STAGE_TOL)}, flips {EX_DMTET_FLIPS})')
    expect(stages['flips'] <= EX_DMTET_FLIPS and all(
        stages[k] <= tol for k, tol in EX_DMTET_STAGE_TOL.items()),
        'examples: a stage of the DMTet step on the card differs from the '
        'CPU')
    _parity('dmtet', *dmtet_parity(weights, device, cpu), out)
    expect(np.isfinite(hist).all() and end < EX_DMTET_FALL * start,
           'examples: the DMTet loss did not fall')
    expect(faces > EX_DMTET_FACES, f'examples: DMTet kept {faces} faces')


def examples_phase(device='cuda', cpu='cpu'):
    """The applications of ``kaolin_tpu_torch/examples`` on the card at
    the JAX examples' own sizes, each with the launch counters at 0 and
    read after: the fish self-fit (``fish.synthetic_self_fit``: 128^2,
    lod 16 x 8, key size 4, 100 / 50 / 20 epochs, texture 64), DIB-R
    (``dibr_train.main``: 150 steps, 256^2, 4 views), NGLOD
    (``nglod_train.main``: level 6, 300 steps, 128^2 render) and DMTet
    (``dmtet_train.train_dmtet``: grid 32, 20,000 samples, the
    50,000-point torus). Each must fall as the JAX tests assert and launch
    its kernels (EX_KERNELS); its first steps on the card are held against
    the port on the CPU (EX_RTOL, relative, every step). Logs ms a step of
    each stage (CUDA events between the optimizer's steps) and returns
    them."""
    out = {}
    for app in (fish_app, dibr_app, nglod_app, dmtet_app):
        app(out, device, cpu)
    log('[examples] times: ' + json.dumps(out))
    log(card_line())
    return out

def examples_only():
    """``--examples``: builds the kernels and runs ``examples_phase``
    alone."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(card_line())
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}')
    t0 = time.perf_counter()
    _build.build_all(_build.HOST_SOURCES)
    _build.build_all()
    examples_phase()
    log(f'[examples] total {time.perf_counter() - t0:.1f} s')
    return 0


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device visible', file=sys.stderr)
        return 2
    if sys.argv[1:2] == ['--rank']:
        return rank_main(*sys.argv[2:5])
    if sys.argv[1:2] == ['--compare']:
        return compare(sys.argv[2] if len(sys.argv) > 2 else 'this tree',
                       tuple(sys.argv[3:]) or COMPARE_GROUPS)
    if sys.argv[1:2] == ['--examples']:
        return examples_only()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'{torch.cuda.get_device_name(0)}')
    t0 = time.perf_counter()
    host_s = _build.build_all(_build.HOST_SOURCES)
    log(f'build: {_build.build_all():.1f} s for {len(_build.SOURCES)} '
        f'sources (nvcc), {host_s:.1f} s for the host library '
        '(csrc/core.cpp, g++)')

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
    large = Scene(*LARGE, 'cuda', LARGE_SCALE)
    for name, err in forward_checks(large)[0].items():
        errs[name] = max(errs[name], err)
    for sc in (*scenes, large):
        forward_counts(sc)
        backward_counts(sc)
    for name, err in backward_phases(large)[0].items():
        errs[name] = max(errs[name], err)
    del large
    tex_errs, tex_times = texture_phases(tsc)
    errs.update(tex_errs)
    m3_errs, m3_times, prepass_ms = metrics_kernel_phases()
    errs.update(m3_errs)
    d4 = kt.utils.interop.deftet_scene(seed=SEED, side=D4_SIDE,
                                       num_faces=D4_FACES)
    d4_errs, d4_times = deftet_kernel_phases(d4)
    errs.update(d4_errs)
    spc5 = kt.utils.interop.sphere_shell_spc(level=C5_LEVEL, n=C5_N,
                                             seed=SEED, radius=C5_RADIUS)
    rays5 = kt.render.spc.generate_primary_rays(C5_RES, C5_RES, *C5_CAM)
    c5_errs, c5_times = traverse_kernel_phases(spc5, rays5)
    errs.update(c5_errs)

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
    ms = textured_step_ms(tsc)
    tex_per_frame = ms / tsc.batch
    profile_calls('[textured] profile train step', lambda: tsc.train(1), ms,
                  watch=('interleave_kernel', 'grid_sample_fwd_kernel'))

    m3_launches, m3_ms = metrics_path()
    for name in ('nearest_idx_pruned', 'p2m_select'):
        launches[name] = m3_launches[name]
    log(f'[config3] the pruned prepass alone: {prepass_ms:.4f} ms, twice '
        f'per step: {2. * prepass_ms / m3_ms:.3f} of the step')
    launches['nearest_idx'] = mesh_fit_path()['nearest_idx']
    d4_launches, d4_ms = deftet_path(d4)
    launches['deftet_topk'] = d4_launches['deftet_topk']
    c5_launches, c5_ms, hits5 = raytrace_path(spc5, rays5)
    launches['traverse'] = c5_launches['traverse']

    check_against_cpu()
    check_textured_against_cpu()
    check_metrics_against_cpu()
    fit()
    check_texture_fits()
    check_sign_phase()
    sdf_phase()
    check_deftet_against_cpu()
    check_tets_against_cpu()
    check_pack_ops_against_cpu(hits5)
    mod_times, _ = module_phases(rays5)
    par1_times = parallel_world1(scenes[0])
    par2_backend, par2_times = parallel_world2(scenes)
    io_phase(scenes[0])
    usd_phase(scenes[1])
    examples_phase()

    main = scenes[0]
    rows = []
    for name, (source, replaces) in KERNELS.items():
        t = (tex_times.get(name) or m3_times.get(name)
             or d4_times.get(name) or c5_times.get(name) or dict(
                 times[main.name][name], library_ms=None,
                 shape=f'batch {main.batch}, {main.num_faces} faces, '
                       f'{H}x{W}'))
        rows.append(dict(name=name, route='cuda', source=source,
                         replaces=replaces,
                         launches=launches[COUNTER_OF.get(name, name)],
                         max_abs_err=errs[name], ms=t['ms'],
                         plain_ms=t['plain_ms'], bound_ms=t['bound_ms'],
                         bound_by=t['bound_by'], library_ms=t['library_ms'],
                         shape=t['shape'],
                         **{k: t[k] for k in ('device_ms', 'library_device_ms',
                                              'cull_skipped', 'scanned',
                                              'cube_pairs',
                                              'launches_per_call',
                                              'library_mm_ms',
                                              'fscore_ms',
                                              'fscore_device_ms',
                                              'fscore_bound_ms',
                                              'fscore_library_ms',
                                              'fscore_library_mm_ms',
                                              'chamfer2048_ms',
                                              'chamfer2048_device_ms',
                                              'chamfer2048_bound_ms')
                            if k in t}))
    expect(all(row['launches'] > 0 for row in rows),
           'a kernel of the kernels line was launched on no path')
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
    log(json.dumps({'metric': 'deftet_64x64_10kfaces', 'value': d4_ms,
                    'unit': 'ms/iter'}))
    log(card)
    log(json.dumps({'metric': 'spc_raytrace_256_L8', 'value': c5_ms,
                    'unit': 'ms/trace'}))
    log(card)
    for name in ('fwd', 'fwdbwd'):
        t = mod_times['sg'][name]
        log(json.dumps({'metric': f'sg_reduced_inner_{SG_QUERIES}x'
                                  f'{SG_LIGHTS}_{name}', 'value': t['ms'],
                        'unit': 'ms/iter', 'pairs_per_s': t['pairs_per_s']}))
        log(card)
    log(json.dumps({'kernels': rows}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
