"""DIB-R inverse rendering: optimize mesh vertices + texture from
multiview silhouettes and images.

Reference: ``examples/tutorial/ian_dibr.py:373 train()`` /
``ian_fish_optimizer.py:61 train_fish()`` (fork layer): one train step
(render, image L1 + mask IoU + Laplacian, ``torch.optim.Adam``) in a
Python loop whose losses stay on the device until the end.

Run: ``python -m kaolin_tpu_torch.examples.dibr_train [--steps N]
[--res R] [--views V] [--device cpu]``.
"""

import argparse
import math
import time

import numpy as np
import torch

from .. import metrics, ops
from ..render import camera as kcam
from ..render import mesh as kmesh
from ..render.mesh.utils import _clip
from ..utils.interop import icosphere as _icosphere
from . import utils
from .spline_mesh import spline_body_mesh  # noqa: F401 (example export)


def icosphere(subdiv=2):
    return _icosphere(subdiv)


def make_cameras(num_views, r=3., fovy=math.pi / 4., device='cuda'):
    device = utils.check_device(device)
    angles = np.linspace(0., 2 * np.pi, num_views, endpoint=False)
    eye = np.stack([r * np.sin(angles), 0.4 * np.ones_like(angles),
                    r * np.cos(angles)], -1)
    rot, trans = kcam.generate_rotate_translate_matrices(
        torch.as_tensor(eye.astype(np.float32), device=device),
        torch.zeros((num_views, 3), device=device),
        torch.tensor([[0., 1., 0.]], device=device))
    proj = kcam.generate_perspective_projection(fovy, device=device)
    return rot, trans, proj


def render_views(vertices, faces, face_uvs, texture_map, cam_rot,
                 cam_trans, cam_proj, res, sigmainv=7000):
    B = cam_rot.shape[0]
    fvc, fvi, fn = kmesh.prepare_vertices(
        vertices.expand(B, *vertices.shape[1:]), faces, cam_proj,
        camera_rot=cam_rot, camera_trans=cam_trans)
    attrs = [face_uvs.expand(B, *face_uvs.shape[1:]),
             torch.ones((B, faces.shape[0], 3, 1), dtype=fvc.dtype,
                        device=fvc.device)]
    (tex_coords, mask), soft_mask, _ = kmesh.dibr_rasterization(
        res, res, fvc[..., 2], fvi, attrs, fn[..., 2], sigmainv=sigmainv)
    image = kmesh.texture_mapping(
        tex_coords, texture_map.expand(B, *texture_map.shape[1:]),
        mode='bilinear')
    image = _clip(image * mask, 0., 1.)
    return image, soft_mask


def main(steps=150, res=256, num_views=4, laplacian_weight=0.03,
         lr=5e-3, device='cuda'):
    device = utils.check_device(device)
    verts_np, faces_np = icosphere(2)
    faces = torch.as_tensor(faces_np, device=device)
    cam_rot, cam_trans, cam_proj = make_cameras(num_views, device=device)

    # spherical UVs + a striped target texture
    theta = np.arctan2(verts_np[:, 0], verts_np[:, 2])
    phi = np.arcsin(np.clip(verts_np[:, 1], -1, 1))
    uvs = torch.as_tensor(np.stack([(theta / (2 * np.pi) + 0.5),
                                    (phi / np.pi + 0.5)], -1)
                          .astype(np.float32), device=device)[None]
    face_uvs = ops.mesh.index_vertices_by_faces(uvs, faces)
    tex = np.ones((1, 3, 64, 64), np.float32)
    tex[:, 0, ::8] = 0.1
    target_texture = torch.as_tensor(tex, device=device)

    # target: squashed sphere with the striped texture
    target_vertices = torch.as_tensor(
        (verts_np[None] * np.array([0.6, 1.0, 0.8])).astype(np.float32),
        device=device)
    with torch.no_grad():
        target_images, target_masks = render_views(
            target_vertices, faces, face_uvs, target_texture, cam_rot,
            cam_trans, cam_proj, res)

    # parameters: vertices + texture
    laplacian = ops.mesh.uniform_laplacian(verts_np.shape[0], faces,
                                           device=device)
    params = {
        'vertices': torch.as_tensor(verts_np[None], device=device)
        .clone().requires_grad_(True),
        'texture': torch.full((1, 3, 64, 64), 0.5, device=device)
        .requires_grad_(True),
    }
    opt = torch.optim.Adam(list(params.values()), lr=lr)

    def loss_fn(p):
        images, soft_masks = render_views(
            p['vertices'], faces, face_uvs, p['texture'], cam_rot,
            cam_trans, cam_proj, res)
        image_loss = torch.mean(torch.abs(images - target_images))
        mask_loss = metrics.render.mask_iou(soft_masks, target_masks)
        lap_loss = torch.mean((laplacian @ p['vertices'][0]) ** 2)
        return image_loss + mask_loss + laplacian_weight * lap_loss

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    losses = torch.stack(losses).cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"{steps} steps x {num_views} views at {res}x{res} "
          f"in {dt:.1f}s ({dt / steps * 1000:.1f} ms/step)")
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f}")

    # final chamfer vs the target surface
    with torch.no_grad():
        pts_opt, _ = utils.sample_points(
            params['vertices'], faces, 2048, torch.Generator().manual_seed(0))
        pts_tgt, _ = utils.sample_points(
            target_vertices, faces, 2048, torch.Generator().manual_seed(1))
        cd = float(metrics.pointcloud.chamfer_distance(pts_opt, pts_tgt)[0])
    print(f"chamfer distance to target: {cd:.5f}")
    return losses, cd


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--steps', type=int, default=150)
    p.add_argument('--res', type=int, default=256)
    p.add_argument('--views', type=int, default=4)
    p.add_argument('--device', default='cuda')
    args = p.parse_args()
    main(steps=args.steps, res=args.res, num_views=args.views,
         device=args.device)
