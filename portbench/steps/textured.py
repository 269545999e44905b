"""The textured DIB-R fit step (``BASELINE.json`` config 2): 6-DoF
cameras, perspective projection, ``rasterize`` of [face UVs, normal z]
with back faces culled, bilinear ``texture_mapping`` shaded by
``clamp(normal z, 0, 1)``, L1 against the target images; gradients to the
vertices, the textures and the cameras.

Keys read from the configuration: ``subdiv``, ``height``, ``width``,
``texture_size``, ``fovy``, ``camera_ring`` (radius, height),
``vertex_jitter``; from the traffic mix: ``batch``.
"""

import torch

from .. import scene
from ..reference import render as ref

LEAVES = ('vertices', 'texture', 'cam_params')
KERNELS = ('rasterize', 'rasterize_bwd', 'grid_sample', 'grid_sample_bwd')
SOURCES = ('rasterize', 'rasterize_bwd', 'grid_sample')
BATCH_INPUTS = ('face_uvs', 'target')


def make_inputs(config, traffic, seed, device):
    """The scene of one seed: fixed inputs and the leaves' first values."""
    B = traffic['batch']
    H, W, T = config['height'], config['width'], config['texture_size']
    gen = scene.generator(seed, device)
    base, faces = scene.icosphere(config['subdiv'], device)
    radius, height = config['camera_ring']
    eyes = scene.ring_eyes(B, radius, height, gen, device)
    up = torch.tensor([[0., 1., 0.]], device=device).expand(B, 3)
    cams = ref.lookat_6dof(eyes, torch.zeros_like(eyes), up)
    verts = scene.bumpy_copies(base, B, config['vertex_jitter'], gen)
    texture = torch.rand((B, 3, T, T), generator=gen, device=device)
    uvs = torch.rand((B, base.shape[0], 2), generator=gen, device=device)
    target = scene.smooth_images(B, 3, H, W, gen, device)
    return dict(faces=faces, face_uvs=uvs[:, faces],
                proj=ref.perspective(config['fovy'], torch.float32, device),
                target=target, height=H, width=W,
                leaves=dict(vertices=verts, texture=texture,
                            cam_params=cams))


def program_loss(inp, leaves, fault=None, mesh=None):
    """The loss through the measured package. ``fault`` plants a fault for
    the benchmark's own checks: 'half_batch' takes the mean over the first
    half of the batch only; 'altered' zeroes the first image where it is
    produced; on a ``mesh`` of ranks, 'no_exchange' renders this rank's
    objects without the sharded path's all-reduce of the gradients.

    On a ``mesh`` (axes data x pix), every rank prepares the faces of the
    whole batch and ``sharded_rasterize`` renders its block; the textures
    pass through ``replicate`` so that their gradients are summed over the
    ranks too, and the loss is the ranks' sum (``mesh_sum``)."""
    from kaolin_tpu_torch.ops.mesh import face_normals, index_vertices_by_faces
    from kaolin_tpu_torch.render.camera import (CameraExtrinsics,
                                                perspective_camera)
    from kaolin_tpu_torch.render.mesh import rasterize, texture_mapping
    verts, tex, cams = (leaves[k] for k in LEAVES)
    uvs, target = inp['face_uvs'], inp['target']
    if fault == 'half_batch':
        half = verts.shape[0] // 2
        verts, tex, cams, uvs, target = (t[:half] for t in
                                         (verts, tex, cams, uvs, target))
    faces = inp['faces']
    ext = CameraExtrinsics(cams, backend='matrix_6dof_rotation')
    vc = ext.transform(verts)
    vi = perspective_camera(vc, inp['proj'])
    fvc = index_vertices_by_faces(vc, faces)
    fvi = index_vertices_by_faces(vi, faces)
    fn = face_normals(fvc, unit=True)
    nz = fn[:, :, None, 2:].expand(fvc.shape[:3] + (1,))
    faces_in = (fvc[..., 2], fvi, uvs, nz, fn[..., 2] >= 0)
    H, W = inp['height'], inp['width']
    if mesh is not None:
        from kaolin_tpu_torch.parallel import sharded_rasterize
        from kaolin_tpu_torch.parallel.mesh import replicate
        rows = rank_rows(mesh, verts.shape[0])
        target = target[rows]
    if mesh is None or fault == 'no_exchange':
        if mesh is not None:
            tex = tex[rows]
            faces_in = tuple(t[rows] for t in faces_in)
        z, img_v, f_uv, f_nz, valid = faces_in
        (uv_map, nz_map), _ = rasterize(H, W, z, img_v, [f_uv, f_nz], valid)
    else:
        z, img_v, f_uv, f_nz, valid = faces_in
        tex = replicate(mesh, tex)[0][rows]
        (uv_map, nz_map), _ = sharded_rasterize(mesh, H, W, z, img_v,
                                                [f_uv, f_nz], valid)
    img = texture_mapping(uv_map, tex, mode='bilinear')
    img = img * torch.clamp(nz_map, 0., 1.)
    if fault == 'altered':
        keep = torch.ones_like(img[:, :1, :1, :1])
        keep[0] = 0.
        img = img * keep
    if mesh is None:
        return torch.mean(torch.abs(img - target))
    from kaolin_tpu_torch.parallel.mesh import mesh_sum
    total = torch.abs(img - target).sum()
    if fault != 'no_exchange':
        total = mesh_sum(mesh, total)
    return total / (verts.shape[0] * img[0].numel())


def rank_rows(mesh, batch):
    """This rank's objects on the mesh's data axis."""
    from kaolin_tpu_torch.parallel.mesh import axis
    n, i = axis(mesh, 'data')
    per = batch // n
    return slice(i * per, (i + 1) * per)


def reference_loss(inp, leaves, rows, batch):
    """The plain reference's share of the loss from the objects ``rows``
    of a batch of ``batch`` (the loss is a sum of such shares)."""
    verts, tex, cams = (leaves[k] for k in LEAVES)
    faces, H, W = inp['faces'], inp['height'], inp['width']
    vc = ref.world_to_camera_6dof(cams, verts)
    vi = ref.project(vc, inp['proj'])
    fvc, fvi = vc[:, faces], vi[:, faces]
    fn = ref.face_normals_unit(fvc)
    nz = fn[:, :, None, 2:].expand(fvc.shape[:3] + (1,))
    feats = torch.cat([inp['face_uvs'][rows], nz], -1)
    face_idx = ref.select_faces(fvc[..., 2], fvi, fn[..., 2] >= 0, H, W)
    maps = ref.interpolate(face_idx, fvi, feats)
    img = ref.bilinear(maps[..., :2], tex) * torch.clamp(maps[..., 2:], 0.,
                                                         1.)
    diff = torch.abs(img - inp['target'][rows])
    return diff.sum() / (batch * diff[0].numel())


def bound_inputs(inp, leaves):
    """What the kernels' bounds count, from the leaves as they stand:
    per kernel a dict of counts (see ``portbench/bounds``)."""
    with torch.no_grad():
        verts, tex, cams = (leaves[k] for k in LEAVES)
        vc = ref.world_to_camera_6dof(cams, verts)
        vi = ref.project(vc, inp['proj'])
        fvc, fvi = vc[:, inp['faces']], vi[:, inp['faces']]
        fn = ref.face_normals_unit(fvc)
        valid = fn[..., 2] >= 0
        face_idx = ref.select_faces(fvc[..., 2], fvi, valid, inp['height'],
                                    inp['width'])
    return dict(face_image=fvi, valid=valid, face_idx=face_idx,
                feat_dim=3, texture=tuple(tex.shape))
