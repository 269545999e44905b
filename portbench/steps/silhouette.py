"""The DIB-R silhouette fit step (``bench_suite.py``'s face sweep):
``prepare_vertices`` with the legacy look-at camera, then
``dibr_rasterization`` (the z-buffer with back faces culled, and the soft
mask) of a one-channel per-vertex feature; L1 of the features against a
target image plus ``mask_iou`` against a target silhouette. Gradients to
the vertices.

Keys read from the configuration: ``subdiv``, ``height``, ``width``,
``fovy``, ``camera_ring`` (radius, height), ``vertex_jitter``,
``sigmainv``, ``boxlen``, ``knum``, ``target_axes``; from the traffic
mix: ``batch``.
"""

import torch

from .. import scene
from ..reference import render as ref

LEAVES = ('vertices',)
KERNELS = ('rasterize', 'rasterize_bwd', 'soft_mask', 'soft_mask_bwd')
SOURCES = ('rasterize', 'rasterize_bwd', 'soft_mask')
BATCH_INPUTS = ('face_gray', 'rot', 'trans', 'target_feat', 'target_mask')


def make_inputs(config, traffic, seed, device):
    B = traffic['batch']
    H, W = config['height'], config['width']
    gen = scene.generator(seed, device)
    base, faces = scene.icosphere(config['subdiv'], device)
    radius, height = config['camera_ring']
    eyes = scene.ring_eyes(B, radius, height, gen, device)
    up = torch.tensor([[0., 1., 0.]], device=device).expand(B, 3)
    rot, trans = ref.lookat_legacy(eyes, torch.zeros_like(eyes), up)
    verts = scene.bumpy_copies(base, B, config['vertex_jitter'], gen)
    gray = torch.rand((B, base.shape[0], 1), generator=gen, device=device)
    mask = scene.ellipse_masks(B, H, W, config['target_axes'], gen, device)
    shade = scene.smooth_images(B, 1, H, W, gen, device)
    return dict(faces=faces, face_gray=gray[:, faces], rot=rot, trans=trans,
                proj=ref.perspective(config['fovy'], torch.float32, device),
                target_mask=mask, target_feat=shade * mask[..., None],
                height=H, width=W, sigmainv=config['sigmainv'],
                boxlen=config['boxlen'], knum=config['knum'],
                leaves=dict(vertices=verts))


def program_loss(inp, leaves, fault=None, mesh=None):
    """The loss through the measured package; ``fault`` as in
    ``steps.textured.program_loss`` (one process: ``mesh`` is None)."""
    from kaolin_tpu_torch.metrics.render import mask_iou
    from kaolin_tpu_torch.render.mesh import (dibr_rasterization,
                                              prepare_vertices)
    verts = leaves['vertices']
    keys = ('face_gray', 'rot', 'trans', 'target_feat', 'target_mask')
    gray, rot, trans, tfeat, tmask = (inp[k] for k in keys)
    if fault == 'half_batch':
        half = verts.shape[0] // 2
        verts, gray, rot, trans, tfeat, tmask = (
            t[:half] for t in (verts, gray, rot, trans, tfeat, tmask))
    fvc, fvi, fn = prepare_vertices(verts, inp['faces'], inp['proj'],
                                    camera_rot=rot, camera_trans=trans)
    feat, mask, _ = dibr_rasterization(
        inp['height'], inp['width'], fvc[..., 2], fvi, gray, fn[..., 2],
        sigmainv=inp['sigmainv'], boxlen=inp['boxlen'], knum=inp['knum'])
    if fault == 'altered':
        keep = torch.ones_like(mask[:, :1, :1])
        keep[0] = 0.
        feat, mask = feat * keep[..., None], mask * keep
    return torch.mean(torch.abs(feat - tfeat)) + mask_iou(mask, tmask)


def reference_loss(inp, leaves, rows, batch):
    """The plain reference's share of the loss from the objects ``rows``
    (their leaves given) of a batch of ``batch``."""
    verts = leaves['vertices']
    H, W = inp['height'], inp['width']
    vc = ref.world_to_camera_legacy(inp['rot'][rows], inp['trans'][rows],
                                    verts)
    vi = ref.project(vc, inp['proj'])
    fvc, fvi = vc[:, inp['faces']], vi[:, inp['faces']]
    fn = ref.face_normals_unit(fvc)
    face_idx = ref.select_faces(fvc[..., 2], fvi, fn[..., 2] >= 0, H, W)
    feat = ref.interpolate(face_idx, fvi, inp['face_gray'][rows])
    mask = ref.soft_mask(fvi, face_idx, inp['sigmainv'], inp['boxlen'],
                         inp['knum'])
    l1 = torch.abs(feat - inp['target_feat'][rows])
    iou = ref.mask_iou_terms(mask, inp['target_mask'][rows])
    return (l1.sum() / (batch * l1[0].numel())
            + (iou.numel() - iou.sum()) / batch)


def bound_inputs(inp, leaves):
    with torch.no_grad():
        vc = ref.world_to_camera_legacy(inp['rot'], inp['trans'],
                                        leaves['vertices'])
        vi = ref.project(vc, inp['proj'])
        fvc, fvi = vc[:, inp['faces']], vi[:, inp['faces']]
        fn = ref.face_normals_unit(fvc)
        valid = fn[..., 2] >= 0
        face_idx = ref.select_faces(fvc[..., 2], fvi, valid, inp['height'],
                                    inp['width'])
    return dict(face_image=fvi, valid=valid, face_idx=face_idx, feat_dim=1,
                boxlen=inp['boxlen'], knum=inp['knum'])
