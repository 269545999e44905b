"""Parametric fish photo-fitting — the fork's flagship application.

Behavioral reference: ``examples/tutorial/ian_fish_body_mesh.py``,
``ian_fish_fin_mesh.py``, ``ian_fish_texture.py``,
``ian_fish_optimizer.py``, ``ian_cubic_spline_optimizer.py``.

The fish is a flat "card" body (roots swept along a learnable segment,
top/bottom silhouettes given by learnable cubic Hermite splines, z = 0)
plus fins grown from learnable uv-anchored root curves on the body, all
fitted to a single photo via DIB-R soft-silhouette, root-position, and
image losses.

Every mesh is a function of a parameter dict of tensors; each training
stage is a loop of ``torch.optim.Adam`` steps under a ``StepLR``
schedule, and the staged schedule (body -> fins -> texture) is explicit
in ``fit_fish``. The losses stay on the device and are read once a
stage. Run the synthetic self-fit with
``python -m kaolin_tpu_torch.examples.fish [--res R] [--epochs N]
[--device cpu]``.
"""

import json
import math

import numpy as np
import torch

from .. import ops
from ..render import camera as kcam
from ..render import mesh as kmesh
from ..render.mesh.utils import _clip
from ..casts import to_int
from . import utils
from .spline import interp_func_with_tangent

__all__ = [
    'make_spline', 'spline_ys', 'negative_ys_loss',
    'card_topology', 'make_body_params', 'fish_body_vertices',
    'position_by_uv', 'make_fin_params', 'fish_fin_vertices',
    'uv_bound_loss', 'uv_grid_boxes', 'FishMesh', 'fish_params_to_json',
    'fish_params_from_json', 'fit_fish', 'params_from_numpy',
    'texture_from_numpy', 'synthetic_data', 'self_fit_hyper',
    'synthetic_self_fit', 'body_iou',
]


def _f32(x, device):
    return torch.as_tensor(np.array(x, np.float32), device=device)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------- splines

def make_spline(key_size, init_ys=1.0, device='cuda'):
    """Learnable cubic Hermite spline over fixed knots x in [0, 1]
    (``ian_cubic_spline_optimizer.py:31``)."""
    device = utils.check_device(device)
    return {
        'key_ys': torch.full((key_size,), float(init_ys),
                             dtype=torch.float32, device=device),
        'key_ts': torch.zeros((key_size,), dtype=torch.float32,
                              device=device),
    }


def spline_ys(spline, sample_xs):
    ys = spline['key_ys']
    key_xs = utils.linspace(0., 1., ys.shape[0], ys.device)
    return interp_func_with_tangent(key_xs, ys, spline['key_ts'], sample_xs)


def spline_ys_lod(spline, lod_x):
    return spline_ys(spline, utils.linspace(0., 1., lod_x,
                                            spline['key_ys'].device))


def negative_ys_loss(spline, lod_x):
    """mean(exp(-ys)) — pushes silhouette heights positive
    (``ian_cubic_spline_optimizer.py:138``)."""
    return torch.mean(torch.exp(-spline_ys_lod(spline, lod_x)))


# ----------------------------------------------------------- card topology

def card_topology(lod_x, lod_y):
    """Faces + uv grid of an (lod_x columns) x (lod_y rows) card.

    Vertex v-fastest layout ``col * lod_y + row`` with the reference's
    quad split ([a, a+lod_y, a+1], [a+1, a+lod_y, a+lod_y+1];
    ``ian_fish_body_mesh.py:285-296``). Host-side static topology.
    """
    i, j = np.meshgrid(np.arange(lod_x - 1), np.arange(lod_y - 1),
                       indexing='ij')
    a = (i * lod_y + j).ravel()
    tri1 = np.stack([a, a + lod_y, a + 1], -1)
    tri2 = np.stack([a + 1, a + lod_y, a + lod_y + 1], -1)
    faces = np.stack([tri1, tri2], 1).reshape(-1, 3).astype(np.int64)
    u = np.repeat(np.arange(lod_x) / (lod_x - 1), lod_y)
    v = np.tile(np.arange(lod_y) / (lod_y - 1), lod_x)
    uvs = np.stack([u, v], -1).astype(np.float32)
    return faces, uvs[None], faces.copy()   # faces, uvs, face_uvs_idx


# ------------------------------------------------------------------- body

def make_body_params(key_size, init_height=1.0, device='cuda'):
    """Learnable: origin_xy, length_x, two silhouette splines. origin_z
    and length_y/z stay fixed at 0 (``ian_fish_body_mesh.py:68-74``)."""
    device = utils.check_device(device)
    return {
        'origin_xy': torch.tensor([-1., 0.], device=device),
        'length_x': torch.tensor(2., device=device),
        'top_spline': make_spline(key_size, init_height, device),
        'bottom_spline': make_spline(key_size, init_height, device),
    }


def _body_endpoints(params):
    origin = params['origin_xy']
    start = torch.cat([origin, origin.new_zeros(1)])
    zero = params['length_x'].new_zeros(())
    length = torch.stack([params['length_x'], zero, zero])
    return start, start + length


def fish_body_vertices(params, lod_x, lod_y):
    """(1, lod_x*lod_y, 3) card vertices: columns sweep the root
    segment; each column spans root - (0, bottom, 0) ->
    root + (0, top, 0) (``ian_fish_body_mesh.py:246-281``)."""
    start, end = _body_endpoints(params)
    dev = start.device
    frac_x = utils.linspace(0., 1., lod_x, dev)[:, None]
    roots = start + frac_x * (end - start)                 # (lod_x, 3)
    top = spline_ys_lod(params['top_spline'], lod_x)
    bottom = spline_ys_lod(params['bottom_spline'], lod_x)
    zero = torch.zeros_like(top)
    yoff = torch.stack([zero, top, zero], -1)
    boff = torch.stack([zero, -bottom, zero], -1)
    lo = roots + boff                                      # (lod_x, 3)
    hi = roots + yoff
    frac_y = utils.linspace(0., 1., lod_y, dev)[None, :, None]
    verts = lo[:, None, :] + frac_y * (hi - lo)[:, None, :]
    return verts.reshape(1, lod_x * lod_y, 3)


def _take(rows, idx):
    """``rows[idx]`` as JAX indexes: a negative index counts from the end,
    then every index is clamped to the rows (a uv outside [0, 1] reads
    the border)."""
    n = rows.shape[0]
    return rows[torch.where(idx < 0, idx + n, idx).clamp(0, n - 1).long()]


def position_by_uv(vertices, lod_x, lod_y, uvs):
    """Bilinear body-surface positions at uv in [0,1]^2
    (``ian_fish_body_mesh.py:194-213``). ``uvs``: (K, 2) -> (K, 3)."""
    flat = vertices[0]
    lu = uvs[:, 0] * (lod_x - 1)
    lv = uvs[:, 1] * (lod_y - 1)
    fu = to_int(torch.floor(lu), torch.int32)
    cu = to_int(torch.ceil(lu), torch.int32)
    fv = to_int(torch.floor(lv), torch.int32)
    cv = to_int(torch.ceil(lv), torch.int32)
    ou = (lu - fu)[:, None]
    ov = (lv - fv)[:, None]
    bl = _take(flat, fu * lod_y + fv)
    tl = _take(flat, fu * lod_y + cv)
    br = _take(flat, cu * lod_y + fv)
    tr = _take(flat, cu * lod_y + cv)
    left = bl + (tl - bl) * ov
    right = br + (tr - br) * ov
    return left + (right - left) * ou


# -------------------------------------------------------------------- fins

def make_fin_params(key_size, start_uv=(0.5, 0.5), end_uv=(0.5, 0.5),
                    init_height=0.2, device='cuda'):
    """Learnable: root-curve uv anchors, growth angles, silhouette
    spline (``ian_fish_fin_mesh.py:38-115``)."""
    device = utils.check_device(device)
    return {
        'start_uv': _f32(start_uv, device),
        'end_uv': _f32(end_uv, device),
        'start_dir': torch.zeros((1,), dtype=torch.float32, device=device),
        'end_dir': torch.zeros((1,), dtype=torch.float32, device=device),
        'sil_spline': make_spline(key_size, init_height, device),
    }


def _fin_root_uvs(params, lod_x):
    s = _clip(params['start_uv'], 0., 1.)
    e = _clip(params['end_uv'], 0., 1.)
    return s + utils.linspace(0., 1., lod_x, s.device)[:, None] * (e - s)


def fish_fin_vertices(params, body_vertices, body_lod, lod_x, lod_y,
                      z_scale=0.):
    """(1, lod_x*lod_y, 3) fin strip grown from the body surface.

    Root points sample the body at uv between start_uv and end_uv;
    growth directions are the xy-perpendicular of the root tangent
    scaled by the silhouette spline, rotated in-plane by angles lerped
    start_dir -> end_dir (``ian_fish_fin_mesh.py:315-404``). The first
    column keeps the reference's seam semantics: its growth vector is
    the raw (unscaled) first tangent. ``z_scale`` (a float or a tensor)
    adds sideways growth (the reference's pectoral-fin ``z_scale``
    attribute).
    """
    root_uvs = _fin_root_uvs(params, lod_x)
    dev = root_uvs.device
    roots = position_by_uv(body_vertices, body_lod[0], body_lod[1],
                           root_uvs)                        # (lod_x, 3)
    ys = spline_ys_lod(params['sil_spline'], lod_x)
    tang = roots[1:] - roots[:-1]                           # (lod_x-1, 3)
    perp = torch.stack([-tang[:, 1], tang[:, 0],
                        torch.zeros_like(tang[:, 0])], -1)
    # safe normalize: rsqrt(max(n2, eps)) keeps the gradient finite at
    # zero-length tangents (degenerate start_uv == end_uv inits NaN
    # through a norm's backward otherwise)
    n2 = torch.sum(perp * perp, -1, keepdim=True)
    perp = perp * torch.rsqrt(torch.maximum(n2, n2.new_full((), 1e-24)))
    # the xy-perpendicular has z = 0, so z is always ys * z_scale
    # (identically 0 without a z_scale, as in the reference)
    grow = torch.stack([perp[:, 0] * ys[1:], perp[:, 1] * ys[1:],
                        ys[1:] * z_scale], -1)
    grow = torch.cat([tang[:1], grow], 0)                   # (lod_x, 3)
    angles = (params['start_dir']
              + utils.linspace(0., 1., lod_x, dev)[:, None]
              * (params['end_dir'] - params['start_dir']))[:, 0]
    ca, sa = torch.cos(angles), torch.sin(angles)
    grow = torch.stack([grow[:, 0] * ca - grow[:, 1] * sa,
                        grow[:, 0] * sa + grow[:, 1] * ca,
                        grow[:, 2]], -1)
    frac_y = utils.linspace(0., 1., lod_y, dev)[None, :, None]
    verts = roots[:, None, :] + frac_y * grow[:, None, :]
    return verts.reshape(1, lod_x * lod_y, 3)


def uv_bound_loss(params):
    """Squared penalty for uv anchors outside [0, 1]
    (``ian_fish_fin_mesh.py:207-228``)."""
    def exceed(uv):
        return (torch.sum(torch.square(torch.relu(uv - 1.)))
                + torch.sum(torch.square(torch.relu(-uv))))
    return exceed(params['start_uv']) + exceed(params['end_uv'])


# ------------------------------------------------------------- uv atlasing

def uv_grid_boxes(n_meshes):
    """Square-grid texture-atlas boxes (u0, v0, size, size)
    (``ian_fish_optimizer.py:243-254``)."""
    g = math.ceil(math.sqrt(n_meshes))
    s = 1. / g
    return [(u * s, v * s, s, s)
            for u in range(g) for v in range(g)][:n_meshes]


class FishMesh:
    """Adapter exposing the Renderer mesh protocol (vertices, faces,
    face_uvs, texture_map) over a generated card; every tensor on the
    vertices' device."""

    def __init__(self, vertices, faces, uvs, face_uvs_idx, uv_box=None):
        dev = vertices.device
        self.vertices = vertices
        self.faces = torch.as_tensor(faces, device=dev)
        uvs = torch.as_tensor(uvs, device=dev)
        if uv_box is not None:
            u0, v0, su, sv = uv_box
            uvs = uvs * _f32([su, sv], dev) + _f32([u0, v0], dev)
        self.uvs = uvs
        self.face_uvs_idx = torch.as_tensor(face_uvs_idx, device=dev)
        self.face_uvs = ops.mesh.index_vertices_by_faces(
            uvs, self.face_uvs_idx)
        self.texture_map = None


# ---------------------------------------------------------------- json i/o

def _tolist(tree):
    """Nested lists, the dicts' keys sorted as JAX's tree_map sorts them."""
    if isinstance(tree, dict):
        return {k: _tolist(tree[k]) for k in sorted(tree)}
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy().tolist()
    return np.asarray(tree).tolist()


def fish_params_to_json(path, body, fins, hyper=None):
    """Exports body/fin parameter dicts (+hyperparameters) to JSON
    (``ian_fish_optimizer.py:609-625``), in the layout the JAX example
    reads and writes."""
    with open(path, 'w') as f:
        json.dump({'body': _tolist(body), 'fins': _tolist(fins),
                   'hyperparameter': hyper or {}}, f, indent=1)


def fish_params_from_json(path, device='cuda'):
    device = utils.check_device(device)
    with open(path) as f:
        blob = json.load(f)

    def astensors(tree):
        return _tree_map(lambda x: _f32(x, device), tree)

    return (astensors(blob['body']), astensors(blob['fins']),
            blob.get('hyperparameter', {}))


def params_from_numpy(params, device='cuda'):
    """A body or fin parameter dict (or a dict of fin dicts) as numpy
    arrays — the JAX example's, through ``np.asarray`` — as float32
    tensors on ``device``."""
    device = utils.check_device(device)
    return _tree_map(lambda x: _f32(x, device), params)


def texture_from_numpy(texture, device='cuda'):
    """A (1, 3, R, R) texture as a float32 tensor on ``device``."""
    return _f32(texture, utils.check_device(device))


# ----------------------------------------------------------------- fitting

def _view(meta, device):
    transform = utils.get_camera_transform_from_view(
        meta['cam_elev'], meta['cam_azim'], meta['cam_radius'],
        meta['cam_look_at_height'], device=device)
    proj = utils.get_camera_projection(meta['cam_fovyangle'], device=device)
    return transform, proj


def _project_points(points, meta, view=None):
    """Projects (K, 3) world points to [0, 1]^2 image coords under the
    data view (``ian_renderer.py:project_vertices_with_camera_params``).
    ``view``: the (transform, projection) of ``meta``, when made already."""
    transform, proj = view or _view(meta, points.device)
    padded = torch.cat([points, points.new_ones(points.shape[0], 1)],
                       -1)[None]
    cam = torch.matmul(padded, transform)
    img = kcam.perspective_camera(cam, proj)[0]
    return (img + 1.) / 2.


def _render_soft_mask(verts, faces, meta, height, width, view=None):
    transform, proj = view or _view(meta, verts.device)
    faces = torch.as_tensor(faces, device=verts.device)
    fvc, fvi, fn = kmesh.prepare_vertices(verts, faces, proj,
                                          camera_transform=transform)
    attrs = [torch.ones((1, faces.shape[0], 3, 1), dtype=fvc.dtype,
                        device=fvc.device)]
    (feat,), soft_mask, face_idx = kmesh.dibr_rasterization(
        height, width, fvc[..., 2], fvi, attrs, fn[..., 2],
        sigmainv=meta['sigmainv'])
    return soft_mask, face_idx


def _train(params, loss_fn, epochs, lr, hyper):
    """``epochs`` Adam steps of ``loss_fn(params)`` on the leaves of the
    parameter dict under StepLR (optax's staircase exponential decay);
    returns the losses, read from the device once."""
    leaves = _leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=lr)
    sched = torch.optim.lr_scheduler.StepLR(
        opt, hyper.get('scheduler_step_size', 1000),
        hyper.get('scheduler_gamma', 0.99))
    losses = []
    for _ in range(epochs):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params)
        loss.backward()
        opt.step()
        sched.step()
        losses.append(loss.detach())
    for x in leaves:
        x.requires_grad_(False)
    return torch.stack(losses).tolist() if losses else []


def fit_fish(data, hyper, fin_z_scales=None, device='cuda'):
    """Staged single-view fish fit: body silhouette -> fins -> texture.

    ``data``: dict with 'rgb' (H, W, 3), 'body_mask' (H, W), per-fin
    '<fin>_mask', 'root_segmentation' {name: [[x0,y0],[x1,y1]] in [0,1]
    image coords}, and 'metadata' (cam_elev/azim/radius/look_at_height/
    fovyangle, sigmainv); arrays or tensors. Returns (body, fins,
    texture, history), the parameters as tensors on ``device``.
    """
    device = utils.check_device(device)
    meta = data['metadata']
    H, W = data['body_mask'].shape
    lod_x, lod_y = hyper['lod_x'], hyper['lod_y']
    key_size = hyper['key_size']
    fin_inits = hyper.get('fin_init_uv', {})
    fins = {name: make_fin_params(
                key_size, *fin_inits.get(name, ((0.4, 1.), (0.6, 1.))),
                init_height=hyper.get('fin_init_height', 0.2),
                device=device)
            for name in hyper['fin_list']}
    body = make_body_params(key_size, hyper.get('init_height', 1.0),
                            device)
    z_scales = fin_z_scales or {}
    faces_np, uvs_np, fuv_np = card_topology(lod_x, lod_y)
    faces = torch.as_tensor(faces_np, device=device)
    view = _view(meta, device)
    history = []

    def target(x):
        return torch.as_tensor(np.asarray(x.cpu() if torch.is_tensor(x)
                                          else x, np.float32),
                               device=device)

    # ---- stage 1: body (alpha + negative-ys + root-position losses)
    gt_mask = target(data['body_mask'])
    gt_roots = target(data['root_segmentation']['body_mask'])

    def body_loss(params):
        verts = fish_body_vertices(params, lod_x, lod_y)
        soft, _ = _render_soft_mask(verts, faces, meta, H, W, view)
        alpha = torch.mean(torch.abs(soft[0] - gt_mask))
        start, end = _body_endpoints(params)
        proj = _project_points(torch.stack([start, end]), meta, view)
        root_pos = (torch.mean(torch.abs(proj[0] - gt_roots[0]))
                    + torch.mean(torch.abs(proj[1] - gt_roots[1])))
        neg = (negative_ys_loss(params['top_spline'], lod_x)
               + negative_ys_loss(params['bottom_spline'], lod_x))
        return (alpha * hyper['alpha_weight']
                + neg * hyper['negative_ys_weight']
                + root_pos * hyper['root_pos_weight'])

    history += [('body', l) for l in _train(
        body, body_loss, hyper['body_epochs'],
        hyper.get('body_lr', 5e-3), hyper)]

    with torch.no_grad():
        body_verts = fish_body_vertices(body, lod_x, lod_y)

    # ---- stage 2: fins (alpha + negative-ys + uv-bound + root losses)
    def fin_loss(params, gt_fin_mask, gt_fin_roots, z_scale):
        verts = fish_fin_vertices(params, body_verts, (lod_x, lod_y),
                                  lod_x, lod_y, z_scale)
        soft, _ = _render_soft_mask(verts, faces, meta, H, W, view)
        alpha = torch.mean(torch.abs(soft[0] - gt_fin_mask))
        anchors = torch.stack([_clip(params['start_uv'], 0., 1.),
                               _clip(params['end_uv'], 0., 1.)])
        pos = position_by_uv(body_verts, lod_x, lod_y, anchors)
        proj = _project_points(pos, meta, view)
        root_pos = (torch.mean(torch.abs(proj[0] - gt_fin_roots[0]))
                    + torch.mean(torch.abs(proj[1] - gt_fin_roots[1])))
        return (alpha * hyper['alpha_weight']
                + negative_ys_loss(params['sil_spline'], lod_x)
                * hyper['negative_ys_weight']
                + uv_bound_loss(params) * hyper['fin_uv_bound_weight']
                + root_pos * hyper['root_pos_weight'])

    for name in hyper['fin_list']:
        gt_fin = target(data[name + '_mask'])
        gt_fr = target(data['root_segmentation'][name + '_mask'])
        zs = float(z_scales.get(name, 0.))
        history += [(name, l) for l in _train(
            fins[name],
            lambda p: fin_loss(p, gt_fin, gt_fr, zs),
            hyper['fin_epochs'], hyper.get('fin_lr', 5e-3), hyper)]

    # ---- stage 3: texture over the uv atlas (image L1)
    all_names = ['body'] + list(hyper['fin_list'])
    boxes = uv_grid_boxes(len(all_names))
    meshes = []
    with torch.no_grad():
        for name, box in zip(all_names, boxes):
            if name == 'body':
                verts = body_verts
            else:
                verts = fish_fin_vertices(
                    fins[name], body_verts, (lod_x, lod_y), lod_x, lod_y,
                    float(z_scales.get(name, 0.)))
            meshes.append(FishMesh(verts, faces_np, uvs_np, fuv_np, box))

    from .renderer import Renderer
    renderer = Renderer(1, (H, W))
    gt_rgb = target(data['rgb'])
    cam_t, cam_p = view
    res = hyper['texture_res']
    texture = {'texture': torch.ones((1, 3, res, res), dtype=torch.float32,
                                     device=device)}

    def texture_loss(params):
        loss = 0.
        for mesh in meshes:
            img, mask, _ = renderer.render_image_and_mask(
                cam_p, cam_t, H, W, mesh, meta['sigmainv'],
                params['texture'])
            loss = loss + torch.mean(torch.abs(img[0] - gt_rgb)) \
                * hyper['image_weight']
        return loss

    history += [('texture', l) for l in _train(
        texture, texture_loss, hyper['texture_epochs'],
        hyper.get('texture_lr', 5e-2), hyper)]

    return body, fins, texture['texture'], history


# ------------------------------------------------------ synthetic self-fit

SELF_FIT_META = {'cam_elev': 90., 'cam_azim': 0., 'cam_radius': 3.,
                 'cam_look_at_height': 0., 'cam_fovyangle': 50.,
                 'sigmainv': 7000}


def synthetic_data(res=128, lod_x=16, lod_y=8, key_size=4,
                   origin_xy=(-0.7, 0.1), length_x=1.4,
                   fin_uv=((0.3, 1.), (0.7, 1.)), device='cuda'):
    """The demo's ground truth: a body (flat splines of height 0.45 at
    ``origin_xy``, ``length_x`` long) with a dorsal fin between
    ``fin_uv``, rendered on ``device`` under ``SELF_FIT_META``. Returns
    (data for :func:`fit_fish`, numpy; gt body soft mask (1, res, res))."""
    device = utils.check_device(device)
    meta = dict(SELF_FIT_META)
    faces_np, _, _ = card_topology(lod_x, lod_y)
    with torch.no_grad():
        gt_body = make_body_params(key_size, init_height=0.45,
                                   device=device)
        gt_body['origin_xy'] = _f32(origin_xy, device)
        gt_body['length_x'] = _f32(length_x, device)
        bv = fish_body_vertices(gt_body, lod_x, lod_y)
        body_soft, _ = _render_soft_mask(bv, faces_np, meta, res, res)
        gt_fin = make_fin_params(key_size, start_uv=fin_uv[0],
                                 end_uv=fin_uv[1], init_height=0.35,
                                 device=device)
        fv = fish_fin_vertices(gt_fin, bv, (lod_x, lod_y), lod_x, lod_y)
        fin_soft, _ = _render_soft_mask(fv, faces_np, meta, res, res)
        start, end = _body_endpoints(gt_body)
        anchors = torch.stack([gt_fin['start_uv'], gt_fin['end_uv']])
        body_np = body_soft[0].cpu().numpy()
        data = {
            'rgb': np.tile(body_np[..., None], (1, 1, 3)) * .5,
            'body_mask': body_np,
            'dorsal_fin_mask': fin_soft[0].cpu().numpy(),
            'root_segmentation': {
                'body_mask': _project_points(
                    torch.stack([start, end]), meta).cpu().numpy(),
                'dorsal_fin_mask': _project_points(
                    position_by_uv(bv, lod_x, lod_y, anchors),
                    meta).cpu().numpy()},
            'metadata': meta,
        }
    return data, body_soft


def self_fit_hyper(lod_x=16, lod_y=8, key_size=4, texture_res=64,
                   epochs=100, texture_epochs=20):
    """The demo's hyperparameters: body ``epochs``, fins ``epochs // 2``,
    texture ``texture_epochs``."""
    return {'lod_x': lod_x, 'lod_y': lod_y, 'key_size': key_size,
            'init_height': 0.3, 'fin_list': ['dorsal_fin'],
            'alpha_weight': 200., 'negative_ys_weight': 0.9,
            'root_pos_weight': 100., 'fin_uv_bound_weight': 100.,
            'image_weight': 1., 'texture_res': texture_res,
            'body_epochs': epochs, 'fin_epochs': epochs // 2,
            'texture_epochs': texture_epochs, 'body_lr': 2e-2,
            'fin_lr': 2e-2, 'texture_lr': 0.1}


def synthetic_self_fit(res=128, epochs=100, lod_x=16, lod_y=8, key_size=4,
                       texture_res=64, texture_epochs=20, device='cuda'):
    """The example's demo: renders a ground-truth fish's masks, then fits
    fresh parameters to them with ``fit_fish``.

    Returns (data, hyper, gt_body_soft (1, res, res), body, fins,
    texture, history).
    """
    data, body_soft = synthetic_data(res, lod_x, lod_y, key_size,
                                     device=device)
    hyper = self_fit_hyper(lod_x, lod_y, key_size, texture_res, epochs,
                           texture_epochs)
    body, fins, texture, history = fit_fish(data, hyper, device=device)
    return data, hyper, body_soft, body, fins, texture, history


def body_iou(body, gt_body_soft, hyper, meta=None):
    """IoU of the fitted body's silhouette (soft mask > 0.5) with the
    ground truth's, at the ground truth's resolution."""
    meta = meta or SELF_FIT_META
    lod_x, lod_y = hyper['lod_x'], hyper['lod_y']
    faces_np, _, _ = card_topology(lod_x, lod_y)
    res_h, res_w = gt_body_soft.shape[-2:]
    with torch.no_grad():
        fitted = fish_body_vertices(body, lod_x, lod_y)
        soft, _ = _render_soft_mask(fitted, faces_np, meta, res_h, res_w)
    a = soft[0] > 0.5
    b = gt_body_soft[0].to(soft.device) > 0.5
    return float((a & b).sum()) / max(float((a | b).sum()), 1.)


if __name__ == '__main__':
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--res', type=int, default=128)
    ap.add_argument('--epochs', type=int, default=100)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    *_, gt_soft, body, fins, texture, history = synthetic_self_fit(
        args.res, args.epochs, device=args.device)
    for stage in ('body', 'dorsal_fin', 'texture'):
        losses = [l for s, l in history if s == stage]
        print(f'{stage}: {losses[0]:.4f} -> {losses[-1]:.4f} '
              f'({len(losses)} steps)')
