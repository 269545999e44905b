"""The table of ``chip_smoke.py``'s ``coverage`` phase: every public
function and class of ``kaolin_tpu_torch`` that takes or returns tensors,
each with a small function that makes its inputs and a tolerance, and
the names that take no tensors, each with its reason (``EXCLUDED``).

An entry is a function of an :class:`Inputs`, which makes its tensors on
one device from one seeded numpy generator, so that the card's call and
the CPU's see the same numbers. :func:`run` calls an entry on a device
(and, for an entry with gradients, takes one backward pass of a seeded
weighted sum of its float outputs to the inputs made with ``grad=True``);
:func:`compare` holds the card's outputs against the CPU's: every tensor
on the card, integer and bool outputs equal, float outputs within the
entry's tolerance (relative to the largest finite value, NaN where the
CPU has NaN). The CPU side is what the tier-1 tests hold against
``kaolin_tpu``. ``tests/test_torch_coverage.py`` checks that every public
name is in the table or in ``EXCLUDED`` and runs each entry on the CPU.

Run it alone on a card with ``python3 chip_smoke.py --coverage``.
"""

import contextlib
import importlib
import inspect
import io
import math
import pkgutil
import socket
import warnings

import numpy as np
import torch
import torch.distributed as dist

import kaolin_tpu_torch as kt
import kaolin_tpu_torch.examples.dibr_train  # noqa: F401
import kaolin_tpu_torch.examples.dmtet_train  # noqa: F401
import kaolin_tpu_torch.examples.fish  # noqa: F401
import kaolin_tpu_torch.examples.nglod_train  # noqa: F401
import kaolin_tpu_torch.examples.renderer  # noqa: F401
import kaolin_tpu_torch.examples.spline  # noqa: F401
import kaolin_tpu_torch.examples.spline_mesh  # noqa: F401
import kaolin_tpu_torch.examples.utils  # noqa: F401
import kaolin_tpu_torch.examples.visualize_main  # noqa: F401
import kaolin_tpu_torch.experimental.dash3d.util  # noqa: F401

# float32 outputs: 1e-5 of the largest finite value, unless the entry
# says why it needs more
TOL = 1e-5


class Entry:
    """One row of the table: the public names it calls, its inputs and
    call (``fn(inputs)`` -> outputs), its tolerance, whether it takes a
    backward pass, whether it needs a process group, whether only its
    running is checked (printed text; fits whose steps turn rounding into
    other steps), and why, where it differs from the default."""

    def __init__(self, names, fn, tol, grad, world, runs_only, why):
        self.names, self.fn, self.tol = names, fn, tol
        self.grad, self.world, self.runs_only = grad, world, runs_only
        self.why = why

    @property
    def module(self):
        return self.names[0].rsplit('.', 1)[0]

    @property
    def id(self):
        return self.fn.__name__.lstrip('_')


ENTRIES = []


def entry(*names, tol=TOL, grad=False, world=False, runs_only=False,
          why=None):
    """Adds the decorated inputs-and-call function to the table under ``names``
    (relative to ``kaolin_tpu_torch``)."""
    def add(fn):
        ENTRIES.append(Entry(names, fn, tol, grad, world, runs_only, why))
        return fn
    return add


class Inputs:
    """Tensors of one call on ``device``, from one seeded generator."""

    def __init__(self, device, seed=0):
        self.device = device
        self.rng = np.random.default_rng(seed)
        self.leaves = []

    def __call__(self, a, dtype=None, grad=False):
        """``a`` (numpy or nested lists) on the device; float64 becomes
        float32 unless ``dtype`` says otherwise."""
        a = np.asarray(a)
        if dtype is None and a.dtype == np.float64:
            dtype = torch.float32
        t = torch.as_tensor(a, device=self.device)
        if dtype is not None:
            t = t.to(dtype)
        if grad:
            t.requires_grad_(True)
            self.leaves.append(t)
        return t

    def normal(self, *shape, scale=1., grad=False):
        return self(self.rng.normal(size=shape) * scale, grad=grad)

    def uniform(self, *shape, lo=-1., hi=1., grad=False):
        return self(self.rng.uniform(lo, hi, shape), grad=grad)

    def ints(self, hi, *shape, lo=0, dtype=torch.int64):
        return self(self.rng.integers(lo, hi, shape), dtype)

    def unit(self, *shape, grad=False):
        v = self.rng.normal(size=shape + (3,))
        return self(v / np.linalg.norm(v, axis=-1, keepdims=True), grad=grad)


# ------------------------------------------------------------- the harness

def _flatten(out, path='out', depth=0):
    """(path, value) of each tensor, array, number or string in a nested
    output: tuples, lists, dicts, modules (their state), named tuples and
    objects (their attributes)."""
    if torch.is_tensor(out) or isinstance(out, (np.ndarray, np.generic)):
        yield path, out
    elif out is None or isinstance(out, (bool, int, float, str, bytes)):
        yield path, out
    elif isinstance(out, dict):
        for k in sorted(out, key=str):
            yield from _flatten(out[k], f'{path}[{k!r}]', depth + 1)
    elif isinstance(out, (list, tuple)):
        for i, v in enumerate(out):
            yield from _flatten(v, f'{path}[{i}]', depth + 1)
    elif isinstance(out, torch.nn.Module):
        yield from _flatten(dict(out.state_dict()), f'{path}.state', depth)
    elif depth < 4 and hasattr(out, '__dict__'):
        attrs = {k: v for k, v in vars(out).items()
                 if not callable(v) or torch.is_tensor(v)}
        yield from _flatten(attrs, path, depth + 1)
    else:
        yield path, type(out).__name__


def _weights(x, k):
    """A seeded weight of ``x``'s shape, the same on every device."""
    rng = np.random.default_rng(1000 + k)
    return torch.as_tensor(rng.normal(size=tuple(x.shape)), dtype=x.dtype,
                           device=x.device)


def run(e, device):
    """(outputs, gradients or None) of one call of ``e`` on ``device``."""
    t = Inputs(device)
    out = e.fn(t)
    grads = None
    if e.grad:
        floats = [v for _, v in _flatten(out) if torch.is_tensor(v)
                  and v.is_floating_point() and v.requires_grad]
        if not floats or not t.leaves:
            raise RuntimeError(f'{e.id}: no differentiable output or input')
        loss = sum((torch.nan_to_num(v) * _weights(v, k)).sum()
                   for k, v in enumerate(floats))
        grads = torch.autograd.grad(loss, t.leaves, allow_unused=True)
    return out, grads


def _dense(v):
    return v.to_dense() if torch.is_tensor(v) and v.is_sparse else v


def _err(a, b):
    """Largest difference of float tensors ``a`` (card) and ``b`` (CPU)
    over the largest finite magnitude of ``b``; inf where their NaN or inf
    positions differ."""
    a, b = a.detach().double().cpu(), b.detach().double()
    if a.shape != b.shape:
        return math.inf
    if a.numel() == 0:
        return 0.
    fin = torch.isfinite(b)
    if not torch.equal(torch.isnan(a), torch.isnan(b)) or not torch.equal(
            a[~fin & ~torch.isnan(b)], b[~fin & ~torch.isnan(b)]):
        return math.inf
    if not fin.any():
        return 0.
    scale = float(b[fin].abs().max())
    return float((a[fin] - b[fin]).abs().max()) / max(scale, 1e-30)


def compare(card, cpu, device='cuda'):
    """(largest error, [faults]) of the card's outputs against the CPU's:
    every tensor of ``card`` on ``device``, the same structure, dtypes and
    shapes, integers and bools equal, floats by :func:`_err`."""
    a, b = list(_flatten(card)), list(_flatten(cpu))
    if [p for p, _ in a] != [p for p, _ in b]:
        return math.inf, ['outputs differ in structure: '
                          f'{[p for p, _ in a]} vs {[p for p, _ in b]}']
    worst, faults = 0., []
    for (path, x), (_, y) in zip(a, b):
        if torch.is_tensor(x) != torch.is_tensor(y):
            faults.append(f'{path}: a tensor on one device only')
            continue
        if torch.is_tensor(x):
            if x.device.type != torch.device(device).type:
                faults.append(f'{path}: on {x.device}, not {device}')
            x, y = _dense(x), _dense(y)
            if x.dtype != y.dtype or x.shape != y.shape:
                faults.append(f'{path}: {x.dtype} {tuple(x.shape)} vs '
                              f'{y.dtype} {tuple(y.shape)}')
            elif x.is_floating_point() or x.is_complex():
                worst = max(worst, _err(x, y))
            elif not torch.equal(x.cpu(), y):
                faults.append(f'{path}: integer or bool values differ')
        elif isinstance(x, (np.ndarray, np.generic)):
            x, y = np.asarray(x), np.asarray(y)
            if x.dtype.kind == 'f':
                worst = max(worst, _err(torch.from_numpy(x.copy()),
                                        torch.from_numpy(y.copy())))
            elif not np.array_equal(x, y):
                faults.append(f'{path}: array values differ')
        elif isinstance(x, float) and isinstance(y, float):
            worst = max(worst, _err(torch.tensor([x]), torch.tensor([y])))
        elif x != y:
            faults.append(f'{path}: {x!r} vs {y!r}')
    return worst, faults


@contextlib.contextmanager
def one_rank_world():
    """A gloo process group of one rank (``tcp://localhost``) for the
    entries of ``kaolin_tpu_torch.parallel``; the group already there, if
    one is."""
    if dist.is_initialized():
        yield
        return
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}',
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def public_names():
    """Every public function and class defined in a module of
    ``kaolin_tpu_torch``, as 'module.name' relative to the package."""
    names = []
    for m in pkgutil.walk_packages(kt.__path__, 'kaolin_tpu_torch.'):
        if m.name.endswith('__main__'):
            continue
        mod = importlib.import_module(m.name)
        for n, o in vars(mod).items():
            if not n.startswith('_') and (inspect.isfunction(o)
                                          or inspect.isclass(o)) \
                    and o.__module__ == m.name:
                names.append(f'{m.name[len("kaolin_tpu_torch."):]}.{n}')
    return names


def _quiet(fn, *args, **kwargs):
    """``fn``'s result, what it prints dropped."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


# ----------------------------------------------------------------- scenes

def _mesh(t, subdiv=1, batch=2):
    """A DIB-R scene of ``kaolin_tpu_torch.utils.interop.scene`` on the
    inputs' device: (verts (B, V, 3), faces (F, 3) int64, rot, trans,
    proj)."""
    return kt.utils.interop.scene(batch, subdiv, device=t.device)


def _prepared(t, subdiv=1, batch=2, grad=False):
    verts, faces, rot, trans, proj = _mesh(t, subdiv, batch)
    if grad:
        verts = t(verts.cpu().numpy(), grad=True)
    fvc, fvi, fn = kt.render.mesh.prepare_vertices(
        verts, faces, proj, camera_rot=rot, camera_trans=trans)
    return fvc, fvi, fn


def _cloud(t, b, n, grad=False, scale=1.):
    return t.normal(b, n, 3, scale=scale, grad=grad)


def _tet_mesh(t):
    """A cube cut into tets: (verts (8, 3), tets (6, 4) int64)."""
    verts = np.asarray([[x, y, z] for x in (0., 1.) for y in (0., 1.)
                        for z in (0., 1.)])
    tets = np.asarray([[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
                       [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]])
    return t(verts + t.rng.normal(size=verts.shape) * 0.05), t(tets)


def _spc(t, level=3, n=60):
    """A seeded octree of ``n`` points at ``level``: (octree, lengths,
    pyramids, exsum, point_hierarchy) on the device."""
    pts = t.uniform(n, 3)
    octree = kt.ops.spc.unbatched_points_to_octree(
        kt.ops.spc.quantize_points(pts, level), level)
    lengths = torch.tensor([octree.shape[0]], dtype=torch.int32)
    _, pyramids, exsum = kt.ops.spc.scan_octrees(octree, lengths)
    ph = kt.ops.spc.generate_points(octree, pyramids, exsum)
    return octree, lengths, pyramids, exsum, ph


def _voxels(t, b=2, r=8, p=0.3):
    return t(t.rng.random((b, r, r, r)) < p, torch.float32)


def _sg(t, n, grad=False):
    """Spherical Gaussians: (amplitude (n, 3), direction (n, 3),
    sharpness (n,))."""
    return (t.uniform(n, 3, lo=0.1, hi=1., grad=grad),
            t.unit(n, grad=grad), t.uniform(n, lo=1., hi=8., grad=grad))


# ============================================================ render.mesh

RES = 32


@entry('render.mesh.utils.prepare_vertices', grad=True)
def _prepare_vertices(t):
    return _prepared(t, grad=True)


@entry('render.mesh.rasterization.rasterize', grad=True)
def _rasterize(t):
    fvc, fvi, fn = _prepared(t, grad=True)
    feat = torch.cat([fvc, t.normal(*fvc.shape[:3], 2)], -1)
    return kt.render.mesh.rasterize(RES, RES, fvc[..., 2], fvi, feat,
                                    fn[..., 2] >= 0.)


# the soft mask's gradient sums each pixel's faces in the card's order:
# chip_smoke.py's GRAD_TOL
SOFT_GRAD = dict(tol=1e-4, why="the soft mask's gradient is summed in "
                                "another order on the card (GRAD_TOL)")


@entry('render.mesh.dibr.dibr_rasterization', grad=True, **SOFT_GRAD)
def _dibr_rasterization(t):
    fvc, fvi, fn = _prepared(t, grad=True)
    return kt.render.mesh.dibr_rasterization(RES, RES, fvc[..., 2], fvi, fvc,
                                             fn[..., 2])


@entry('render.mesh.dibr.dibr_soft_mask', grad=True, **SOFT_GRAD)
def _dibr_soft_mask(t):
    fvc, fvi, fn = _prepared(t, grad=True)
    _, idx = kt.render.mesh.rasterize(RES, RES, fvc[..., 2].detach(),
                                      fvi.detach(), fvc.detach(),
                                      fn[..., 2] >= 0.)
    return kt.render.mesh.dibr_soft_mask(fvi, idx)


@entry('render.mesh.deftet.deftet_sparse_render', grad=True)
def _deftet_sparse_render(t):
    pc, rr, fz, fvi, feat = kt.utils.interop.deftet_scene(
        seed=1, side=8, num_faces=40, device=t.device)
    fvi = t(fvi.cpu().numpy(), grad=True)
    return kt.render.mesh.deftet_sparse_render(pc, rr, fz, fvi, feat, knum=8)


@entry('render.mesh.utils.grid_sample_2d', grad=True)
def _grid_sample_2d(t):
    maps = t.normal(2, 3, 8, 8, grad=True)
    grid = t.uniform(2, 5, 4, 2, lo=-1.2, hi=1.2, grad=True)
    return [kt.render.mesh.grid_sample_2d(maps, grid, mode)
            for mode in ('bilinear', 'nearest')]


@entry('render.mesh.utils.texture_mapping', grad=True)
def _texture_mapping(t):
    maps = t.normal(2, 3, 8, 8, grad=True)
    uv = t.uniform(2, 6, 5, 2, lo=-0.1, hi=1.1, grad=True)
    return [kt.render.mesh.texture_mapping(uv, maps, mode)
            for mode in ('bilinear', 'nearest')]


@entry('render.mesh.utils.spherical_harmonic_lighting', grad=True)
def _spherical_harmonic_lighting(t):
    return kt.render.mesh.spherical_harmonic_lighting(
        t.unit(2, 6, 5, grad=True), t.normal(2, 9, grad=True))


# ========================================================== render.camera

def _extrinsics(t, n=2, backend=None):
    eye = t.normal(n, 3) + t([0., 0., 4.])
    return kt.render.camera.CameraExtrinsics.from_lookat(
        eye, t.normal(n, 3, scale=0.1), t([0., 1., 0.]), backend=backend,
        device=t.device)


@entry('render.camera.extrinsics.CameraExtrinsics', grad=True)
def _camera_extrinsics(t):
    ext = _extrinsics(t)
    vec = t.normal(2, 5, 3, grad=True)
    out = [ext.view_matrix(), ext.inv_view_matrix(), ext.parameters(),
           ext.transform(vec), ext.inv_transform_rays(vec, vec),
           ext.cam_pos(), ext.cam_right(), ext.cam_up(), ext.cam_forward()]
    moved = ext.translate(t([0.1, 0.2, 0.3]))
    moved = moved.rotate(yaw=0.1, pitch=0.2, roll=0.3)
    moved = moved.move_right(0.5).move_up(0.2).move_forward(-0.3)
    out += [moved.view_matrix(), moved.gradient_mask('t')]
    changed = moved.change_coordinate_system(
        kt.render.camera.blender_coords(device=t.device))
    out += [changed.view_matrix(),
            changed.reset_coordinate_system().view_matrix(),
            moved.switch_backend('matrix_6dof_rotation').parameters(),
            moved.allclose(moved)]
    return out


def _pinhole(t, n=2):
    return kt.render.camera.PinholeIntrinsics.from_fov(
        64, 48, 0.9, num_cameras=n, device=t.device)


@entry('render.camera.intrinsics_pinhole.PinholeIntrinsics',
       'render.camera.intrinsics.CameraIntrinsics', grad=True)
def _pinhole_intrinsics(t):
    intr = _pinhole(t)
    vec = t.normal(2, 5, 3, grad=True) + t([0., 0., -4.])
    zoomed = intr.zoom(0.5)
    return [intr.projection_matrix(), intr.perspective_matrix(),
            intr.ndc_matrix(-1., 1., -1., 1., 0.1, 10.), intr.transform(vec),
            intr.tan_half_fov(),
            intr.fov(), intr.parameters(), zoomed.parameters(),
            intr.normalize_depth(t.uniform(2, 5, lo=0.1, hi=5.)),
            intr.gradient_mask('focal_x'), intr.allclose(zoomed)]


@entry('render.camera.intrinsics_ortho.OrthographicIntrinsics', grad=True)
def _ortho_intrinsics(t):
    intr = kt.render.camera.OrthographicIntrinsics.from_frustum(
        64, 48, 1.5, num_cameras=2, device=t.device)
    vec = t.normal(2, 5, 3, grad=True)
    return [intr.projection_matrix(), intr.transform(vec),
            intr.zoom(0.5).parameters(),
            intr.orthographic_matrix(-1., 1., -1., 1., 0.1, 10.)]


@entry('render.camera.camera.Camera', grad=True)
def _camera(t):
    cam = kt.render.camera.Camera(_extrinsics(t), _pinhole(t))
    vec = t.normal(2, 5, 3, grad=True)
    orig, dirs = cam.inv_transform_rays(vec, vec)
    return [cam.view_projection_matrix(), cam.transform(vec), orig, dirs,
            cam.gradient_mask('t', 'focal_x'), cam.allclose(cam)]


@entry('render.camera.intrinsics.CameraFOV')
def _camera_fov(t):
    return kt.render.camera.PinholeIntrinsics.from_fov(
        32, 64, 0.7, kt.render.camera.intrinsics.CameraFOV.HORIZONTAL,
        device=t.device).parameters()


@entry('render.camera.intrinsics.up_to_homogeneous',
       'render.camera.intrinsics.down_from_homogeneous', grad=True)
def _homogeneous(t):
    v = t.normal(4, 3, grad=True)
    up = kt.render.camera.intrinsics.up_to_homogeneous(v)
    return up, kt.render.camera.intrinsics.down_from_homogeneous(up * 2.)


@entry('render.camera.coordinates.blender_coords',
       'render.camera.coordinates.opengl_coords')
def _coords(t):
    return (kt.render.camera.blender_coords(device=t.device),
            kt.render.camera.opengl_coords(device=t.device))


@entry('render.camera.legacy.generate_perspective_projection',
       'render.camera.legacy.generate_rotate_translate_matrices',
       'render.camera.legacy.generate_transformation_matrix',
       'render.camera.legacy.rotate_translate_points',
       'render.camera.legacy.perspective_camera', grad=True)
def _legacy_camera(t):
    proj = kt.render.camera.generate_perspective_projection(
        0.8, 1.2, device=t.device)
    pos = t.normal(2, 3, grad=True) + t([0., 0., 3.])
    look, up = t.normal(2, 3, scale=0.1), t([[0., 1., 0.]] * 2)
    rot, trans = kt.render.camera.generate_rotate_translate_matrices(
        pos, look, up)
    pts = t.normal(2, 7, 3, grad=True)
    cam_pts = kt.render.camera.rotate_translate_points(pts, rot, trans)
    return (proj, rot, trans, cam_pts,
            kt.render.camera.perspective_camera(cam_pts, proj),
            kt.render.camera.generate_transformation_matrix(pos, look, up))


# ======================================================== render.lighting

@entry('render.lighting.sg.sg_distribution_term',
       'render.lighting.sg.sg_warp_distribution', 'render.lighting.sg.fresnel',
       'render.lighting.sg.sg_warp_specular_term',
       'render.lighting.sg.cosine_lobe_sg',
       'render.lighting.sg.approximate_sg_integral', grad=True)
def _sg_terms(t):
    sg = kt.render.lighting.sg
    amp, direc, sharp = _sg(t, 6, grad=True)
    normal, view = t.unit(6, grad=True), t.unit(6, grad=True)
    rough = t.uniform(6, lo=0.2, hi=0.9, grad=True)
    return (sg.sg_distribution_term(direc, rough),
            sg.sg_warp_distribution(amp, direc, sharp, view),
            sg.fresnel(t.uniform(6, 1, lo=0., hi=1., grad=True),
                       t.uniform(6, 3, lo=0., hi=1., grad=True)),
            sg.sg_warp_specular_term(amp, direc, sharp, normal, rough, view,
                                     t.uniform(3, lo=0.1, hi=0.9)),
            sg.cosine_lobe_sg(direc), sg.approximate_sg_integral(amp, sharp))


@entry('render.lighting.sg.sg_irradiance_fitted',
       'render.lighting.sg.sg_diffuse_fitted',
       'render.lighting.sg.sg_irradiance_inner_product',
       'render.lighting.sg.sg_diffuse_inner_product', grad=True)
def _sg_diffuse(t):
    sg = kt.render.lighting.sg
    amp, direc, sharp = _sg(t, 4, grad=True)
    normal = t.unit(6, grad=True)
    albedo = t.uniform(6, 3, lo=0., hi=1., grad=True)
    return (sg.sg_irradiance_fitted(amp, direc, sharp, normal),
            sg.sg_diffuse_fitted(amp, direc, sharp, normal, albedo),
            sg.sg_irradiance_inner_product(amp, direc, sharp, normal),
            sg.sg_diffuse_inner_product(amp, direc, sharp, normal, albedo))


@entry('render.lighting.sg.unbatched_sg_inner_product',
       'render.lighting.sg.unbatched_reduced_sg_inner_product', grad=True)
def _sg_inner(t):
    sg = kt.render.lighting.sg
    a = _sg(t, 5, grad=True)
    b = _sg(t, 7, grad=True)
    return (sg.unbatched_sg_inner_product(*a, *b),
            sg.unbatched_reduced_sg_inner_product(*a, *b, chunk=3))


@entry('render.lighting.sh.project_onto_sh9',
       'render.lighting.sh.sh9_irradiance',
       'render.lighting.sh.sh9_diffuse', grad=True)
def _sh9(t):
    sh = kt.render.lighting.sh
    d, n = t.unit(10, grad=True), t.unit(10, grad=True)
    return (sh.project_onto_sh9(d, device=t.device),
            sh.sh9_irradiance(t.normal(9, grad=True), n),
            sh.sh9_diffuse(t.unit(grad=True), n,
                           t.uniform(10, 3, lo=0., hi=1., grad=True)),
            sh.project_onto_sh9([0.6, 0.0, 0.8], device=t.device))


# ================================================================ metrics

@entry('metrics.pointcloud.sided_distance',
       'metrics.pointcloud.chamfer_distance', 'metrics.pointcloud.f_score',
       grad=True)
def _pointcloud_metrics(t):
    p1, p2 = _cloud(t, 2, 50, grad=True), _cloud(t, 2, 70, grad=True)
    return (kt.metrics.pointcloud.sided_distance(p1, p2),
            kt.metrics.pointcloud.chamfer_distance(p1, p2, w1=0.5),
            kt.metrics.pointcloud.f_score(p1, p2 + 0.05, radius=0.5))


@entry('metrics.trianglemesh.point_to_mesh_distance',
       'metrics.trianglemesh.uniform_laplacian_smoothing', grad=True)
def _trianglemesh_metrics(t):
    verts, faces, *_ = _mesh(t)
    verts = t(verts.cpu().numpy(), grad=True)
    fv = kt.ops.mesh.index_vertices_by_faces(verts, faces)
    return (kt.metrics.trianglemesh.point_to_mesh_distance(
                _cloud(t, 2, 40, grad=True), fv),
            kt.metrics.trianglemesh.uniform_laplacian_smoothing(verts, faces))


@entry('metrics.render.mask_iou', grad=True)
def _mask_iou(t):
    return kt.metrics.render.mask_iou(
        t.uniform(2, 8, 8, lo=0., hi=1., grad=True),
        t.uniform(2, 8, 8, lo=0., hi=1.))


@entry('metrics.tetmesh.tetrahedron_volume', 'metrics.tetmesh.equivolume',
       'metrics.tetmesh.amips', 'ops.mesh.tetmesh.inverse_vertices_offset',
       grad=True)
def _tetmesh_metrics(t):
    verts, tets = _tet_mesh(t)
    verts = t(verts.cpu().numpy(), grad=True)
    tv = verts[tets][None]
    inv = kt.ops.mesh.inverse_vertices_offset(tv.detach())
    return (kt.metrics.tetmesh.tetrahedron_volume(tv),
            kt.metrics.tetmesh.equivolume(tv, pow=4),
            kt.metrics.tetmesh.amips(tv, inv), inv)


@entry('metrics.voxelgrid.iou')
def _voxel_iou(t):
    return kt.metrics.voxelgrid.iou(_voxels(t), _voxels(t))


# ============================================================= ops: batch

@entry('ops.batch.get_shape_per_tensor', 'ops.batch.list_to_packed',
       'ops.batch.get_first_idx', 'ops.batch.packed_to_list',
       'ops.batch.fill_max_shape', 'ops.batch.list_to_padded',
       'ops.batch.padded_to_list', 'ops.batch.packed_to_padded',
       'ops.batch.padded_to_packed', 'ops.batch.segment_ids_from_numel',
       'ops.batch.tile_to_packed', 'ops.reduction.packed_simple_sum',
       grad=True)
def _batch(t):
    b = kt.ops.batch
    tensors = [t.normal(3, 2, 4, grad=True), t.normal(5, 1, 4, grad=True),
               t.normal(2, 3, 4, grad=True)]
    packed, shapes = b.list_to_packed(tensors)
    numel = np.prod(shapes, axis=1)
    first = b.get_first_idx(numel)
    padded, _ = b.list_to_padded(tensors, padding_value=-1.)
    return (b.get_shape_per_tensor(tensors), packed, shapes, first,
            b.packed_to_list(packed, shapes, first),
            b.fill_max_shape(shapes, [-1, 4]), padded,
            b.padded_to_list(padded, shapes),
            b.packed_to_padded(packed, shapes, first, padding_value=2.),
            b.padded_to_packed(padded, shapes),
            b.segment_ids_from_numel(numel, device=t.device),
            b.tile_to_packed(t.normal(3, grad=True), numel),
            kt.ops.packed_simple_sum(packed, numel))


@entry('ops.coords.spherical2cartesian', 'ops.coords.cartesian2spherical',
       grad=True)
def _coords_ops(t):
    az, el, r = (t.uniform(20, lo=0.1, hi=3., grad=True) for _ in range(3))
    x, y, z = kt.ops.coords.spherical2cartesian(az, el, r)
    return (x, y, z) + tuple(kt.ops.coords.cartesian2spherical(x, y, z))


# ================================================================ ops: gcn

@entry('ops.gcn.sparse_bmm', 'ops.gcn.normalize_adj', 'ops.gcn.GraphConv',
       'ops.mesh.mesh.adjacency_matrix', grad=True)
def _gcn(t):
    verts, faces, *_ = _mesh(t)
    V = verts.shape[1]
    idx, vals = kt.ops.mesh.adjacency_matrix(V, faces, sparse=True,
                                             device=t.device)
    adj = torch.sparse_coo_tensor(idx, vals, (V, V))
    dense = kt.ops.mesh.adjacency_matrix(V, faces, device=t.device)
    x = t.normal(2, V, 6, grad=True)
    layer = kt.ops.gcn.GraphConv(6, 5, generator=torch.Generator()
                                 .manual_seed(0), device=t.device)
    return (idx, dense, kt.ops.gcn.sparse_bmm(adj, x),
            kt.ops.gcn.normalize_adj(adj), layer(x, adj), layer(x, dense),
            layer)


# =============================================================== ops.mesh

@entry('ops.mesh.mesh.index_vertices_by_faces',
       'ops.mesh.mesh.uniform_laplacian', 'ops.mesh.trianglemesh.face_areas',
       'ops.mesh.trianglemesh.face_normals',
       'ops.mesh.trianglemesh.average_edge_length', grad=True)
def _mesh_ops(t):
    verts, faces, *_ = _mesh(t)
    verts = t(verts.cpu().numpy(), grad=True)
    fv = kt.ops.mesh.index_vertices_by_faces(verts, faces)
    return (fv, kt.ops.mesh.uniform_laplacian(verts.shape[1], faces,
                                              device=t.device),
            kt.ops.mesh.face_areas(verts, faces),
            kt.ops.mesh.face_normals(fv, unit=True),
            kt.ops.mesh.face_normals(fv),
            kt.ops.mesh.average_edge_length(verts, faces))


@entry('ops.mesh.trianglemesh.sample_points',
       'ops.mesh.trianglemesh.packed_sample_points',
       'ops.mesh.trianglemesh.packed_face_areas', grad=True)
def _sampling(t):
    verts, faces, *_ = _mesh(t)
    verts = t(verts.cpu().numpy(), grad=True)
    feats = t.normal(2, faces.shape[0], 3, 2, grad=True)
    one = kt.ops.mesh.sample_points(verts, faces, 30, face_features=feats,
                                    generator=torch.Generator()
                                    .manual_seed(1))
    pv = verts.reshape(-1, 3)
    # the meshes' first vertices and face counts are host metadata
    first = np.asarray([0, verts.shape[1], 2 * verts.shape[1]])
    pf = torch.cat([faces, faces])
    nf = np.asarray([faces.shape[0]] * 2)
    return (one, kt.ops.mesh.packed_face_areas(pv, first, pf, nf),
            kt.ops.mesh.packed_sample_points(
                pv, first, pf, nf, 25,
                generator=torch.Generator().manual_seed(2)))


@entry('ops.mesh.check_sign.check_sign')
def _check_sign(t):
    verts, faces, *_ = _mesh(t)
    return kt.ops.mesh.check_sign(verts, faces, _cloud(t, 2, 60, scale=0.7))


@entry('ops.mesh.subdivision.subdivide_trianglemesh', grad=True)
def _subdivide(t):
    verts, faces, *_ = _mesh(t, subdiv=0)
    verts = t(verts.cpu().numpy(), grad=True)
    return (kt.ops.mesh.subdivide_trianglemesh(verts, faces, 2),
            kt.ops.mesh.subdivide_trianglemesh(
                verts, faces, 1, alpha=t.uniform(2, verts.shape[1], lo=0.,
                                                 hi=1.)))


@entry('ops.mesh.tetmesh.subdivide_tetmesh', grad=True)
def _subdivide_tetmesh(t):
    verts, tets = _tet_mesh(t)
    verts = t(verts[None].cpu().numpy(), grad=True)
    return kt.ops.mesh.subdivide_tetmesh(verts, tets,
                                         t.normal(1, 8, 2, grad=True))


# ============================================================= ops.random

@entry('ops.random.random_tensor', 'ops.random.sample_spherical_coords',
       'ops.random.random_spc_octrees', 'ops.random.random_shape_per_tensor',
       'ops.random.manual_seed', 'ops.random.get_key',
       'ops.random.get_state', 'ops.random.set_state')
def _random(t):
    r = kt.ops.random
    state = r.get_state()
    r.manual_seed(3)
    try:
        key = r.get_key()
        return (r.random_tensor(-1., 2., (3, 4), key=key, device=t.device),
                r.random_tensor(0, 5, (6,), dtype=torch.int64,
                                key=r.get_key(), device=t.device),
                r.sample_spherical_coords((5,), key=r.get_key(),
                                          device=t.device),
                r.random_spc_octrees(2, 3, key=r.get_key(), device=t.device),
                r.random_shape_per_tensor(3, [1, 1], [4, 5]))
    finally:
        r.set_state(state)


# ========================================================= ops.voxelgrid

@entry('ops.voxelgrid.downsample', 'ops.voxelgrid.extract_surface',
       'ops.voxelgrid.fill', 'ops.voxelgrid.extract_odms',
       'ops.voxelgrid.project_odms', grad=True)
def _voxelgrid_ops(t):
    v = kt.ops.voxelgrid
    vg = _voxels(t, r=8, p=0.5)
    odms = v.extract_odms(vg)
    return (v.downsample(t.uniform(2, 8, 8, 8, lo=0., hi=1., grad=True), 2),
            v.extract_surface(vg), v.extract_surface(vg, mode='thin'),
            v.fill(vg), odms, v.project_odms(odms),
            v.project_odms(odms, vg, votes=2))


# ======================================================= ops.conversions

@entry('ops.conversions.pointcloud.pointclouds_to_voxelgrids',
       'ops.conversions.pointcloud.unbatched_pointcloud_to_spc')
def _pointcloud_conversions(t):
    pc = _cloud(t, 2, 50)
    return (kt.ops.conversions.pointclouds_to_voxelgrids(pc, 6),
            kt.ops.conversions.unbatched_pointcloud_to_spc(
                pc[0].clamp(-1., 1.), 3, t.normal(50, 2)),
            kt.ops.conversions.unbatched_pointcloud_to_spc(
                pc[1].clamp(-1., 1.), 2, t.ints(9, 50, 3)))


@entry('ops.conversions.trianglemesh.trianglemeshes_to_voxelgrids',
       'ops.conversions.voxelgrid.voxelgrids_to_cubic_meshes',
       'ops.conversions.voxelgrid.voxelgrids_to_trianglemeshes')
def _mesh_voxel_conversions(t):
    verts, faces, *_ = _mesh(t)
    vg = kt.ops.conversions.trianglemeshes_to_voxelgrids(verts, faces, 8)
    return (vg, kt.ops.conversions.voxelgrids_to_cubic_meshes(vg),
            kt.ops.conversions.voxelgrids_to_cubic_meshes(vg, False),
            kt.ops.conversions.voxelgrids_to_trianglemeshes(vg))


@entry('ops.conversions.mesh.voxelize_triangles',
       'ops.conversions.mesh.unbatched_mesh_to_spc',
       'ops.conversions.mesh.mesh_to_spc')
def _mesh_to_spc(t):
    verts, faces, *_ = _mesh(t)
    verts = verts * 0.9
    return (kt.ops.conversions.voxelize_triangles(verts[0], faces, 4),
            kt.ops.conversions.unbatched_mesh_to_spc(verts[0], faces, 4),
            kt.ops.conversions.mesh_to_spc(verts, faces, 3))


@entry('ops.conversions.sdf.sdf_to_voxelgrids')
def _sdf_to_voxelgrids(t):
    return kt.ops.conversions.sdf_to_voxelgrids(
        [lambda p: p.norm(dim=-1) - 0.4, lambda p: p.abs().amax(-1) - 0.3],
        init_res=8, upsampling_steps=1, device=t.device)


@entry('ops.conversions.tetmesh.marching_tetrahedra',
       'ops.conversions.tetmesh.marching_tetrahedra_fixed',
       'ops.conversions.tetmesh.tet_grid',
       'ops.conversions.tetmesh.tet_topology',
       'ops.conversions.tetmesh.TetTopology', grad=True)
def _marching_tetrahedra(t):
    gv, gt = kt.ops.conversions.tet_grid(3)
    verts = t(gv, grad=True)
    sdf = t(np.linalg.norm(gv, axis=-1) - 0.3
            + t.rng.normal(size=gv.shape[0]) * 0.01, grad=True)
    tets = t(gt)
    topo = kt.ops.conversions.tet_topology(gt, t.device)
    return (kt.ops.conversions.marching_tetrahedra(verts[None], tets,
                                                   sdf[None], True),
            kt.ops.conversions.marching_tetrahedra_fixed(verts, gt, sdf),
            topo)


# ================================================================ ops.spc

@entry('ops.spc.points.quantize_points', 'ops.spc.points.points_to_morton',
       'ops.spc.points.morton_to_points', 'ops.spc.points.points_to_corners',
       'ops.spc.points.unbatched_points_to_octree', 'ops.spc.spc.scan_octrees',
       'ops.spc.spc.generate_points', 'ops.spc.spc.unbatched_get_level_points')
def _spc_points(t):
    q = kt.ops.spc.quantize_points(t.uniform(40, 3, lo=-1.2, hi=1.2), 4)
    morton = kt.ops.spc.points_to_morton(q)
    octree, lengths, pyramids, exsum, ph = _spc(t)
    return (q, morton, kt.ops.spc.morton_to_points(morton),
            kt.ops.spc.points_to_corners(q),
            kt.ops.spc.unbatched_points_to_octree(q, 4, sorted=False),
            octree, pyramids, exsum, ph,
            kt.ops.spc.unbatched_get_level_points(ph, pyramids[0], 2))


@entry('ops.spc.spc.unbatched_query')
def _spc_query(t):
    octree, _, _, exsum, ph = _spc(t)
    q = t.uniform(30, 3)
    return (kt.ops.spc.unbatched_query(octree, exsum, q, 3),
            kt.ops.spc.unbatched_query(octree, exsum, q, 3, True),
            kt.ops.spc.unbatched_query(octree, exsum, ph[-5:], 3))


@entry('ops.spc.spc.unbatched_make_dual',
       'ops.spc.spc.unbatched_make_trinkets',
       'ops.spc.points.coords_to_trilinear_coeffs',
       'ops.spc.points.coords_to_trilinear',
       'ops.spc.points.unbatched_interpolate_trilinear', grad=True)
def _trilinear(t):
    octree, _, pyramids, exsum, ph = _spc(t)
    phd, pyd = kt.ops.spc.unbatched_make_dual(ph, pyramids[0])
    trinkets, parents = kt.ops.spc.unbatched_make_trinkets(
        ph, pyramids[0], phd, pyd)
    coords = t.uniform(12, 4, 3, lo=-0.9, hi=0.9, grad=True)
    pidx = kt.ops.spc.unbatched_query(octree, exsum, coords[:, 0].detach(),
                                      3)
    pts = ph[pidx.clamp(min=0).long()]
    feats = t.normal(int(phd.shape[0]), 2, grad=True)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        old = kt.ops.spc.coords_to_trilinear(coords[:, 0], pts, 3)
    return (phd, pyd, trinkets, parents,
            kt.ops.spc.coords_to_trilinear_coeffs(coords[:, 0], pts, 3), old,
            kt.ops.spc.unbatched_interpolate_trilinear(
                coords, pidx, ph, trinkets, feats, 3))


@entry('ops.spc.spc.to_dense', 'ops.spc.spc.feature_grids_to_spc',
       'ops.spc.points.create_dense_spc', 'rep.spc.Spc', grad=True)
def _spc_dense(t):
    grids = t.normal(2, 3, 4, 4, 4) * _voxels(t, 2, 4, 0.4)[:, None]
    octrees, lengths, feats = kt.ops.spc.feature_grids_to_spc(grids)
    spc = kt.rep.spc.Spc(octrees, lengths)
    x = t(feats.detach().cpu().numpy(), grad=True)
    dense = kt.rep.spc.Spc.make_dense(2, device=t.device)
    return (octrees, lengths, feats, spc.pyramids, spc.exsum,
            spc.point_hierarchies, spc.to_dense(x), spc.num_points(2),
            kt.ops.spc.to_dense(spc.point_hierarchies, spc.pyramids, x),
            kt.ops.spc.create_dense_spc(2, device=t.device), dense.exsum,
            kt.rep.spc.Spc.from_features(grids).octrees)


@entry('ops.spc.uint8.popcount8', 'ops.spc.uint8.uint8_to_bits',
       'ops.spc.uint8.uint8_bits_sum', 'ops.spc.uint8.bits_to_uint8')
def _uint8(t):
    u8 = kt.ops.spc.uint8
    b = t.ints(256, 50, dtype=torch.uint8)
    bits = u8.uint8_to_bits(b)
    return (u8.popcount8(b), bits, u8.uint8_bits_sum(b),
            u8.bits_to_uint8(bits))


@entry('ops.spc.convolution.conv3d', 'ops.spc.convolution.conv_transpose3d',
       'ops.spc.convolution.Conv3d', 'ops.spc.convolution.ConvTranspose3d',
       grad=True)
def _spc_conv(t):
    octree, lengths, pyramids, exsum, ph = _spc(t)
    kv = t([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
            for k in (-1, 0, 1)], torch.int32)
    kv8 = t([[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)],
            torch.int32)
    n3 = int(pyramids[0, 0, 3])
    x = t.normal(n3, 4, grad=True)
    w = t.normal(27, 4, 5, scale=0.3, grad=True)
    w8 = t.normal(8, 4, 3, scale=0.3, grad=True)
    args = (octree, ph, 3, pyramids, exsum)
    y, lvl = kt.ops.spc.conv3d(*args, x, w8, kv8, jump=1)
    gen = torch.Generator().manual_seed(4)
    conv = kt.ops.spc.Conv3d(4, 3, kv, generator=gen, device=t.device)
    tconv = kt.ops.spc.ConvTranspose3d(3, 2, kv8, jump=1, generator=gen,
                                       device=t.device)
    z, zl = conv(octree, ph, 3, pyramids, exsum, x)
    return (kt.ops.spc.conv3d(*args, x, w, kv, bias=t.normal(5, grad=True)),
            y, lvl, kt.ops.spc.conv_transpose3d(octree, ph, 2, pyramids,
                                                exsum, y, w8.transpose(1, 2),
                                                kv8, jump=1),
            z, zl, tconv(octree, ph, 2, pyramids, exsum,
                         t.normal(int(pyramids[0, 0, 2]), 3, grad=True)),
            conv, tconv)


# ====================================================== render.spc traces

def _trace_scene(t, level=4, res=12):
    octree, _, pyramids, exsum, ph = _spc(t, level, 300)
    fn = kt.render.spc.primary_rays_fn(res, res, (0.3, -0.2, 2.5),
                                       (0., 0., 0.), (0., 1., 0.), 0.9,
                                       device=t.device)
    o, d = fn(torch.arange(res * res, dtype=torch.int32, device=t.device))
    return octree, pyramids, exsum, ph, o, d, fn


@entry('render.spc.raytrace.unbatched_raytrace',
       'render.spc.raytrace.unbatched_raytrace_fixed',
       'render.spc.raytrace.plan_raytrace',
       'render.spc.raytrace.level_offsets_from_octree',
       'render.spc.raytrace.primary_rays_fn',
       'render.spc.raytrace.generate_primary_rays')
def _raytrace(t):
    octree, pyramids, exsum, ph, o, d, fn = _trace_scene(t)
    rays = kt.render.spc.generate_primary_rays(12, 12, (0.3, -0.2, 2.5),
                                               (0., 0., 0.), (0., 1., 0.),
                                               0.9, device=t.device)
    sched = kt.render.spc.raytrace.plan_raytrace(octree, ph, exsum, o, d, 4,
                                                 return_counts=True)
    fixed = kt.render.spc.unbatched_raytrace_fixed(
        octree, ph, exsum, o, d, 4, 4096, with_exit=True,
        return_level_counts=True)
    by_fn = kt.render.spc.unbatched_raytrace_fixed(
        octree, ph, exsum, o, d, 4, 4096, ray_fn=fn)
    return (rays, o, d, sched, fixed, by_fn,
            kt.render.spc.unbatched_raytrace(octree, ph, pyramids[0], exsum,
                                             o, d, 4, with_exit=True),
            kt.render.spc.raytrace.level_offsets_from_octree(octree))


@entry('render.spc.raytrace.primary_rays_fn_cols',
       'render.spc.raytrace.generate_shadow_rays', grad=True)
def _ray_generators(t):
    fn = kt.render.spc.raytrace.primary_rays_fn_cols(
        6, 8, (0.3, -0.2, 2.5), (0., 0., 0.), (0., 1., 0.), 0.9,
        device=t.device)
    cols = fn(torch.arange(48, dtype=torch.int32, device=t.device))
    o = t.normal(30, 3, grad=True) + t([0., 2., 0.])
    d = t.unit(30, grad=True)
    return cols, kt.render.spc.generate_shadow_rays(
        o, d, t([0.5, 3., 0.2], grad=True), t([0., 1., 0., 0.5]))


@entry('render.spc.raytrace.mark_pack_boundaries',
       'render.spc.raytrace.mark_first_hit', 'render.spc.raytrace.diff',
       'render.spc.raytrace.sum_reduce', 'render.spc.raytrace.cumsum',
       'render.spc.raytrace.cumprod',
       'render.spc.raytrace.exponential_integration', grad=True)
def _pack_ops(t):
    r = kt.render.spc.raytrace
    ridx = t(np.sort(t.rng.integers(0, 9, 40)), torch.int32)
    b = r.mark_pack_boundaries(ridx)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        first = r.mark_first_hit(ridx)
    f = t.normal(40, 3, grad=True)
    tau = t.uniform(40, 1, lo=0., hi=2., grad=True)
    out = [b, first, r.diff(f, b), r.sum_reduce(f, b),
           r.sum_reduce(f, b, num_packs=9),
           r.exponential_integration(f, tau, b),
           r.exponential_integration(f, tau, b, exclusive=False)]
    for fn in (r.cumsum, r.cumprod):
        for ex in (False, True):
            for rev in (False, True):
                out.append(fn(f, b, exclusive=ex, reverse=rev))
    return out


# ======================================================== the kernel layer

def _raster_inputs(t, knum=8):
    """The forward kernels' inputs on a prepared scene at RES^2."""
    from kaolin_tpu_torch.render.mesh.dibr import _scaled_inputs
    from kaolin_tpu_torch.render.mesh.rasterization import _kernel_inputs
    fvc, fvi, fn = (v.detach() for v in _prepared(t))
    fz, img, bbox = _kernel_inputs(fvc[..., 2], fvi, fn[..., 2] >= 0., 1000.)
    feat = torch.cat([fvc, t.normal(*fvc.shape[:3], 1)], -1).reshape(
        fvc.shape[0], -1, 12)
    sm_img, sm_bbox = _scaled_inputs(fvi, 0.02, 1000.)
    return fz, img, bbox, feat, sm_img, sm_bbox, fn[..., 2] >= 0.


KW = dict(height=RES, width=RES, multiplier=1000.)


@entry('kernels.rasterize.rasterize_interp',
       'kernels.rasterize.rasterize_interp_plain',
       'kernels.rasterize.rasterize_select',
       'kernels.rasterize.rasterize_select_plain',
       'kernels.rasterize.interp_epilogue', 'kernels.rasterize.tile_bins',
       'kernels.rasterize.tile_bins_plain')
def _rasterize_kernels(t):
    kr = kt.kernels.rasterize
    fz, img, bbox, feat, *_ = _raster_inputs(t)
    sel = kr.rasterize_select(fz, img, bbox, eps=1e-8, **KW)
    return (kr.rasterize_interp(fz, img, bbox, feat, eps=1e-8, **KW),
            kr.rasterize_interp_plain(fz, img, bbox, feat, eps=1e-8, **KW),
            sel, kr.rasterize_select_plain(fz, img, bbox, eps=1e-8, **KW),
            kr.interp_epilogue(sel[1], img, feat, multiplier=1000.,
                               eps=1e-8),
            kr.tile_bins(bbox, **KW), kr.tile_bins_plain(bbox, **KW))


@entry('kernels.rasterize_bwd.rasterize_backward',
       'kernels.rasterize_bwd.rasterize_backward_plain')
def _rasterize_bwd_kernels(t):
    kr, krb = kt.kernels.rasterize, kt.kernels.rasterize_bwd
    fz, img, bbox, feat, *_, valid = _raster_inputs(t)
    out, idx, w = kr.rasterize_interp(fz, img, bbox, feat, eps=1e-8, **KW)
    fvi = img / 1000.
    g = t.normal(*out.shape)
    return (krb.rasterize_backward(g, idx, w, fvi, feat, eps=1e-8,
                                   valid_faces=valid),
            krb.rasterize_backward_plain(g, idx, w, fvi, feat, 1e-8))


@entry('kernels.soft_mask.soft_mask_forward',
       'kernels.soft_mask.soft_mask_forward_plain',
       'kernels.soft_mask.soft_mask_backward',
       'kernels.soft_mask.soft_mask_backward_plain')
def _soft_mask_kernels(t):
    ks = kt.kernels.soft_mask
    fz, img, bbox, _, sm_img, sm_bbox, _ = _raster_inputs(t)
    _, idx = kt.kernels.rasterize.rasterize_select(fz, img, bbox, eps=1e-8,
                                                   **KW)
    kw = dict(KW, sigmainv=7000.)
    mask, cut = ks.soft_mask_forward(sm_img, sm_bbox, idx, knum=8,
                                     return_cut=True, **kw)
    g = t.normal(*mask.shape)
    return (mask, cut, ks.soft_mask_forward_plain(sm_img, sm_bbox, idx,
                                                  knum=8, return_cut=True,
                                                  **kw),
            ks.soft_mask_backward(sm_img, sm_bbox, cut, mask, g, **kw),
            ks.soft_mask_backward_plain(sm_img, sm_bbox, cut, mask, g, **kw))


@entry('kernels.texture.grid_sample', 'kernels.texture.grid_sample_plain',
       'kernels.texture.grid_sample_backward',
       'kernels.texture.grid_sample_backward_plain',
       'kernels.texture.grid_sample_coords',
       'kernels.texture.tile_lists_plain', 'kernels.texture.partial_slots',
       'kernels.texture.texture_grad_tiled_plain', grad=True)
def _texture_kernels(t):
    ktex = kt.kernels.texture
    maps = t.normal(2, 3, 40, 36, grad=True)
    ix = t.uniform(2, 300, lo=0., hi=35., grad=True)
    iy = t.uniform(2, 300, lo=0., hi=39., grad=True)
    cot = t.normal(2, 300, 3)
    # the wrappers other than grid_sample_coords have no autograd on the
    # card: they take the inputs detached
    m, x, y = maps.detach(), ix.detach(), iy.detach()
    out = []
    for mode in ('bilinear', 'nearest'):
        out += [ktex.grid_sample(m, x, y, mode),
                ktex.grid_sample_plain(m, x, y, mode),
                ktex.grid_sample_backward(m, x, y, cot, mode),
                ktex.grid_sample_backward_plain(m, x, y, cot, mode),
                ktex.grid_sample_coords(maps, ix, iy, mode),
                ktex.tile_lists_plain(x, y, cot, 40, 36, mode),
                ktex.partial_slots(2, 300, 40, 36, mode),
                ktex.texture_grad_tiled_plain(x, y, cot, 40, 36, mode)]
    return out


def _uv_sample_plain(maps, uv, mode):
    """What ``grid_sample_uv`` reproduces: ``texture_mapping``'s PyTorch
    composition, (B, P, C)."""
    from kaolin_tpu_torch.render.mesh.utils import _uv_coords
    return kt.kernels.texture.grid_sample_coords(
        maps, *_uv_coords(uv, *maps.shape[2:]), mode)


def _uv_backward_plain(maps, uv, cot, mode):
    """What ``grid_sample_uv_backward`` reproduces: the composition's
    gradients (dmaps, duv)."""
    maps, uv = (x.detach().requires_grad_(True) for x in (maps, uv))
    return torch.autograd.grad(_uv_sample_plain(maps, uv, mode), (maps, uv),
                               cot)


@entry('kernels.texture.grid_sample_uv',
       'kernels.texture.grid_sample_uv_backward', grad=True)
def _texture_uv_kernels(t):
    ktex = kt.kernels.texture
    maps = t.normal(2, 3, 40, 36, grad=True)
    # the rasterizer's layout: UVs a stride-3 view of a feature map
    feat = t.uniform(2, 6, 5, 3, lo=-0.1, hi=1.1, grad=True)
    uv = feat[..., :2]
    cot = t.normal(2, 30, 3)
    # the UV route is the card's; on the CPU the composition it reproduces
    # stands in for it
    fwd, bwd = ((ktex.grid_sample_uv, ktex.grid_sample_uv_backward)
                if t.device != 'cpu' else (_uv_sample_plain,
                                           _uv_backward_plain))
    out = []
    for mode in ('bilinear', 'nearest'):
        out += [fwd(maps, uv, mode),
                bwd(maps.detach(), uv.detach(), cot, mode)]
    return out


@entry('kernels.nn_distance.nearest_idx',
       'kernels.nn_distance.nearest_idx_plain',
       'kernels.nn_distance.nearest_idx_pruned', 'kernels.nn_distance.prepass',
       'kernels.nn_distance.scan_cuda')
def _nn_kernels(t):
    kn = kt.kernels.nn_distance
    p1, p2 = _cloud(t, 2, 300), _cloud(t, 2, 500)
    # scan_cuda is the card's pruned route without its launch count (the
    # plain version stands for it on the CPU)
    scan = kn.scan_cuda if t.device != 'cpu' else kn.nearest_idx_pruned
    return (kn.nearest_idx(p1, p2), kn.nearest_idx_plain(p1, p2),
            kn.nearest_idx_pruned(p1, p2), kn.prepass(p1, p2), scan(p1, p2))


@entry('kernels.p2m_distance.p2m_select',
       'kernels.p2m_distance.p2m_select_plain',
       'kernels.p2m_distance.classify_and_distance',
       'kernels.p2m_distance.select_cuda')
def _p2m_kernels(t):
    kp = kt.kernels.p2m_distance
    verts, faces, *_ = _mesh(t)
    fv = kt.ops.mesh.index_vertices_by_faces(verts, faces)
    pts = _cloud(t, 2, 200)
    select = kp.select_cuda if t.device != 'cpu' else kp.p2m_select_plain
    return (kp.p2m_select(pts, fv), kp.p2m_select_plain(pts, fv),
            select(pts, fv), kp.classify_and_distance(
                pts[:, :, None], fv[:, None, :, 0], fv[:, None, :, 1],
                fv[:, None, :, 2]))


@entry('kernels.deftet_topk.deftet_topk',
       'kernels.deftet_topk.deftet_topk_plain',
       'kernels.deftet_topk.face_bboxes')
def _deftet_kernels(t):
    kd = kt.kernels.deftet_topk
    pc, rr, fz, fvi, _ = kt.utils.interop.deftet_scene(
        seed=2, side=8, num_faces=60, device=t.device)
    valid = t(t.rng.random(fvi.shape[:2]) < 0.9)
    return (kd.face_bboxes(fvi, valid),
            kd.deftet_topk(pc, rr, fz, fvi, valid, 12, 1e-8),
            kd.deftet_topk_plain(pc, rr, fz, fvi, valid, 12, 1e-8))


@entry('kernels.spc_traverse.traverse', 'kernels.spc_traverse.traverse_plain',
       'kernels.spc_traverse.capacities')
def _traverse_kernels(t):
    kst = kt.kernels.spc_traverse
    octree, _, exsum, ph, o, d, _ = _trace_scene(t)
    return (kst.traverse(octree, exsum, ph, o, d, 4, True),
            kst.traverse_plain(octree, exsum, ph, o, d, 4, True),
            kst.traverse(octree, exsum, ph, o, d, 4, False, 500),
            kst.capacities(o.shape[0], 4), kst.capacities(o.shape[0], 4, 99))


# ============================================================== parallel

@entry('parallel.mesh.make_mesh', 'parallel.mesh.axis',
       'parallel.mesh.flat_index', 'parallel.mesh.replicate',
       'parallel.mesh.mesh_sum', 'parallel.render.sharded_rasterize',
       'parallel.render.sharded_dibr_rasterization', world=True, grad=True,
       **SOFT_GRAD)
def _sharded_render(t):
    pm = kt.parallel.mesh
    mesh = pm.make_mesh()
    fvc, fvi, fn = _prepared(t, grad=True)
    x, = pm.replicate(mesh, t.normal(3, grad=True))
    return (pm.axis(mesh, 'pix'), pm.flat_index(mesh), pm.mesh_sum(mesh, x),
            kt.parallel.render.sharded_rasterize(
                mesh, RES, RES, fvc[..., 2], fvi, fvc, fn[..., 2] >= 0.),
            kt.parallel.render.sharded_dibr_rasterization(
                mesh, RES, RES, fvc[..., 2], fvi, fvc, fn[..., 2]))


@entry('parallel.metrics.sharded_sided_distance',
       'parallel.metrics.sharded_chamfer_distance',
       'parallel.metrics.sharded_point_to_mesh_distance', world=True,
       grad=True)
def _sharded_metrics(t):
    mesh = kt.parallel.mesh.make_mesh()
    p1, p2 = _cloud(t, 2, 40, grad=True), _cloud(t, 2, 60, grad=True)
    verts, faces, *_ = _mesh(t)
    fv = kt.ops.mesh.index_vertices_by_faces(verts, faces)
    pm = kt.parallel.metrics
    return (pm.sharded_sided_distance(mesh, p1, p2),
            pm.sharded_chamfer_distance(mesh, p1, p2),
            pm.sharded_point_to_mesh_distance(mesh, p1, fv))


@entry('parallel.spc.plan_sharded_raytrace', 'parallel.spc.sharded_raytrace',
       world=True)
def _sharded_raytrace(t):
    mesh = kt.parallel.mesh.make_mesh()
    octree, _, exsum, ph, o, d, fn = _trace_scene(t)
    sched, cap = kt.parallel.spc.plan_sharded_raytrace(1, octree, ph, exsum,
                                                       o, d, 4)
    return sched, cap, kt.parallel.spc.sharded_raytrace(
        mesh, octree, ph, exsum, o, d, 4, cap, with_exit=True, ray_fn=fn)


# ================================================================= utils

@entry('utils.interop.icosphere', 'utils.interop.dibr_params_from_numpy',
       'utils.interop.extrinsics_from_numpy',
       'utils.interop.intrinsics_from_numpy',
       'utils.interop.texture_from_numpy', 'utils.interop.scene',
       'utils.interop.pointclouds_from_numpy', 'utils.interop.mesh_from_numpy',
       'utils.interop.spc_from_numpy', 'utils.interop.sphere_shell_spc',
       'utils.interop.load_params')
def _interop_carriers(t):
    it = kt.utils.interop
    v, f = it.icosphere(1)
    rng = t.rng
    layer = kt.ops.gcn.GraphConv(3, 2, device=t.device)
    params = {k: rng.normal(size=tuple(p.shape)).astype(np.float32)
              for k, p in layer.named_parameters()}
    return (it.dibr_params_from_numpy(v[None], f, np.eye(3)[None],
                                      np.ones((1, 3)), np.ones((3, 1)),
                                      device=t.device),
            it.extrinsics_from_numpy(rng.normal(size=(2, 4, 4)),
                                     'matrix_se3', device=t.device)
            .view_matrix(),
            it.intrinsics_from_numpy(np.asarray([[40., 40., 0., 0.]]), 32,
                                     24, device=t.device).projection_matrix(),
            it.texture_from_numpy(rng.normal(size=(1, 3, 4, 4)),
                                  rng.random((5, 2)), device=t.device),
            it.scene(2, 1, device=t.device),
            it.pointclouds_from_numpy(rng.normal(size=(1, 5, 3)),
                                      device=t.device),
            it.mesh_from_numpy(v, f, device=t.device),
            it.sphere_shell_spc(level=3, n=200, device=t.device),
            it.load_params(layer, params))


@entry('utils.interop.textured_scene', 'utils.interop.textured_maps',
       'utils.interop.textured_render', 'utils.interop.textured_loss',
       tol=1e-4, grad=True,
       why='the loss sums over pixels and faces; float32 sums taken in '
           'another order on the card')
def _interop_textured(t):
    it = kt.utils.interop
    s = it.textured_scene(2, 1, 8, device=t.device)
    verts = t(s['vertices'].cpu().numpy(), grad=True)
    tex = t(s['texture'].cpu().numpy(), grad=True)
    args = (s['cam_params'], s['faces'], s['face_uvs'], s['cam_proj'])
    img = it.textured_render(verts, tex, *args, RES, RES)
    return (it.textured_maps(verts, s['cam_params'], s['faces'],
                             s['face_uvs'], s['cam_proj'], RES, RES), img,
            it.textured_loss(verts, tex, *args, torch.zeros_like(img)))


@entry('utils.interop.metrics_scene', 'utils.interop.near_plane_scene',
       'utils.interop.metrics_step', 'utils.interop.ellipsoid_points',
       'utils.interop.mesh_fit_loss', 'utils.interop.deftet_scene',
       'utils.interop.deftet_loss', tol=1e-4, grad=True,
       why='the losses are means over points and faces; float32 sums '
           'taken in another order on the card')
def _interop_scenes(t):
    it = kt.utils.interop
    p, p2, fv = it.metrics_scene(n1=100, n2=120, num_faces=30,
                                 device=t.device)
    near = it.near_plane_scene(num_points=50, num_faces=20, device=t.device)
    gen = torch.Generator().manual_seed(5)
    target = it.ellipsoid_points(200, subdiv=1, generator=gen,
                                 device=t.device)
    v, f = it.icosphere(1)
    verts = t(v[None], grad=True)
    pc, rr, fz, fvi, feat = it.deftet_scene(side=8, num_faces=30,
                                            device=t.device)
    fvi = t(fvi.cpu().numpy(), grad=True)
    return (p, p2, fv, near, it.metrics_step(p, p2, fv), target,
            it.mesh_fit_loss(verts, t(f), target, 100, 0.1,
                             generator=torch.Generator().manual_seed(6)),
            it.deftet_loss(pc, rr, fz, fvi, feat, knum=8))


@entry('utils.testing.check_tensor', 'utils.testing.check_packed_tensor',
       'utils.testing.check_padded_tensor', 'utils.testing.check_spc_octrees',
       'utils.testing.tensor_info', 'utils.testing.contained_allclose',
       'utils.testing.contained_torch_equal', 'utils.testing.with_seed')
def _testing(t):
    ut = kt.utils.testing
    x = t.normal(3, 4)
    octree, lengths, *_ = _spc(t)
    state = kt.ops.random.get_state()
    try:
        seeded = ut.with_seed(7)(lambda: kt.ops.random.random_tensor(
            0., 1., (3,), device=t.device))()
    finally:
        kt.ops.random.set_state(state)
    return (ut.check_tensor(x, (3, 4), torch.float32),
            ut.check_packed_tensor(x, 3, 4, torch.float32),
            ut.check_padded_tensor(x[None], padding_value=0.,
                                   batch_size=1, throw=False),
            ut.check_spc_octrees(octree, lengths, 1, 3),
            ut.tensor_info(x, 'x', print_stats=True, detailed=True)
            .replace(str(x.device), 'DEVICE'),
            ut.contained_allclose([x, {'a': x}], [x, {'a': x + 1e-9}]),
            ut.contained_torch_equal((x, [x]), (x, [x])), seeded)


@entry('kernels._build.check_shapes')
def _check_shapes(t):
    x = t.normal(2, 3)
    kt.kernels._build.check_shapes('coverage', x, (2, 3), x[0], (3,))
    try:
        kt.kernels._build.check_shapes('coverage', x, (3, 2))
    except ValueError as e:
        return str(e)
    raise AssertionError('check_shapes took a wrong shape')


@entry('casts.to_int')
def _to_int(t):
    v = t(np.asarray([np.nan, np.inf, -np.inf, 3e9, -3e9, 0.5, -1.5, 2.5,
                      1e19, 40000.]))
    return [kt.casts.to_int(v, d) for d in (torch.int16, torch.int32,
                                             torch.int64, torch.uint8)]


# ============================================================ the examples

@entry('examples.fish.make_spline', 'examples.fish.spline_ys',
       'examples.fish.spline_ys_lod', 'examples.fish.negative_ys_loss',
       'examples.fish.card_topology', 'examples.fish.make_body_params',
       'examples.fish.fish_body_vertices', 'examples.fish.position_by_uv',
       'examples.fish.make_fin_params', 'examples.fish.fish_fin_vertices',
       'examples.fish.uv_bound_loss', 'examples.fish.uv_grid_boxes',
       'examples.fish.FishMesh', 'examples.fish.params_from_numpy',
       'examples.fish.texture_from_numpy', 'examples.fish.self_fit_hyper',
       'examples.spline.h_poly', 'examples.spline.interp_func_with_tangent',
       'examples.spline.natural_cubic_spline', grad=True)
def _fish_model(t):
    fish = kt.examples.fish
    sp = fish.make_spline(4, device=t.device)
    body = fish.make_body_params(4, device=t.device)
    for k in ('origin_xy', 'length_x'):
        body[k] = t(body[k].cpu().numpy(), grad=True)
    bv = fish.fish_body_vertices(body, 8, 4)
    fin = fish.make_fin_params(4, device=t.device)
    fv = fish.fish_fin_vertices(fin, bv, (8, 4), 6, 3, z_scale=0.1)
    faces, uvs, face_uvs_idx = fish.card_topology(8, 4)
    mesh = fish.FishMesh(bv, t(faces), t(uvs), t(face_uvs_idx),
                         fish.uv_grid_boxes(2)[0])
    xs = t(np.linspace(0., 1., 5))
    ys = t.normal(5, grad=True)
    return (sp, fish.spline_ys(sp, t.uniform(7, lo=0., hi=1.)),
            fish.spline_ys_lod(sp, 8), fish.negative_ys_loss(sp, 8), bv,
            fish.position_by_uv(bv, 8, 4, t.uniform(9, 2, lo=-0.1, hi=1.1)),
            fv, fish.uv_bound_loss(fin), fish.uv_grid_boxes(5), mesh,
            fish.params_from_numpy({'a': np.ones(3, np.float32)},
                                   device=t.device),
            fish.texture_from_numpy(t.rng.random((4, 4, 3)), device=t.device),
            fish.self_fit_hyper(),
            kt.examples.spline.h_poly(t.uniform(6, lo=0., hi=1.)),
            kt.examples.spline.interp_func_with_tangent(
                xs, ys, t.normal(5), t.uniform(8, lo=0., hi=1.)),
            kt.examples.spline.natural_cubic_spline(
                xs, ys, t.uniform(8, lo=0., hi=1.)))


@entry('examples.fish.synthetic_data')
def _fish_data(t):
    return kt.examples.fish.synthetic_data(res=32, lod_x=8, lod_y=4,
                                           device=t.device)


# Adam's steps turn rounding-level differences of a gradient into +-lr
# moves (on the demo's symmetric scene, origin_x's), and marching
# tetrahedra moves a sample to another face on a rounding: the fits' runs
# are checked here, their first steps card against CPU by examples_phase
FIT_RUN = dict(runs_only=True, why="a fit: Adam and marching tetrahedra "
                                   "turn rounding into different steps; "
                                   "examples_phase holds the first steps")


@entry('examples.fish.fit_fish', 'examples.fish.body_iou',
       'examples.fish.synthetic_self_fit', **FIT_RUN)
def _fish_fit(t):
    fish = kt.examples.fish
    data, gt = fish.synthetic_data(res=32, lod_x=8, lod_y=4, device=t.device)
    hyper = fish.self_fit_hyper(lod_x=8, lod_y=4, texture_res=8, epochs=2,
                                texture_epochs=1)
    body, fins, texture = fish.fit_fish(data, hyper, device=t.device)[:3]
    return (body, fins, texture, fish.body_iou(body, gt, hyper),
            fish.synthetic_self_fit(res=32, epochs=2, lod_x=8, lod_y=4,
                                    texture_res=8, texture_epochs=1,
                                    device=t.device))


def _decoder(t):
    dm = kt.examples.dmtet_train
    return dm.init_decoder(torch.Generator().manual_seed(0),
                           internal_dims=16, hidden=2, device=t.device)


@entry('examples.dmtet_train.positional_encoding',
       'examples.dmtet_train.Decoder', 'examples.dmtet_train.init_decoder',
       'examples.dmtet_train.decoder_from_numpy',
       'examples.dmtet_train.decoder_apply',
       'examples.dmtet_train.laplace_regularizer',
       'examples.dmtet_train.clip_by_global_norm_',
       'examples.dmtet_train.torus_points', grad=True)
def _dmtet_parts(t):
    dm = kt.examples.dmtet_train
    dec = _decoder(t)
    dec2 = dm.decoder_from_numpy({'w': [
        t.rng.normal(size=(15, 16)) * 0.2, t.rng.normal(size=(16, 16)) * 0.2,
        t.rng.normal(size=(16, 4)) * 0.2]}, device=t.device)
    x = t.uniform(20, 3, lo=-0.5, hi=0.5, grad=True)
    grads = [t.normal(*p.shape) for p in dec.parameters()]
    for p, g in zip(dec.parameters(), grads):
        p.grad = g
    norm = dm.clip_by_global_norm_(list(dec.parameters()), 0.5)
    verts, faces, *_ = _mesh(t)
    verts = t(verts.cpu().numpy(), grad=True)
    lap = dm.laplace_regularizer(verts[0], faces,
                                 torch.ones(faces.shape[0], dtype=torch.bool,
                                            device=t.device))
    return (dm.positional_encoding(x, 2), dm.decoder_apply(dec2, x),
            dec(x), norm, [p.grad for p in dec.parameters()], lap,
            t(dm.torus_points(300)))


@entry('examples.dmtet_train.pre_train_sphere',
       'examples.dmtet_train.dmtet_loss',
       'examples.dmtet_train.dmtet_optimizer',
       'examples.dmtet_train.dmtet_step', 'examples.dmtet_train.train_dmtet',
       **FIT_RUN)
def _dmtet_fit(t):
    dm = kt.examples.dmtet_train
    gen = torch.Generator().manual_seed(0)
    dec, pre_loss = dm.pre_train_sphere(_decoder(t), gen, steps=2)
    gv, gt = kt.ops.conversions.tet_grid(4)
    tv, tets = t(gv), t(gt)
    target = t(dm.torus_points(500))
    opt, sched = dm.dmtet_optimizer(dec)
    loss = dm.dmtet_step(dec, opt, sched, tv, tets, target[None], gen,
                         grid_res=4, num_samples=100)
    l2 = dm.dmtet_loss(dec, tv, tets, target[None], gen, grid_res=4,
                       num_samples=100)
    trained, hist = dm.train_dmtet(target, grid_res=4, iterations=2,
                                   num_samples=100, device=t.device)
    return pre_loss, loss, l2, hist, trained


@entry('examples.dibr_train.icosphere', 'examples.dibr_train.make_cameras',
       'examples.dibr_train.render_views', 'examples.dibr_train.main',
       'examples.nglod_train.sdf_gt', 'examples.nglod_train.main',
       tol=1e-4, why='a few Adam steps of a fit; float32 sums taken in '
                     'another order on the card')
def _trainers(t):
    dt, ng = kt.examples.dibr_train, kt.examples.nglod_train
    v, f = dt.icosphere(1)
    rot, trans, proj = dt.make_cameras(2, device=t.device)
    verts, faces = t(v[None]), t(f)
    fuv = t.uniform(1, f.shape[0], 3, 2, lo=0., hi=1.)
    return (rot, trans, proj,
            dt.render_views(verts, faces, fuv, t.uniform(1, 3, 8, 8, lo=0.,
                                                         hi=1.),
                            rot, trans, proj, 16),
            _quiet(dt.main, steps=2, res=16, num_views=2, device=t.device),
            ng.sdf_gt(t.uniform(10, 3)),
            _quiet(ng.main, level=3, steps=2, render_res=8, device=t.device))


@entry('examples.renderer.TexturedMesh', 'examples.renderer.Renderer',
       'examples.spline_mesh.make_ring_topology',
       'examples.spline_mesh.spline_body_mesh', 'examples.utils.check_device',
       'examples.utils.linspace', 'examples.utils.uniform',
       'examples.utils.sample_points',
       'examples.utils.get_camera_transform_from_view',
       'examples.utils.get_camera_projection',
       'examples.utils.recenter_vertices',
       'examples.visualize_main.normalize_vertices', grad=True)
def _example_utils(t):
    eu = kt.examples.utils
    v, f = kt.utils.interop.icosphere(1)
    uvs = t.uniform(v.shape[0], 2, lo=0., hi=1.)
    mesh = kt.examples.renderer.TexturedMesh(
        t(v[None] * 0.5, grad=True), t(f), uvs[None], t(f), texture_res=8)
    r = kt.examples.renderer.Renderer(2, (RES, RES))
    topo = kt.examples.spline_mesh.make_ring_topology(6, 5)
    body = kt.examples.spline_mesh.spline_body_mesh(
        t(np.linspace(0., 1., 4)), t.uniform(4, lo=0.1, hi=0.3, grad=True),
        t.uniform(4, lo=0.1, hi=0.3, grad=True), n_axial=6, n_radial=5)
    gen = torch.Generator().manual_seed(8)
    return (r.render_image_and_mask_with_camera_params(
                30., 45., 3., 0., 45., mesh),
            topo, body, eu.check_device(t.device),
            eu.linspace(0., 2., 5, t.device),
            eu.uniform(gen, (4, 2), t.device),
            eu.sample_points(t(v[None]), t(f), 20, gen),
            eu.get_camera_transform_from_view(20., 70., device=t.device),
            eu.get_camera_projection(45., device=t.device),
            eu.recenter_vertices(t(v[None]), t([[0.1, 0.2, 0.3]])),
            kt.examples.visualize_main.normalize_vertices(t(v[None] * 3.)))


RECIPES = ('camera.camera_coordinate_systems', 'camera.camera_init_explicit',
           'camera.camera_init_simple', 'camera.camera_movement',
           'camera.camera_opengl_shaders', 'camera.camera_properties',
           'camera.camera_ray_tracing', 'camera.camera_transforms',
           'camera.cameras_differentiable', 'dataload.spc_from_pointcloud',
           'preprocess.fast_mesh_sampling', 'preprocess.occupancy_sampling',
           'spc.spc_basics', 'spc.spc_conv3d_example', 'spc.spc_dual_octree',
           'spc.spc_trilinear_interp')


@entry(*(f'examples.recipes.{r}.main' for r in RECIPES),
       'examples.recipes.camera.camera_ray_tracing.generate_pixel_grid',
       'examples.recipes.camera.camera_ray_tracing.generate_perspective_rays',
       'examples.recipes.spc.spc_conv3d_example.encode', runs_only=True,
       why='the recipes print what they show; their run is what is checked')
def _recipes(t):
    out = {}
    for r in RECIPES:
        mod = importlib.import_module(f'kaolin_tpu_torch.examples.recipes.{r}')
        _quiet(mod.main, ['--device', str(t.device)])
        out[r] = True
    return out


# ================================================== the other I/O helpers

@entry('experimental.dash3d.util.meshes_to_binary',
       'experimental.dash3d.util.point_clouds_to_binary',
       'experimental.dash3d.util.decode_binary_message')
def _dash3d_payloads(t):
    u = kt.experimental.dash3d.util
    verts, faces, *_ = _mesh(t)
    mesh = u.meshes_to_binary([verts[0], verts[1]], [faces, faces])
    pts = u.point_clouds_to_binary([_cloud(t, 1, 20)[0]])
    head = np.asarray([1, 0, 0, 0], np.int32).tobytes()
    return mesh, pts, u.decode_binary_message(head + mesh)


@entry('io.materials.PBRMaterial', 'io.materials.Material')
def _materials(t):
    mat = kt.io.materials.PBRMaterial(
        diffuse_color=(0.2, 0.3, 0.4), roughness_value=0.5,
        diffuse_texture=t.uniform(3, 4, 4, lo=0., hi=1.))
    return mat.to_dict()


@entry('io.utils.heterogeneous_mesh_handler_naive_homogenize',
       'io.utils.heterogeneous_mesh_handler_empty',
       'io.utils.heterogeneous_mesh_handler_skip', 'io.obj.flatten_feature')
def _mesh_handlers(t):
    h = kt.io.utils
    verts = t.normal(6, 3)
    counts = np.asarray([4, 3])
    idx = np.asarray([0, 1, 2, 3, 3, 4, 5])
    return (h.heterogeneous_mesh_handler_naive_homogenize(verts, counts, idx),
            h.heterogeneous_mesh_handler_empty(verts, counts, idx),
            h.heterogeneous_mesh_handler_skip(verts, counts, idx),
            kt.io.obj.flatten_feature([[1, 2], [3]]))



# ======================================================= names left out

_PATH_IO = ("path-based I/O: reads or writes files; chip_smoke.py's io and "
            "usd phases run it with tensors on the card")
_DATASET = 'a dataset class: needs its files on disk'
_ERROR = 'an error class or an error handler: takes no tensor'
_BUILD = ('kernel build and launch plumbing: takes no tensor, or raises on '
          'CPU tensors by design; every kernel entry runs it on the card')
_HOST = ("the host library: numpy in, numpy out (module_phases hold it "
         "against the numpy versions on the card's machine)")
_PROCESS = ("starts or joins processes, no tensor: chip_smoke.py's "
            "parallel phases run it")
_REGISTRY = 'registers camera backends by name: takes no tensor'
_SERVER = 'the dash3d viewer: a web server over a log directory'

EXCLUDED = {
    **dict.fromkeys((
        'io.obj.import_mesh', 'io.obj.load_mtl', 'io.obj.return_type',
        'io.off.import_mesh', 'io.off.return_type',
        'io.render.import_synthetic_view', 'io.usdc.is_usdc',
        'io.usdc.write_usdc', 'io.usdc.read_usdc',
        'io.usd.mesh_return_type', 'io.usd.pointcloud_return_type',
        'io.usd.Stage', 'io.usd.create_stage', 'io.usd.get_scene_paths',
        'io.usd.add_mesh', 'io.usd.export_mesh', 'io.usd.export_meshes',
        'io.usd.import_mesh', 'io.usd.import_meshes', 'io.usd.add_pointcloud',
        'io.usd.export_pointcloud', 'io.usd.import_pointcloud',
        'io.usd.import_pointclouds', 'io.usd.export_pointclouds',
        'io.usd.add_voxelgrid', 'io.usd.export_voxelgrid',
        'io.usd.import_voxelgrid', 'io.usd.import_voxelgrids',
        'io.usd.export_voxelgrids', 'io.usd.get_root',
        'io.usd.get_pointcloud_scene_paths',
        'io.usd.get_authored_time_samples',
        'io.usd.get_pointcloud_bracketing_time_samples',
        'io.usd.add_material', 'io.usd.import_material',
        'utils.checkpoint.save_pytree', 'utils.checkpoint.load_pytree',
        'utils.checkpoint.CheckpointManager', 'visualize.timelapse.Timelapse',
        'visualize.timelapse.TimelapseParser',
        'experimental.dash3d.util.StreamingGeometryHelper',
        'examples.fish.fish_params_to_json',
        'examples.fish.fish_params_from_json',
        'examples.utils.load_synthetic_views',
        'examples.visualize_main.emulate_training_timelapse'), _PATH_IO),
    **dict.fromkeys((
        'io.dataset.KaolinDatasetItem', 'io.dataset.Cache',
        'io.dataset.CachedDataset', 'io.dataset.KaolinDataset',
        'io.dataset.ProcessedDataset', 'io.dataset.CombinationDataset',
        'io.modelnet.ModelNet', 'io.shapenet.ShapeNetV1',
        'io.shapenet.ShapeNetV2', 'io.shrec.SHREC16'), _DATASET),
    **dict.fromkeys((
        'io.materials.MaterialError', 'io.materials.MaterialLoadError',
        'io.materials.MaterialFileError', 'io.materials.MaterialNotFoundError',
        'io.materials.MaterialNotSupportedError',
        'io.materials.MaterialWriteError', 'io.obj.ignore_error_handler',
        'io.obj.skip_error_handler', 'io.obj.default_error_handler',
        'io.utils.NonHomogeneousMeshError', 'parallel.launch.RankError'),
        _ERROR),
    **dict.fromkeys((
        'kernels._build.build_all', 'kernels._build.load',
        'kernels._build.launch', 'kernels._build.cuda_inputs',
        'kernels._build.stream', 'kernels._build.check_backend',
        'kernels._build.pixel_scale'),
        _BUILD),
    **dict.fromkeys((
        'native.get_lib', 'native.obj_parse_fast',
        'native.points_to_morton_fast',
        'native.morton_to_points_fast', 'native.voxelize_triangles_fast',
        'native.points_to_octree_fast'), _HOST),
    **dict.fromkeys((
        'parallel.distributed.init_distributed',
        'parallel.distributed.is_distributed', 'parallel.launch.run_ranks'),
        _PROCESS),
    'render.camera.extrinsics.register_backend': _REGISTRY,
    'tracing.span': 'a profiler span by name: takes no tensor',
    'io.materials.MaterialManager': ('a registry of USD and OBJ material '
                                     'readers: takes no tensor'),
    **dict.fromkeys((
        'experimental.dash3d.run.get_max_viewports',
        'experimental.dash3d.run.create_server',
        'experimental.dash3d.run.run_main'), _SERVER),
}


def table_names():
    """Every name the table's entries call."""
    return {n for e in ENTRIES for n in e.names}
