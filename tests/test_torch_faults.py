"""Faults of the port found against ``kaolin_tpu``, each held against it on
the CPU: renders of no faces, the keywords of ``kaolin_tpu``'s signatures,
``generate_points`` on a batch of octrees of mixed depth, and empty point
clouds.

- No faces: ``rasterize`` (the interp route at D=2, the select route at
  D=40), ``dibr_rasterization`` and ``deftet_sparse_render`` return the
  empty render, as ``kaolin_tpu`` with ``backend='xla'`` does: features 0,
  ``face_idx`` -1, the soft mask 0, DefTet's ids -1, and zero gradients.
  All values are exact.
- Signatures: every public function of ``kaolin_tpu_torch`` with a
  counterpart in ``kaolin_tpu`` takes the same parameter names in the same
  order, but for the deliberate differences listed in ``DELIBERATE``.
- ``generate_points``: each octree of a batch is read at its own depth;
  the batch equals ``kaolin_tpu``'s ``generate_points`` of each octree
  alone, concatenated. (``kaolin_tpu`` reads every octree at the deepest
  one's byte count, so on such a batch the two packages differ, and the
  port is the right one.)
- Empty clouds: ``sided_distance``, ``chamfer_distance`` and ``f_score``
  raise ``ValueError`` naming the empty argument.
"""

import importlib
import inspect
import pkgutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import kaolin_tpu as kal
import kaolin_tpu_torch as kt

B, H, W = 2, 8, 8


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _eq(ref, out):
    ref = np.asarray(ref)
    out = out.detach().numpy() if torch.is_tensor(out) else np.asarray(out)
    assert ref.shape == out.shape and ref.dtype == out.dtype
    np.testing.assert_array_equal(ref, out)


def _no_faces(dim):
    rng = np.random.default_rng(0)
    cot = rng.standard_normal((B, H, W, dim))
    return (np.zeros((B, 0, 3)), np.zeros((B, 0, 3, 2)),
            np.zeros((B, 0, 3, dim)), cot)


@pytest.mark.parametrize('dim', [2, 40])
def test_rasterize_no_faces(dim):
    """D=2 takes the interp route (14 + 3D <= 128), D=40 the select
    route; both give the empty render and zero gradients."""
    fvz, fvi, ff, cot = _no_faces(dim)

    def jloss(fvi_, ff_):
        feat, _ = kal.render.mesh.rasterize(H, W, fvz, fvi_, ff_,
                                            backend='xla')
        return jnp.sum(feat * cot)

    ref_feat, ref_idx = kal.render.mesh.rasterize(H, W, fvz, fvi, ff,
                                                  backend='xla')
    ref_grads = jax.grad(jloss, argnums=(0, 1))(fvi, ff)
    tv, tf = _t(fvi, True), _t(ff, True)
    feat, idx = kt.render.mesh.rasterize(H, W, _t(fvz), tv, tf)
    _eq(ref_feat, feat)
    _eq(ref_idx, idx)
    for ref, out in zip(ref_grads, torch.autograd.grad(
            (feat * _t(cot)).sum(), [tv, tf])):
        _eq(ref, out)


def test_dibr_rasterization_no_faces():
    fvz, fvi, ff, cot = _no_faces(2)
    fn = np.zeros((B, 0))
    kw = dict(rast_backend='xla', mask_backend='xla')

    def jloss(fvi_, ff_):
        feat, mask, _ = kal.render.mesh.dibr_rasterization(
            H, W, fvz, fvi_, ff_, fn, **kw)
        return jnp.sum(feat * cot) + jnp.sum(mask * cot[..., 0])

    ref = kal.render.mesh.dibr_rasterization(H, W, fvz, fvi, ff, fn, **kw)
    ref_grads = jax.grad(jloss, argnums=(0, 1))(fvi, ff)
    tv, tf = _t(fvi, True), _t(ff, True)
    out = kt.render.mesh.dibr_rasterization(H, W, _t(fvz), tv, tf, _t(fn))
    for r, o in zip(ref, out):
        _eq(r, o)
    loss = (out[0] * _t(cot)).sum() + (out[1] * _t(cot[..., 0])).sum()
    for r, o in zip(ref_grads, torch.autograd.grad(loss, [tv, tf])):
        _eq(r, o)


def test_deftet_no_faces():
    """16 pixels, ``knum`` 3: every slot -1, the features 0, the gradients
    to the faces 0 (empty) and to the pixel coords 0. ``kaolin_tpu``'s
    gradient to the pixel coords is NaN there (its gather clamps into no
    faces and the weights divide 0 by 0), so the port's is held to 0."""
    rng = np.random.default_rng(1)
    pc = rng.uniform(-1, 1, (B, 16, 2))
    rr = np.tile([[-np.inf, 0.]], (B, 16, 1))
    fvz, fvi, ff = np.zeros((B, 0, 3)), np.zeros((B, 0, 3, 2)), \
        np.zeros((B, 0, 3, 2))
    cot = rng.standard_normal((B, 16, 3, 2))

    def jloss(pc_, fvi_, ff_):
        feat, _ = kal.render.mesh.deftet_sparse_render(
            pc_, rr, fvz, fvi_, ff_, knum=3, backend='xla')
        return jnp.sum(feat * cot)

    ref_feat, ref_idx = kal.render.mesh.deftet_sparse_render(
        pc, rr, fvz, fvi, ff, knum=3, backend='xla')
    ref_grads = jax.grad(jloss, argnums=(0, 1, 2))(pc, fvi, ff)
    tp, tv, tf = _t(pc, True), _t(fvi, True), _t(ff, True)
    feat, idx = kt.render.mesh.deftet_sparse_render(tp, _t(rr), _t(fvz), tv,
                                                    tf, knum=3)
    _eq(ref_feat, feat)
    _eq(ref_idx, idx)
    grads = torch.autograd.grad((feat * _t(cot)).sum(), [tp, tv, tf])
    assert np.isnan(np.asarray(ref_grads[0])).any()
    _eq(np.zeros_like(pc), grads[0])
    for ref, out in zip(ref_grads[1:], grads[1:]):
        _eq(ref, out)


# The deliberate differences between the two packages' signatures, by the
# function's path below the package: (parameters only the port takes,
# parameters only kaolin_tpu takes, kaolin_tpu's name -> the port's).
_DEVICE = ({'device'}, set(), {})
DELIBERATE = {
    # ``device=``: these make tensors from no input tensor, so the caller
    # names the device (the port's default is 'cuda'; JAX places arrays on
    # its default device itself)
    **dict.fromkeys((
        'ops.batch.segment_ids_from_numel',
        'ops.conversions.sdf.sdf_to_voxelgrids',
        'ops.mesh.mesh.adjacency_matrix',
        'ops.mesh.mesh.uniform_laplacian',
        'ops.spc.points.create_dense_spc',
        'render.camera.coordinates.blender_coords',
        'render.camera.coordinates.opengl_coords',
        'render.camera.extrinsics.CameraExtrinsics.from_view_matrix',
        'render.camera.extrinsics.CameraExtrinsics.from_camera_pose',
        'render.camera.extrinsics.CameraExtrinsics.from_lookat',
        'render.camera.intrinsics_ortho.OrthographicIntrinsics.from_frustum',
        'render.camera.intrinsics_pinhole.PinholeIntrinsics.from_focal',
        'render.camera.intrinsics_pinhole.PinholeIntrinsics.from_fov',
        'render.camera.legacy.generate_perspective_projection',
        'render.lighting.sh.project_onto_sh9',
        'render.spc.raytrace.generate_primary_rays',
        'render.spc.raytrace.primary_rays_fn',
        'render.spc.raytrace.primary_rays_fn_cols',
        'rep.spc.Spc.make_dense',
        'ops.random.random_tensor',
        'ops.random.sample_spherical_coords',
        'ops.random.random_spc_octrees',
        # the loaders: a tensor lands on the device the caller names
        'io.obj.import_mesh',
        'io.obj.load_mtl',
        'io.off.import_mesh',
        'io.render.import_synthetic_view',
        'io.materials.PBRMaterial.from_dict',
        'io.materials.PBRMaterial.read_from_obj',
        'io.modelnet.ModelNet.__init__',
        'io.shapenet.ShapeNetV1.__init__',
        'io.shapenet.ShapeNetV2.__init__',
        'io.shrec.SHREC16.__init__',
        'utils.checkpoint.load_pytree',
        'utils.checkpoint.CheckpointManager.restore',
        'io.usd.import_mesh',
        'io.usd.import_meshes',
        'io.usd.import_pointcloud',
        'io.usd.import_pointclouds',
        'io.usd.import_voxelgrid',
        'io.usd.import_voxelgrids',
        'io.usd.import_material',
        'io.materials.PBRMaterial.read_from_usd',
        'io.materials.MaterialManager.read_usd_material'), _DEVICE),
    # the process group's backend: 'nccl' for the card, 'gloo' where the
    # caller asks for it (JAX picks its runtime itself)
    'parallel.distributed.init_distributed': ({'backend'}, set(), {}),
    # the layers are nn.Modules: the weights are drawn at construction
    # (from a torch.Generator, where JAX's ``init`` takes a key), in the
    # dtype and on the device named there
    **dict.fromkeys((
        'ops.gcn.GraphConv.__init__',
        'ops.spc.convolution.Conv3d.__init__',
        'ops.spc.convolution.ConvTranspose3d.__init__'),
        ({'generator', 'dtype', 'device'}, set(), {})),
    # a torch.Generator in place of JAX's PRNG key, at the same place
    'ops.mesh.trianglemesh.sample_points': (set(), set(),
                                            {'key': 'generator'}),
    'ops.mesh.trianglemesh.packed_sample_points': (set(), set(),
                                                   {'key': 'generator'}),
    # ``interpret`` runs a Pallas kernel in Pallas's interpreter; the
    # port's kernels have no such mode (a CPU tensor takes the plain
    # version)
    'kernels.nn_distance.nearest_idx_pruned': (set(), {'interpret'}, {}),
    'kernels.texture.grid_sample_coords': (set(), {'interpret'}, {}),
}


def _counterparts():
    """(path, port function, kaolin_tpu function) for every public
    function and public method of a public class of ``kaolin_tpu_torch``
    whose module and name ``kaolin_tpu`` also has; a module without
    ``__all__`` offers the public functions and classes it defines. A
    ``__main__`` module is not imported (``kaolin_tpu``'s dash3d one
    starts its server)."""
    pairs = []
    for info in pkgutil.walk_packages(kt.__path__, 'kaolin_tpu_torch.'):
        if info.name.rpartition('.')[2] == '__main__':
            continue
        mod = importlib.import_module(info.name)
        rel = info.name[len('kaolin_tpu_torch.'):]
        try:
            jmod = importlib.import_module('kaolin_tpu.' + rel)
        except ImportError:
            continue
        names = getattr(mod, '__all__', None)
        if names is None:
            names = [n for n, o in vars(mod).items()
                     if not n.startswith('_')
                     and getattr(o, '__module__', None) == mod.__name__
                     and (inspect.isroutine(o) or isinstance(o, type))]
        for name in names:
            obj, jobj = getattr(mod, name), getattr(jmod, name, None)
            if jobj is None:
                continue
            if isinstance(obj, type):
                for meth in ('__init__', *(m for m in vars(obj)
                                           if not m.startswith('_'))):
                    a, b = getattr(obj, meth, None), getattr(jobj, meth, None)
                    if inspect.isroutine(a) and inspect.isroutine(b):
                        pairs.append((f'{rel}.{name}.{meth}', a, b))
            elif inspect.isroutine(obj):
                pairs.append((f'{rel}.{name}', obj, jobj))
    return pairs


def _params(fn):
    try:
        return list(inspect.signature(fn).parameters)
    except ValueError:       # a builtin without a signature
        return None


def test_signatures_match_kaolin_tpu():
    pairs = _counterparts()
    assert len(pairs) > 100, 'the walk found too few counterparts'
    seen = set()
    for path, fn, jfn in pairs:
        port, ref = _params(fn), _params(jfn)
        if port is None or ref is None:
            continue
        added, dropped, renamed = DELIBERATE.get(path, (set(), set(), {}))
        expected = [renamed.get(p, p) for p in ref if p not in dropped]
        got = [p for p in port if p not in added]
        assert got == expected, (f'{path}: the port takes {port}, '
                                 f'kaolin_tpu {ref}')
        assert added <= set(port), f'{path}: lacks {added - set(port)}'
        seen.add(path)
    assert set(DELIBERATE) <= seen, ('listed but not found: '
                                     f'{set(DELIBERATE) - seen}')


def test_signatures_cover_io_and_viewer():
    """The USD modules, ``Timelapse`` and the dash3d viewer are among the
    functions the signature check holds."""
    paths = {path for path, _, _ in _counterparts()}
    for path in ('io.usd.export_mesh', 'io.usd.import_voxelgrid',
                 'io.usd.add_material', 'io.usdc.write_usdc',
                 'io.usdc.read_usdc',
                 'visualize.timelapse.Timelapse.add_mesh_batch',
                 'visualize.timelapse.TimelapseParser.check_for_updates',
                 'experimental.dash3d.run.create_server',
                 'experimental.dash3d.util.meshes_to_binary',
                 'experimental.dash3d.util.StreamingGeometryHelper.'
                 'parse_encode_mesh'):
        assert path in paths, path


def test_voxel_order_matches_kaolin_tpu():
    """``render.spc.raytrace`` exports ``VOXEL_ORDER``, kaolin_tpu's
    table, as the one the traversal kernel's module holds."""
    from kaolin_tpu_torch.kernels import spc_traverse
    from kaolin_tpu_torch.render.spc import raytrace
    assert raytrace.VOXEL_ORDER == kal.render.spc.raytrace.VOXEL_ORDER
    assert raytrace.VOXEL_ORDER is spc_traverse.VOXEL_ORDER
    assert len(raytrace.VOXEL_ORDER) == 8 and all(
        sorted(row) == list(range(8)) for row in raytrace.VOXEL_ORDER)


def _mesh_args(dim=2):
    fvz, fvi, ff, _ = _no_faces(dim)
    return _t(fvz), _t(fvi), _t(ff)


def _call_rasterize(backend):
    return kt.render.mesh.rasterize(H, W, *_mesh_args(), backend=backend)


def _call_dibr_soft_mask(backend):
    return kt.render.mesh.dibr_soft_mask(
        torch.zeros(B, 0, 3, 2, dtype=torch.float64),
        torch.full((B, H, W), -1, dtype=torch.int32), backend=backend)


def _call_dibr_rast(backend):
    return kt.render.mesh.dibr_rasterization(
        H, W, *_mesh_args(), torch.zeros(B, 0, dtype=torch.float64),
        rast_backend=backend)


def _call_dibr_mask(backend):
    return kt.render.mesh.dibr_rasterization(
        H, W, *_mesh_args(), torch.zeros(B, 0, dtype=torch.float64),
        mask_backend=backend)


def _call_grid_sample(backend):
    rng = np.random.default_rng(4)
    return kt.render.mesh.grid_sample_2d(
        _t(rng.random((1, 3, 4, 4))), _t(rng.uniform(-1, 1, (1, 2, 2, 2))),
        backend=backend)


def _call_deftet(backend):
    fvz, fvi, ff = _mesh_args()
    return kt.render.mesh.deftet_sparse_render(
        torch.zeros(B, 4, 2, dtype=torch.float64),
        torch.zeros(B, 4, 2, dtype=torch.float64), fvz, fvi, ff, knum=2,
        backend=backend)


def _clouds():
    rng = np.random.default_rng(2)
    return _t(rng.random((1, 5, 3))), _t(rng.random((1, 4, 3)))


def _call_sided(backend):
    return kt.metrics.pointcloud.sided_distance(*_clouds(), backend=backend)


def _call_p2m(backend):
    return kt.metrics.trianglemesh.point_to_mesh_distance(
        _clouds()[0], _t(np.random.default_rng(3).random((1, 2, 3, 3))),
        backend=backend)


def _dense_spc():
    octree, lengths = kt.ops.spc.create_dense_spc(2, device='cpu')
    _, pyr, exsum = kt.ops.spc.scan_octrees(octree, lengths)
    ph = kt.ops.spc.generate_points(octree, pyr, exsum)
    o = torch.tensor([[0.1, 0.2, -3.]], dtype=torch.float64)
    d = torch.tensor([[0., 0., 1.]], dtype=torch.float64)
    return octree, ph, pyr[0], exsum, o, d


def _call_raytrace(backend):
    octree, ph, pyr, exsum, o, d = _dense_spc()
    return kt.render.spc.unbatched_raytrace(octree, ph, pyr, exsum, o, d, 2,
                                            backend=backend)


def _call_raytrace_fixed(backend):
    octree, ph, _, exsum, o, d = _dense_spc()
    return kt.render.spc.unbatched_raytrace_fixed(
        octree, ph, exsum, o, d, 2, 16, backend=backend,
        banded_raw_rows=8)


# each function that takes ``backend`` (or ``rast_backend`` /
# ``mask_backend``), with the values kaolin_tpu's counterpart knows
BACKEND_CALLS = {
    'rasterize': (_call_rasterize, ('auto', 'xla', 'pallas')),
    'dibr_soft_mask': (_call_dibr_soft_mask, ('auto', 'xla', 'pallas')),
    'dibr_rasterization rast_backend': (_call_dibr_rast,
                                        ('auto', 'xla', 'pallas')),
    'dibr_rasterization mask_backend': (_call_dibr_mask,
                                        ('auto', 'xla', 'pallas')),
    'grid_sample_2d': (_call_grid_sample, ('auto', 'xla', 'pallas')),
    'deftet_sparse_render': (_call_deftet, (None, 'xla', 'pallas')),
    'sided_distance': (_call_sided, ('auto', 'xla', 'pallas',
                                     'pallas_pruned')),
    'point_to_mesh_distance': (_call_p2m, ('auto', 'xla', 'pallas')),
    'unbatched_raytrace': (_call_raytrace, ('auto', 'xla', 'banded')),
    'unbatched_raytrace_fixed': (_call_raytrace_fixed,
                                 ('auto', 'xla', 'banded')),
}


@pytest.mark.parametrize('name', sorted(BACKEND_CALLS))
def test_backend_keyword(name):
    """Each known value runs the plain version on the CPU and gives the
    same result; an unknown one raises ``ValueError``."""
    call, values = BACKEND_CALLS[name]
    first = call(values[0])
    for value in values[1:]:
        for a, b in zip(torch.utils._pytree.tree_leaves(first),
                        torch.utils._pytree.tree_leaves(call(value))):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match='backend'):
        call('tpu')


def _octree(level, n, seed):
    """Both packages' octree of ``n`` seeded points at ``level``."""
    pts = np.random.default_rng(seed).uniform(-1, 1, (n, 3))
    pts = pts.astype(np.float32)
    qj = kal.ops.spc.quantize_points(jnp.asarray(pts), level)
    oj = kal.ops.spc.unbatched_points_to_octree(qj, level)
    ot = kt.ops.spc.unbatched_points_to_octree(
        kt.ops.spc.quantize_points(torch.tensor(pts), level), level)
    _eq(oj, ot)
    return oj, ot


def _alone(oj):
    """``kaolin_tpu``'s point hierarchy of one octree."""
    _, pyr, exsum = kal.ops.spc.scan_octrees(oj, np.array([oj.shape[0]]))
    return np.asarray(kal.ops.spc.generate_points(oj, pyr, exsum))


MIXED = {'shallow first': ((2, 60, 7), (3, 40, 8)),
         'deep first': ((3, 40, 8), (2, 60, 7)),
         'level 2 alone': ((2, 60, 7),),
         'level 3 alone': ((3, 40, 8),)}


@pytest.mark.parametrize('case', sorted(MIXED))
def test_generate_points_mixed_depths(case):
    """A level-2 octree of 60 points and a level-3 one of 40, in both
    orders and each alone: the batch's hierarchy is each octree's
    (``kaolin_tpu`` on that octree alone), concatenated; so is
    ``Spc.point_hierarchies``."""
    octs = [_octree(*spec) for spec in MIXED[case]]
    ref = np.concatenate([_alone(oj) for oj, _ in octs])
    cat = torch.cat([ot for _, ot in octs])
    lengths = [ot.shape[0] for _, ot in octs]
    _, pyr, exsum = kt.ops.spc.scan_octrees(cat, np.array(lengths))
    _eq(ref, kt.ops.spc.generate_points(cat, pyr, exsum))
    _eq(ref, kt.rep.Spc(cat, lengths).point_hierarchies)


EMPTY = {
    'sided_distance': (kt.metrics.pointcloud.sided_distance, ('p1', 'p2')),
    'chamfer_distance': (kt.metrics.pointcloud.chamfer_distance,
                         ('p1', 'p2')),
    'f_score': (kt.metrics.pointcloud.f_score,
                ('gt_points', 'pred_points')),
}


@pytest.mark.parametrize('side', [0, 1])
@pytest.mark.parametrize('name', sorted(EMPTY))
def test_empty_cloud_raises(name, side):
    fn, names = EMPTY[name]
    clouds = [torch.rand(2, 5, 3), torch.rand(2, 4, 3)]
    clouds[side] = torch.zeros(2, 0, 3)
    with pytest.raises(ValueError, match=f'{names[side]} is empty'):
        fn(*clouds)


@pytest.mark.parametrize('mode', ['bilinear', 'nearest'])
def test_grid_sample_no_channels(mode):
    """A texture of no channels: ``kaolin_tpu``'s XLA path samples an empty
    (B, 0, h, w) and gives zero gradients to the grid; so does the port on
    the CPU, whose plain versions failed to reshape an empty texture."""
    rng = np.random.default_rng(0)
    maps = np.zeros((2, 0, 5, 7), np.float32)
    grid = rng.uniform(-1., 1., (2, 3, 4, 2)).astype(np.float32)

    def jloss(m, g):
        return jnp.sum(kal.render.mesh.utils.grid_sample_2d(
            m, g, mode, backend='xla'))

    ref = kal.render.mesh.utils.grid_sample_2d(
        jnp.asarray(maps), jnp.asarray(grid), mode, backend='xla')
    ref_dm, ref_dg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(maps),
                                                    jnp.asarray(grid))
    tm, tg = _t(maps, True), _t(grid, True)
    out = kt.render.mesh.utils.grid_sample_2d(tm, tg, mode)
    assert tuple(out.shape) == ref.shape == (2, 0, 3, 4)
    dm, dg = torch.autograd.grad(out.sum(), [tm, tg])
    _eq(ref_dm, dm)
    _eq(ref_dg, dg)
