"""The PyTorch port's tensor ops against ``kaolin_tpu`` on the CPU: the
legacy camera, ``index_vertices_by_faces``, ``face_normals``,
``prepare_vertices``, ``mask_iou`` and the demo scene; plus the port's
import rules (no JAX, nothing of ``kaolin_tpu``).

The same seeded numpy inputs go to both packages. Tolerances: float64
1e-10 (both sides do the same operations; only the order of a few sums
may differ), float32 1e-5 absolute on values of order 1.
"""

import ast
import math
import pathlib
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import kaolin_tpu as kal
import kaolin_tpu_torch as kt
from __graft_entry__ import _icosphere, _scene

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = {np.float64: 1e-10, np.float32: 1e-5}
DTYPES = [np.float64, np.float32]


def _close(a, b, dtype):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize('dtype', DTYPES)
def test_rotate_translate_points(rng, dtype):
    pts = rng.standard_normal((3, 7, 3)).astype(dtype)
    rot = rng.standard_normal((3, 3, 3)).astype(dtype)
    trans = rng.standard_normal((3, 3)).astype(dtype)
    ref = kal.render.camera.rotate_translate_points(
        jnp.asarray(pts), jnp.asarray(rot), jnp.asarray(trans))
    out = kt.render.camera.rotate_translate_points(
        torch.tensor(pts), torch.tensor(rot), torch.tensor(trans))
    _close(ref, out, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('up_batch', [1, 3])
@pytest.mark.parametrize('fn', ['generate_rotate_translate_matrices',
                                'generate_transformation_matrix'])
def test_camera_matrices(rng, dtype, up_batch, fn):
    pos = rng.standard_normal((3, 3)).astype(dtype) * 3
    at = rng.standard_normal((3, 3)).astype(dtype) * 0.1
    up = np.tile(np.asarray([[0., 1., 0.]], dtype), (up_batch, 1))
    ref = getattr(kal.render.camera, fn)(
        jnp.asarray(pos), jnp.asarray(at), jnp.asarray(up))
    out = getattr(kt.render.camera, fn)(
        torch.tensor(pos), torch.tensor(at), torch.tensor(up))
    if isinstance(ref, tuple):
        for r, o in zip(ref, out):
            _close(r, o, dtype)
    else:
        _close(ref, out, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
def test_perspective_camera(rng, dtype):
    pts = rng.standard_normal((2, 9, 3)).astype(dtype)
    pts[..., 2] -= 4.
    proj = np.asarray([[1.5], [2.], [-1.]], dtype)
    ref = kal.render.camera.perspective_camera(jnp.asarray(pts),
                                               jnp.asarray(proj))
    out = kt.render.camera.perspective_camera(torch.tensor(pts),
                                              torch.tensor(proj))
    _close(ref, out, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('ratio', [1.0, 1.5])
def test_generate_perspective_projection(dtype, ratio):
    ref = kal.render.camera.generate_perspective_projection(
        math.pi / 3, ratio, dtype=jnp.dtype(dtype))
    out = kt.render.camera.generate_perspective_projection(
        math.pi / 3, ratio, dtype=getattr(torch, np.dtype(dtype).name),
        device='cpu')
    assert out.shape == (3, 1) and out.device.type == 'cpu'
    _close(ref, out, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
def test_index_vertices_by_faces(rng, dtype):
    verts = rng.standard_normal((2, 12, 5)).astype(dtype)
    faces = rng.integers(0, 12, (9, 3)).astype(np.int32)
    ref = kal.ops.mesh.index_vertices_by_faces(jnp.asarray(verts),
                                               jnp.asarray(faces))
    out = kt.ops.mesh.index_vertices_by_faces(torch.tensor(verts),
                                              torch.tensor(faces))
    assert out.shape == (2, 9, 3, 5)
    _close(ref, out, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('unit', [False, True])
def test_face_normals(rng, dtype, unit):
    fv = rng.standard_normal((2, 11, 3, 3)).astype(dtype)
    fv[0, 0] = 0.          # a degenerate face: the 1e-10 guard keeps it 0
    ref = kal.ops.mesh.face_normals(jnp.asarray(fv), unit=unit)
    out = kt.ops.mesh.face_normals(torch.tensor(fv), unit=unit)
    _close(ref, out, dtype)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('camera_form', ['rot_trans', 'transform'])
def test_prepare_vertices(dtype, camera_form):
    verts, faces, rot, trans, proj = _scene(2, 1, jnp.dtype(dtype))
    tv, tf, trot, ttrans, tproj = kt.utils.interop.dibr_params_from_numpy(
        *(np.asarray(a) for a in (verts, faces, rot, trans, proj)),
        device='cpu')
    if camera_form == 'rot_trans':
        ref = kal.render.mesh.prepare_vertices(
            verts, faces, proj, camera_rot=rot, camera_trans=trans)
        out = kt.render.mesh.prepare_vertices(
            tv, tf, tproj, camera_rot=trot, camera_trans=ttrans)
    else:
        pos = np.asarray([[0., 0.5, 3.], [3., 0.5, 0.]], dtype)
        at = np.zeros((2, 3), dtype)
        up = np.asarray([[0., 1., 0.]], dtype)
        mtx = kal.render.camera.generate_transformation_matrix(
            jnp.asarray(pos), jnp.asarray(at), jnp.asarray(up))
        ref = kal.render.mesh.prepare_vertices(verts, faces, proj,
                                               camera_transform=mtx)
        out = kt.render.mesh.prepare_vertices(
            tv, tf, tproj, camera_transform=torch.tensor(np.asarray(mtx)))
    for r, o in zip(ref, out):
        _close(r, o, dtype)


def test_prepare_vertices_needs_one_camera_form():
    verts, faces, rot, trans, proj = kt.utils.interop.scene(1, 0,
                                                            device='cpu')
    with pytest.raises(ValueError):
        kt.render.mesh.prepare_vertices(verts, faces, proj, camera_rot=rot)
    with pytest.raises(ValueError):
        kt.render.mesh.prepare_vertices(
            verts, faces, proj, camera_rot=rot, camera_trans=trans,
            camera_transform=torch.eye(4, 3))


@pytest.mark.parametrize('dtype', DTYPES)
def test_mask_iou(rng, dtype):
    a = rng.random((3, 8, 9)).astype(dtype)
    b = (rng.random((3, 8, 9)) > 0.5).astype(dtype)
    ref = kal.metrics.render.mask_iou(jnp.asarray(a), jnp.asarray(b))
    out = kt.metrics.render.mask_iou(torch.tensor(a), torch.tensor(b))
    assert out.ndim == 0
    _close(ref, out, dtype)


@pytest.mark.parametrize('subdiv', [0, 2])
def test_icosphere_copy(subdiv):
    rv, rf = _icosphere(subdiv)
    v, f = kt.utils.interop.icosphere(subdiv)
    np.testing.assert_array_equal(rv, v)
    np.testing.assert_array_equal(rf, f)
    assert f.shape == (20 * 4 ** subdiv, 3)


@pytest.mark.parametrize('dtype', DTYPES)
def test_scene_matches_graft_entry(dtype):
    ref = _scene(3, 1, jnp.dtype(dtype))
    out = kt.utils.interop.scene(3, 1, dtype=getattr(torch,
                                                     np.dtype(dtype).name),
                                 device='cpu')
    assert out[1].dtype == torch.int64
    for r, o in zip(ref, out):
        assert o.device.type == 'cpu'
        np.testing.assert_allclose(np.asarray(r), o.numpy(),
                                   rtol=TOL[dtype], atol=TOL[dtype])


def test_interop_dtypes():
    v, f, r, t, p = kt.utils.interop.dibr_params_from_numpy(
        np.zeros((1, 3, 3), np.float32), np.zeros((1, 3), np.int32),
        np.eye(3)[None], np.zeros((1, 3)), np.ones((3, 1), np.float32),
        device='cpu')
    assert (v.dtype, f.dtype, r.dtype, t.dtype, p.dtype) == (
        torch.float32, torch.int64, torch.float64, torch.float64,
        torch.float32)


def test_import_leaves_jax_out():
    code = ('import sys, kaolin_tpu_torch; '
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "kaolin_tpu", "__graft_entry__", "scipy", '
            '"PIL", "tornado")]; '
            'print(bad); sys.exit(1 if bad else 0)')
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax():
    files = sorted((ROOT / 'kaolin_tpu_torch').rglob('*.py'))
    files += [ROOT / 'chip_smoke.py', ROOT / 'chip_coverage.py']
    assert len(files) > 15
    rel = {str(f.relative_to(ROOT)) for f in files}
    for mod in ('kernels/deftet_topk', 'kernels/spc_traverse',
                'render/mesh/deftet', 'render/spc/raytrace',
                'metrics/tetmesh', 'ops/mesh/tetmesh',
                'ops/conversions/tetmesh', 'ops/spc/uint8', 'ops/spc/points',
                'ops/spc/spc', 'rep/spc', 'render/lighting/sg',
                'ops/spc/convolution', 'native', 'ops/coords', 'ops/random',
                'ops/voxelgrid', 'metrics/voxelgrid', 'ops/gcn',
                'ops/mesh/subdivision', 'ops/conversions/pointcloud',
                'ops/conversions/trianglemesh', 'ops/conversions/mc_tables',
                'ops/conversions/voxelgrid', 'ops/conversions/mesh',
                'parallel/distributed', 'parallel/mesh', 'parallel/render',
                'parallel/metrics', 'parallel/spc', 'parallel/launch',
                'io/utils', 'io/materials', 'io/obj', 'io/off', 'io/render',
                'io/dataset', 'io/modelnet', 'io/shapenet', 'io/shrec',
                'utils/testing', 'utils/checkpoint', 'io/usd', 'io/usdc',
                'visualize/__init__', 'visualize/timelapse',
                'experimental/__init__', 'experimental/dash3d/__init__',
                'experimental/dash3d/__main__', 'experimental/dash3d/run',
                'experimental/dash3d/util', 'examples/__init__',
                'examples/utils', 'examples/spline', 'examples/spline_mesh',
                'examples/renderer', 'examples/fish', 'examples/dibr_train',
                'examples/nglod_train', 'examples/dmtet_train',
                'examples/visualize_main',
                *(f'examples/recipes/{r}' for r in (
                    'camera/camera_coordinate_systems',
                    'camera/camera_init_explicit',
                    'camera/camera_init_simple', 'camera/camera_movement',
                    'camera/camera_opengl_shaders',
                    'camera/camera_properties', 'camera/camera_ray_tracing',
                    'camera/camera_transforms',
                    'camera/cameras_differentiable',
                    'dataload/spc_from_pointcloud',
                    'preprocess/fast_mesh_sampling',
                    'preprocess/occupancy_sampling', 'spc/spc_basics',
                    'spc/spc_conv3d_example', 'spc/spc_dual_octree',
                    'spc/spc_trilinear_interp'))):
        assert f'kaolin_tpu_torch/{mod}.py' in rel, mod
    for path in files:
        for mod in _imports(path):
            top = mod.split('.')[0]
            assert top not in ('jax', 'jaxlib', 'kaolin_tpu',
                               '__graft_entry__', 'scipy', 'optax',
                               'examples'), (path, mod)


def _c_entry_points():
    """{name: [ctypes type per parameter]} of the ``extern "C"`` functions
    in ``kaolin_tpu_torch/csrc/*.cu``."""
    import ctypes
    import re
    kinds = {'p': ctypes.c_void_p, 'float': ctypes.c_float,
             'int': ctypes.c_int, 'long long': ctypes.c_longlong}
    out = {}
    for src in (ROOT / 'kaolin_tpu_torch' / 'csrc').glob('*.cu'):
        text = src.read_text()
        text = text[text.index('extern "C" {'):]
        for name, params in re.findall(r'\nint (\w+)\(([^)]*)\)\s*\{', text):
            types = []
            for param in params.split(','):
                kind = 'p' if '*' in param else ' '.join(param.split()[:-1])
                types.append(kinds[kind])
            out[name] = types
    return out


def test_ctypes_signatures_match_sources():
    """Each wrapper's ctypes argument types are those of its C entry
    point, so a launch passes every pointer whole and in its place."""
    from kaolin_tpu_torch.kernels import (deftet_topk, nn_distance,
                                          p2m_distance, rasterize,
                                          rasterize_bwd, soft_mask,
                                          spc_traverse, texture)
    entry = _c_entry_points()
    seen = 0
    for mod in (rasterize, rasterize_bwd, soft_mask, texture, nn_distance,
                p2m_distance, deftet_topk, spc_traverse):
        for name, argtypes in mod._SIGNATURES.items():
            assert entry[name] == argtypes, name
            seen += 1
    assert seen == len(entry) == 21


def test_nn_layout_matches_source():
    """The NN layout in ``nn_distance.py`` (the pruned scan's, which sizes
    the buffers and forms the plain prepass, and the brute force's, which
    its host plan uses) is the one its CUDA source declares, as loading
    the library also checks on the card."""
    import re
    from kaolin_tpu_torch.kernels import nn_distance
    text = (ROOT / 'kaolin_tpu_torch' / 'csrc' / 'nn_distance.cu').read_text()
    consts = {}
    for name, expr in re.findall(r'constexpr int (\w+) = ([^;]+);', text):
        consts[name] = eval(expr, {}, dict(consts))
    assert tuple(consts[k] for k in ('TQ', 'CH', 'EXT_BLOCKS', 'PAD_ORIG',
                                     'QB', 'CHUNK', 'MIN_SLICE')) \
        == nn_distance._LAYOUT
