"""Texture sampling, SH lighting and the textured train step of the
PyTorch port against ``kaolin_tpu`` on the CPU.

The same seeded numpy inputs go through the JAX functions
(``backend='xla'``, and once each the Pallas kernel in interpret mode) and
through the port, which runs its plain versions on CPU tensors.

Tolerances: float64 to 1e-12 (absolute, on values of order 1). Float32:
values to 1e-6; the texture gradient to 1e-6 and the coordinate gradient to
5e-5 of the largest entry (the two packages add the four taps' terms and
the texels' scatter in other orders); the textured step to 1e-4 of the
largest entry (it sums over pixels and faces in other orders).
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import kaolin_tpu as kal
import kaolin_tpu_torch as kt
from kaolin_tpu.render.camera import CameraExtrinsics
from kaolin_tpu_torch.kernels import texture as ktex
from __graft_entry__ import _icosphere
from test_torch_cuda import _nan_equal

DTYPES = [np.float64, np.float32]
MODES = ['bilinear', 'nearest']
# (values, texture gradient, coordinate gradient), relative to the largest
# entry for the gradients
TOL = {np.float64: (1e-12, 1e-12, 1e-12), np.float32: (1e-6, 1e-6, 5e-5)}


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread: under the suite's six workers the default
    threads contend for the cores (one case of this file's took 10-20x its
    time alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(out, ref, tol):
    ref = np.asarray(ref)
    out = out.detach().numpy()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    scale = float(np.abs(ref).max()) or 1.
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol * scale)


def _grads(jfn, tfn, args, cot, diff=(0, 1)):
    """(JAX value, JAX grads, port value, port grads) of sum(f * cot)."""
    jargs = [jnp.asarray(a) for a in args]
    ref, vjp = jax.vjp(lambda *a: jfn(*a), *jargs)
    jg = vjp(jnp.asarray(cot))
    targs = [_t(a, i in diff) for i, a in enumerate(args)]
    out = tfn(*targs)
    tg = torch.autograd.grad((out * _t(cot)).sum(),
                             [targs[i] for i in diff])
    return ref, [jg[i] for i in diff], out, tg


def _check(ref, jg, out, tg, dtype, nearest=False):
    tv, tt, tc = TOL[dtype]
    _close(out, ref, tv)
    _close(tg[0], jg[0], tt)
    if nearest:
        assert float(tg[1].abs().max()) == 0.
    _close(tg[1], jg[1], tc)


def _grid_sample(mode, backend='xla'):
    return (lambda m, g: kal.render.mesh.grid_sample_2d(m, g, mode=mode,
                                                        backend=backend),
            lambda m, g: kt.render.mesh.grid_sample_2d(m, g, mode=mode))


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('shape', [(3, 64, 64), (1, 17, 33), (2, 9, 200)])
def test_grid_sample_2d(dtype, mode, shape):
    """Values and gradients to the maps and the grid, grid in [-1.2, 1.2]
    (clipped); (2, 9, 200) is wider than the JAX Pallas kernel takes."""
    C, Hn, Wn = shape
    rng = np.random.default_rng(0)
    tex = rng.random((2, C, Hn, Wn)).astype(dtype)
    grid = rng.uniform(-1.2, 1.2, (2, 11, 13, 2)).astype(dtype)
    cot = rng.standard_normal((2, C, 11, 13)).astype(dtype)
    _check(*_grads(*_grid_sample(mode), (tex, grid), cot), dtype,
           mode == 'nearest')


def _on_bounds(n, dtype):
    """Grid coords in [-1, 1] whose sampler coordinate is exactly 0, exactly
    n - 1, past either bound, inside, and on a texel centre, for a size
    ``n`` that is a power of two (so every value is exact)."""
    return np.array([1. / n - 1., 1. - 1. / n, -1., 1., -1.1, 1.1, 0.3,
                     3. / n - 1.], dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('mode', MODES)
def test_grid_sample_2d_on_clip_bounds(dtype, mode):
    """Coordinates exactly on the clip bounds, where the port's
    ``minimum(maximum(..))`` must give JAX's half gradient."""
    rng = np.random.default_rng(3)
    tex = rng.random((1, 2, 16, 32)).astype(dtype)
    xs, ys = _on_bounds(32, dtype), _on_bounds(16, dtype)
    grid = np.stack(np.meshgrid(xs, ys, indexing='xy'), -1)[None]
    cot = rng.standard_normal((1, 2) + grid.shape[1:3]).astype(dtype)
    ref, jg, out, tg = _grads(*_grid_sample(mode), (tex, grid), cot)
    _check(ref, jg, out, tg, dtype, mode == 'nearest')
    if mode == 'bilinear':
        ix = ((grid[0, 0, :2, 0] + 1.) * 32 - 1.) / 2.
        assert list(ix) == [0., 31.]
        assert float(tg[1].abs().max()) > 0.


def test_grid_sample_2d_against_pallas_interpret():
    """One tiny case of values and gradients against the JAX package's
    Pallas kernel in interpret mode, with the tolerance of its own test of
    that kernel against the XLA path."""
    rng = np.random.default_rng(1)
    tex = rng.random((1, 3, 16, 24)).astype(np.float32)
    grid = rng.uniform(-1.1, 1.1, (1, 6, 7, 2)).astype(np.float32)
    cot = rng.standard_normal((1, 3, 6, 7)).astype(np.float32)
    ref, jg, out, tg = _grads(*_grid_sample('bilinear', 'pallas_interpret'),
                              (tex, grid), cot)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-6)
    np.testing.assert_allclose(tg[0].numpy(), np.asarray(jg[0]), atol=1e-6)
    np.testing.assert_allclose(tg[1].numpy(), np.asarray(jg[1]), atol=5e-5)


def test_grid_sample_nearest_against_pallas_interpret():
    rng = np.random.default_rng(2)
    tex = rng.random((2, 2, 8, 8)).astype(np.float32)
    grid = rng.uniform(-1.1, 1.1, (2, 5, 3, 2)).astype(np.float32)
    ref = kal.render.mesh.grid_sample_2d(
        jnp.asarray(tex), jnp.asarray(grid), mode='nearest',
        backend='pallas_interpret')
    out = kt.render.mesh.grid_sample_2d(_t(tex), _t(grid), mode='nearest')
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def _uvs(shape, dtype, seed):
    """Random UVs in [-0.2, 1.2] with exact 0s, 1s and the UV of the clip
    bound of a 16-texel axis (1/32) planted."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-0.2, 1.2, shape)
    flat = uv.reshape(-1)
    flat[:12] = [0., 1., 0., 0., 1., 1., 1. / 32., 1. - 1. / 32., 0.5,
                 1. / 32., 0., 1.]
    return uv.astype(dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('layout', ['dense', 'sparse'])
def test_texture_mapping(dtype, mode, layout):
    shape = (2, 7, 9, 2) if layout == 'dense' else (2, 30, 2)
    uv = _uvs(shape, dtype, 4)
    rng = np.random.default_rng(5)
    tex = rng.random((2, 3, 16, 16)).astype(dtype)
    cot = rng.standard_normal(shape[:-1] + (3,)).astype(dtype)
    _check(*_grads(
        lambda u, m: kal.render.mesh.texture_mapping(u, m, mode=mode),
        lambda u, m: kt.render.mesh.texture_mapping(u, m, mode=mode),
        (uv, tex), cot, diff=(1, 0)), dtype, mode == 'nearest')


def _uv_layout(layout, dtype, seed, bad=False):
    """UVs of ``_uvs`` as texture_mapping meets them: a contiguous
    (2, 7, 9, 2) map, the rasterizer's view of a (2, 7, 9, 3) feature map
    (stride 3), sparse (2, 30, 2) points, or a transposed map whose points
    do not flatten with one stride. ``bad``: NaN, +-inf and the UVs of the
    clip bounds of a (13, 16) texture planted too."""
    dense = layout in ('dense', 'raster', 'transposed')
    shape = (2, 7, 9, 3 if layout == 'raster' else 2) if dense else (2, 30, 2)
    uv = _uvs(shape, dtype, seed)
    if bad:
        flat = uv.reshape(-1)
        flat[12:22] = [np.nan, np.inf, -np.inf, 1. / 32., 1. - 1. / 32.,
                       1. / 26., 1. - 1. / 26., np.nan, -0.5, 2.]
    t = _t(uv, True)
    if layout == 'raster':
        return t, t[..., :2]
    if layout == 'transposed':
        return t, t.transpose(1, 2)
    return t, t


def _composition(uv, maps, mode):
    """texture_mapping's PyTorch composition, (B, P, C)."""
    from kaolin_tpu_torch.render.mesh.utils import _uv_coords
    return ktex.grid_sample_coords(maps, *_uv_coords(uv, *maps.shape[2:]),
                                   mode)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('layout', ['dense', 'raster', 'sparse',
                                    'transposed'])
def test_texture_mapping_on_cpu_keeps_composition(dtype, mode, layout):
    """On the CPU texture_mapping runs the PyTorch composition, whatever
    the UVs' layout: its samples and both gradients are the composition's
    bits, and the UV route's counters do not move."""
    rng = np.random.default_rng(7)
    leaf, uv = _uv_layout(layout, dtype, 8, bad=True)
    maps = _t(rng.random((2, 3, 13, 16)).astype(dtype), True)
    counts = (ktex.grid_sample_uv.launches,
              ktex.grid_sample_uv_backward.launches)
    out = kt.render.mesh.texture_mapping(uv, maps, mode=mode)
    cot = _t(rng.standard_normal(out.shape).astype(dtype))
    got = torch.autograd.grad(out, (maps, leaf), cot)
    ref_out = _composition(uv, maps, mode)
    ref = torch.autograd.grad(ref_out, (maps, leaf), cot.reshape(
        ref_out.shape))
    assert _nan_equal(out, ref_out.reshape(out.shape))
    assert all(_nan_equal(a, b) for a, b in zip(got, ref))
    assert counts == (ktex.grid_sample_uv.launches,
                      ktex.grid_sample_uv_backward.launches)


@pytest.mark.parametrize('case', [
    ((2, 7, 9, 2), None, (2, 63, 126, 2)),
    ((2, 7, 9, 3), 'raster', (2, 63, 189, 3)),
    ((2, 30, 2), None, (2, 30, 60, 2)),
    ((3, 2), None, (3, 1, 2, 2)),
    ((2, 1, 9, 2), None, (2, 9, 18, 2)),
    ((2, 7, 1, 2), None, (2, 7, 14, 2)),
    ((2, 7, 9, 2), 'transposed', None),
    ((2, 7, 9, 4), 'raster', (2, 63, 252, 4)),
    ((2, 2, 9), 'last', None),
    ((2, 5, 3), None, None)])
def test_uv_points_layouts(case):
    """The UV route reads UVs in place when their last dimension (of 2)
    has stride 1 and their points flatten to (B, P) with one stride:
    (B, P, batch stride, point stride) in floats, else None."""
    shape, view, want = case
    t = torch.zeros(shape)
    if view == 'raster':
        t = t[..., :2]
    elif view in ('transposed', 'last'):
        t = t.transpose(1, 2)
    assert ktex._uv_points(t) == want


def _thread_coords(u, v, H, W):
    """The UV kernels' in-thread conversion (``uv_to_sampler`` of
    ``csrc/grid_sample.cu``) written out in float32 PyTorch, operation for
    operation: torch.maximum / torch.minimum keep a NaN, as its t_max and
    t_min do."""
    lo, one = torch.tensor(0.), torch.tensor(1.)

    def clip(x, hi):
        return torch.minimum(torch.maximum(x, lo), torch.tensor(float(hi)))

    gu = clip(u, one) * 2. - 1.
    gv = (clip(v, one) * 2. - 1.) * -1.
    return (clip(((gu + 1.) * float(W) - 1.) / 2., W - 1),
            clip(((gv + 1.) * float(H) - 1.) / 2., H - 1), gu, gv)


def _thread_vjp(u, v, gu, gv, H, W, dix, diy):
    """The UV kernels' ``uv_vjp``: dix, diy through the composition's
    backward in autograd's order, written out in float32 PyTorch."""
    lo = torch.tensor(0.)

    def balanced(x, ans, other):
        return torch.where(x == ans, torch.where(other == ans, .5, 1.),
                           0.).float()

    def clip_vjp(x, hi, g):
        hi = torch.tensor(float(hi))
        m = torch.maximum(x, lo)
        y = torch.minimum(m, hi)
        return (g * balanced(m, y, hi)) * balanced(x, m, lo)

    def axis_vjp(a, n, g):
        return (clip_vjp(((a + 1.) * float(n) - 1.) / 2., n - 1, g)
                / 2.) * float(n)

    eu = axis_vjp(gu, W, dix) + 0.
    ev = axis_vjp(gv, H, diy) * -1. + 0.
    return clip_vjp(u, 1, eu * 2.), clip_vjp(v, 1, ev * 2.)


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('layout', ['dense', 'raster', 'sparse'])
def test_uv_thread_arithmetic_is_the_composition(mode, layout):
    """The UV kernels' arithmetic, written out (``_thread_coords``,
    ``_thread_vjp``), on the plain versions' samples and dix, diy: the
    composition's sampler coordinates, samples and UV gradient bit for bit
    in float32, with NaN, +-inf, ties at the clip bounds and NaN and inf
    cotangents."""
    from kaolin_tpu_torch.render.mesh.utils import _uv_coords
    rng = np.random.default_rng(9)
    H, W = 13, 16
    leaf, uv = _uv_layout(layout, np.float32, 10, bad=True)
    maps = _t(rng.random((2, 3, H, W)).astype(np.float32), True)
    flat = uv.reshape(2, -1, 2)
    ix, iy = _uv_coords(flat, H, W)
    ref_out = ktex.grid_sample_coords(maps, ix, iy, mode)
    cot = rng.standard_normal(ref_out.shape).astype(np.float32)
    cot.reshape(-1)[[3, 50, 77]] = [np.nan, np.inf, -np.inf]
    cot = _t(cot)
    ref_duv = torch.autograd.grad(ref_out, leaf, cot)[0]
    u, v = flat[..., 0].detach(), flat[..., 1].detach()
    tx, ty, gu, gv = _thread_coords(u, v, H, W)
    assert _nan_equal(tx, ix.detach()) and _nan_equal(ty, iy.detach())
    assert _nan_equal(ktex.grid_sample_plain(maps.detach(), tx, ty, mode),
                 ref_out.detach())
    _, dix, diy = ktex.grid_sample_backward_plain(maps.detach(), tx, ty,
                                                  cot, mode)
    du, dv = _thread_vjp(u, v, gu, gv, H, W, dix, diy)
    want = ref_duv[..., :2].reshape(2, -1, 2)
    assert _nan_equal(du, want[..., 0]) and _nan_equal(dv, want[..., 1])
    if mode == 'nearest':
        assert not du.any() and not dv.any()
    else:
        assert du.isnan().any() and (du == 0).any()
        assert (du.isfinite() & (du != 0)).any()


def test_grid_sample_uv_takes_cuda_float32_only():
    """The UV route raises on CPU tensors (texture_mapping keeps the
    composition there) and counts nothing."""
    maps, uv = torch.zeros(1, 3, 4, 4), torch.zeros(1, 5, 2)
    n = ktex.grid_sample_uv.launches, ktex.grid_sample_uv_backward.launches
    with pytest.raises(TypeError, match='CUDA float32'):
        ktex.grid_sample_uv(maps, uv)
    with pytest.raises(TypeError, match='CUDA float32'):
        ktex.grid_sample_uv_backward(maps.double(), uv.double(),
                                     torch.zeros(1, 5, 3))
    with pytest.raises(ValueError, match='mode'):
        ktex.grid_sample_uv(maps, uv, mode='bicubic')
    assert n == (ktex.grid_sample_uv.launches,
                 ktex.grid_sample_uv_backward.launches)


def test_gradcheck_grid_sample_2d():
    """Finite differences at float64 on the plain bilinear path, no grid
    point on a tap boundary."""
    rng = np.random.default_rng(6)
    tex = _t(rng.random((1, 2, 5, 6)), True)
    # sampler coords away from integers and from the clip bounds
    ix = rng.integers(0, 5, (1, 4, 3)) + rng.uniform(0.2, 0.8, (1, 4, 3))
    iy = rng.integers(0, 4, (1, 4, 3)) + rng.uniform(0.2, 0.8, (1, 4, 3))
    grid = _t(np.stack([(2. * ix + 1.) / 6. - 1., (2. * iy + 1.) / 5. - 1.],
                       -1), True)
    assert torch.autograd.gradcheck(
        lambda m, g: kt.render.mesh.grid_sample_2d(m, g), (tex, grid),
        eps=1e-6, atol=1e-7, rtol=1e-5)


def test_grid_sample_rejects_bad_input():
    tex, ix = torch.zeros(1, 1, 4, 4), torch.zeros(1, 3)
    with pytest.raises(ValueError, match='mode'):
        ktex.grid_sample(tex, ix, ix, mode='bicubic')
    with pytest.raises(ValueError, match='texture on meta'):
        ktex.grid_sample(tex.to('meta'), ix, ix)


@pytest.mark.parametrize('dtype', DTYPES)
def test_spherical_harmonics(dtype):
    rng = np.random.default_rng(7)
    n = rng.standard_normal((2, 5, 6, 3)).astype(dtype)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    lights = rng.standard_normal((2, 9)).astype(dtype)
    d = rng.standard_normal(3).astype(dtype)
    albedo = rng.random((60, 3)).astype(dtype)
    flat = n.reshape(-1, 3)
    tol = 1e-10 if dtype == np.float64 else 1e-5
    pairs = [
        (kal.render.mesh.spherical_harmonic_lighting(jnp.asarray(n),
                                                     jnp.asarray(lights)),
         kt.render.mesh.spherical_harmonic_lighting(_t(n), _t(lights))),
        (kal.render.lighting.project_onto_sh9(jnp.asarray(flat)),
         kt.render.lighting.project_onto_sh9(_t(flat))),
        (kal.render.lighting.sh9_irradiance(jnp.asarray(lights[0]),
                                            jnp.asarray(flat)),
         kt.render.lighting.sh9_irradiance(_t(lights[0]), _t(flat))),
        (kal.render.lighting.sh9_diffuse(jnp.asarray(d), jnp.asarray(flat),
                                         jnp.asarray(albedo)),
         kt.render.lighting.sh9_diffuse(_t(d), _t(flat), _t(albedo))),
    ]
    for ref, out in pairs:
        _close(out, ref, tol)
    out = kt.render.lighting.project_onto_sh9([0., 0., 1.], device='cpu')
    assert out.dtype == torch.float32 and abs(float(out[0]) - 0.2821) < 1e-4


def _jax_textured(dtype, B=2, subdiv=2, tex_size=16):
    """``bench_suite.py``'s config-2 inputs at a small size, built on the
    JAX side as numpy arrays, and the JAX loss."""
    verts_np, faces_np = _icosphere(subdiv)
    faces = jnp.asarray(faces_np)
    angles = np.linspace(0., 2 * np.pi, B, endpoint=False)
    eye = np.stack([3 * np.sin(angles), 0.5 * np.ones_like(angles),
                    3 * np.cos(angles)], -1)
    ext0 = CameraExtrinsics.from_lookat(
        jnp.asarray(eye, dtype), jnp.zeros((B, 3), dtype),
        jnp.tile(jnp.asarray([[0., 1., 0.]], dtype), (B, 1)),
        backend='matrix_6dof_rotation')
    cam_proj = kal.render.camera.generate_perspective_projection(
        math.pi / 4., dtype=dtype)
    rng = np.random.default_rng(0)
    texture = rng.random((B, 3, tex_size, tex_size)).astype(dtype)
    uvs = rng.random((B, verts_np.shape[0], 2)).astype(dtype)
    verts = np.tile(verts_np[None], (B, 1, 1)).astype(dtype)
    face_uvs = jnp.asarray(uvs)[:, faces]

    def loss_fn(v, tex, camp, target):
        ext = CameraExtrinsics(camp, backend='matrix_6dof_rotation')
        vc = ext.transform(v)
        vi = kal.render.camera.perspective_camera(vc, cam_proj)
        fvc = kal.ops.mesh.index_vertices_by_faces(vc, faces)
        fvi = kal.ops.mesh.index_vertices_by_faces(vi, faces)
        fn = kal.ops.mesh.face_normals(fvc, unit=True)
        ff = [face_uvs, jnp.broadcast_to(fn[:, :, None, 2:],
                                         fvc.shape[:3] + (1,))]
        (uv_map, nz_map), _ = kal.render.mesh.rasterize(
            target.shape[1], target.shape[2], fvc[..., 2], fvi, ff,
            fn[..., 2] >= 0, backend='xla')
        img = kal.render.mesh.texture_mapping(uv_map, tex, mode='bilinear')
        img = img * jnp.clip(nz_map, 0., 1.)
        return jnp.mean(jnp.abs(img - target))

    params = (verts, texture, np.asarray(ext0.parameters()))
    return params, faces_np, uvs, np.asarray(cam_proj), loss_fn


@pytest.mark.parametrize('dtype', DTYPES)
def test_textured_step(dtype):
    """Config 2's loss (B=2, 320 faces, 24x40, 16^2 texture): the loss, its
    gradients to the vertices, the texture and the 6-DoF params, and the
    parameters after 3 chained ``x - lr*g`` steps."""
    H, W, lr, steps = 24, 40, 1e-2, 3
    (verts, tex, camp), faces_np, uvs, proj, jloss = _jax_textured(dtype)
    target = np.zeros((2, H, W, 3), dtype)
    tol = 1e-9 if dtype == np.float64 else 1e-4

    ext = kt.utils.interop.extrinsics_from_numpy(
        camp, 'matrix_6dof_rotation', device='cpu')
    ttex, tuvs = kt.utils.interop.texture_from_numpy(tex, uvs, device='cpu')
    tv, tf, _, _, tproj = kt.utils.interop.dibr_params_from_numpy(
        verts, faces_np, np.eye(3), np.zeros(3), proj, device='cpu')
    tface_uvs = kt.ops.mesh.index_vertices_by_faces(tuvs, tf)

    jgrad = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))
    jp = (jnp.asarray(verts), jnp.asarray(tex), jnp.asarray(camp))
    tp = (tv, ttex, ext.parameters())
    for _ in range(steps):
        jl, jg = jgrad(*jp, jnp.asarray(target))
        tp = [p.detach().requires_grad_(True) for p in tp]
        loss = kt.utils.interop.textured_loss(*tp, tf, tface_uvs, tproj,
                                              _t(target))
        tg = torch.autograd.grad(loss, tp)
        assert math.isclose(loss.item(), float(jl), rel_tol=tol)
        for r, o in zip(jg, tg):
            assert float(o.abs().max()) > 0
            _close(o, r, tol)
        jp = tuple(p - lr * g for p, g in zip(jp, jg))
        tp = [p - lr * g for p, g in zip(tp, tg)]
    for r, o in zip(jp, tp):
        _close(o, r, tol)
