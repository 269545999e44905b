"""The port's SPC ray tracing against ``kaolin_tpu`` on the CPU:
``VOXEL_ORDER``, ``unbatched_raytrace`` and ``unbatched_raytrace_fixed``
against the XLA route (``backend='xla'``) at levels 0-5, with and without
exit depths, in the array and ``ray_fn`` forms, at float32 and float64;
exact axis-aligned scenes; a ``cap`` below the true count;
``plan_raytrace``; every pack op with its gradient; primary and shadow
rays.

The same seeded numpy inputs go to both packages. Ray ids, point ids and
counts must be equal. Depths within 4 ulp (the JAX package states about 2
ulp at float32 from XLA's fusion of products into sums, ``fma``, which the
port does not do): relative 5e-7 at float32, 1e-15 at float64. That
fusion can flip a slab test whose ``|lt|`` lies within an ulp of the half
size ``r`` (a 32x32 grid of primary rays from an eye on the z axis has
such rays, whose x and y components are equal and opposite), so the
generic scenes are random rays and an off-axis camera; the axis-aligned
scenes, some of whose rays lie in lattice planes, take dyadic origins and
direction components 0, -0.0 and +-1, where every product is exact and no
fusion can flip a decision.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import kaolin_tpu as kal
import kaolin_tpu_torch as kt
from kaolin_tpu.render.spc import raytrace as jr
from kaolin_tpu_torch.kernels import spc_traverse as kst
from kaolin_tpu_torch.render.spc import raytrace as tr

LEVEL = 5
RAYS = 1000
DEPTH_RTOL = {np.float32: 5e-7, np.float64: 1e-15}
# kaolin_tpu's ray_fn form fuses the slab arithmetic otherwise than its
# array form: its own two forms differ by up to 2.1e-6 (float32) and
# 2.6e-15 (float64) relative on the ray_fn scene below
RAY_FN_RTOL = {np.float32: 4e-6, np.float64: 5e-15}
TOL = {np.float64: 1e-12, np.float32: 1e-5}
GRAD_TOL = {np.float64: 1e-9, np.float32: 1e-4}


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread: under the suite's six workers the default
    threads contend for the cores (one case of this file's took 10-20x its
    time alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spc():
    """Config 5's sphere shell (radius 0.7), 20,000 points at level 5,
    from ``kaolin_tpu``; the same arrays in the port's types."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(20000, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    q = kal.ops.spc.quantize_points(jnp.asarray(d * 0.7, jnp.float32), LEVEL)
    octree = kal.ops.spc.unbatched_points_to_octree(q, LEVEL)
    _, pyr, exsum = kal.ops.spc.scan_octrees(octree,
                                             np.array([octree.shape[0]]))
    ph = kal.ops.spc.generate_points(octree, pyr, exsum)
    return ((octree, ph, pyr[0], exsum),
            kt.utils.interop.spc_from_numpy(octree, ph, pyr[0], exsum,
                                            device='cpu'))


SPC_J, SPC_T = _spc()


def _random_rays(dtype, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, (RAYS, 3))
    d = rng.uniform(-0.5, 0.5, (RAYS, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(dtype), d.astype(dtype)


def _axis_rays(dtype, seed=2):
    """Rays along +-x, +-y, +-z (the other components 0.0 or -0.0) from
    origins on the 2^-7 lattice, a quarter of them on the level-5 cell
    planes (multiples of 2^-4) in the two coordinates across the ray."""
    rng = np.random.default_rng(seed)
    axis = rng.integers(0, 3, RAYS)
    sign = rng.choice([-1., 1.], RAYS)
    d = np.where(rng.random((RAYS, 3)) < 0.5, 0., -0.)
    d[np.arange(RAYS), axis] = sign
    o = rng.integers(-128, 129, (RAYS, 3)) / 128.
    on_plane = rng.random(RAYS) < 0.25
    o[on_plane] = np.round(o[on_plane] * 16.) / 16.
    o[np.arange(RAYS), axis] = -1.5 * sign
    return o.astype(dtype), d.astype(dtype)


def _trace_both(o, d, level, with_exit=False):
    oct_j, ph_j, pyr, ex_j = SPC_J
    ref = kal.render.spc.unbatched_raytrace(
        oct_j, ph_j, pyr, ex_j, jnp.asarray(o), jnp.asarray(d), level,
        with_exit=with_exit, backend='xla')
    oct_t, ph_t, _, ex_t = SPC_T
    out = kt.render.spc.unbatched_raytrace(
        oct_t, ph_t, pyr, ex_t, torch.tensor(o), torch.tensor(d), level,
        with_exit=with_exit)
    return ref, out


def _check(ref, out, dtype, with_exit):
    assert out[0].dtype == out[1].dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref[0]), out[0].numpy())
    np.testing.assert_array_equal(np.asarray(ref[1]), out[1].numpy())
    assert tuple(out[2].shape) == (out[0].shape[0], 2 if with_exit else 1)
    np.testing.assert_allclose(np.asarray(ref[2]), out[2].numpy(),
                               rtol=DEPTH_RTOL[dtype], atol=0)


def test_voxel_order():
    assert tr.VOXEL_ORDER == jr.VOXEL_ORDER == kst.VOXEL_ORDER
    src = (kst.__file__.rsplit('/kernels/', 1)[0]
           + '/csrc/spc_traverse.cu')
    table = open(src).read().split('c_order[64] = {')[1].split('};')[0]
    assert [int(v) for v in table.replace(',', ' ').split()] == [
        o for row in jr.VOXEL_ORDER for o in row]


@pytest.mark.parametrize('level', range(LEVEL + 1))
def test_raytrace_matches_xla(level):
    o, d = _random_rays(np.float32)
    ref, out = _trace_both(o, d, level)
    _check(ref, out, np.float32, False)
    assert out[0].shape[0] > 0


@pytest.mark.parametrize('level', [0, 2, LEVEL])
def test_raytrace_with_exit_matches_xla(level):
    o, d = _random_rays(np.float32)
    ref, out = _trace_both(o, d, level, with_exit=True)
    _check(ref, out, np.float32, True)
    assert bool((out[2][:, 1] >= out[2][:, 0]).all())


@pytest.mark.parametrize('level,with_exit', [(2, False), (LEVEL, False),
                                             (LEVEL, True)])
def test_raytrace_float64_matches_xla(level, with_exit):
    o, d = _random_rays(np.float64)
    ref, out = _trace_both(o, d, level, with_exit)
    _check(ref, out, np.float64, with_exit)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('level', [2, LEVEL])
def test_axis_aligned_rays_match_xla(dtype, level):
    o, d = _axis_rays(dtype)
    assert (np.signbit(d) & (d == 0)).any()
    ref, out = _trace_both(o, d, level)
    _check(ref, out, dtype, False)
    assert out[0].shape[0] > 100


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_ray_fn_form_matches_xla(dtype):
    """``unbatched_raytrace_fixed`` with ``ray_fn``: ``kaolin_tpu`` with its
    ``primary_rays_fn`` (off-axis camera, 30x34), the port with its own at
    float64 (within an ulp of them), and at float32 with one returning
    ``kaolin_tpu``'s rows (XLA's float32 tan of pi/6 is an ulp above the
    correctly rounded one PyTorch gives). The port's two forms agree bit
    for bit."""
    cam = ([0.31, 0.17, 2.5], [0.05, -0.03, 0.], [0., 1., 0.], math.pi / 3)
    jfn = jr.primary_rays_fn(30, 34, *(jnp.asarray(v, dtype)
                                       for v in cam[:3]), cam[3], dtype)
    oj, dj = jfn(jnp.arange(30 * 34, dtype=jnp.int32))
    if dtype == np.float64:
        tfn = tr.primary_rays_fn(30, 34, *cam, dtype=torch.float64,
                                 device='cpu')
    else:
        rows = (torch.tensor(np.asarray(oj)), torch.tensor(np.asarray(dj)))

        def tfn(ridx):
            return rows[0][ridx.long()], rows[1][ridx.long()]
    cap = 64 * 30 * 34
    oct_j, ph_j, _, ex_j = SPC_J
    oct_t, ph_t, _, ex_t = SPC_T
    ref = jr.unbatched_raytrace_fixed(oct_j, ph_j, ex_j, oj, dj, 4, cap,
                                      ray_fn=jfn)
    ot, dt = tfn(torch.arange(30 * 34, dtype=torch.int32))
    out = tr.unbatched_raytrace_fixed(oct_t, ph_t, ex_t, ot, dt, 4, cap,
                                      ray_fn=tfn)
    arr = tr.unbatched_raytrace_fixed(oct_t, ph_t, ex_t, ot, dt, 4, cap)
    n = int(out[3])
    assert n == int(ref[3]) == int(arr[3]) > 0
    for r, o, a in zip(ref[:2], out[:2], arr[:2]):
        np.testing.assert_array_equal(np.asarray(r), o.numpy())
        assert torch.equal(o, a)
    assert int((out[0][n:] != -1).sum()) == 0
    assert torch.equal(out[2], arr[2])
    np.testing.assert_allclose(np.asarray(ref[2]), out[2].numpy(),
                               rtol=RAY_FN_RTOL[dtype], atol=0)


def test_cap_below_the_count():
    """A ``cap`` above every earlier level's hits and below the last
    level's: both report the true count and agree on the prefix."""
    o, d = _random_rays(np.float32)
    oct_j, ph_j, _, ex_j = SPC_J
    oct_t, ph_t, _, ex_t = SPC_T
    full = tr.unbatched_raytrace_fixed(oct_t, ph_t, ex_t, torch.tensor(o),
                                       torch.tensor(d), 3, 8 * RAYS,
                                       return_level_counts=True)
    counts = full[4].tolist()
    assert counts[-1] > max(counts[:-1])
    cap = (counts[-1] + max(counts[:-1])) // 2
    ref = jr.unbatched_raytrace_fixed(oct_j, ph_j, ex_j, jnp.asarray(o),
                                      jnp.asarray(d), 3, cap, backend='xla')
    out = tr.unbatched_raytrace_fixed(oct_t, ph_t, ex_t, torch.tensor(o),
                                      torch.tensor(d), 3, cap)
    assert int(ref[3]) == int(out[3]) == counts[-1] > cap
    for r, x in zip(ref[:3], out[:3]):
        assert tuple(x.shape[:1]) == (cap,)
        np.testing.assert_array_equal(np.asarray(r), x.numpy())
    assert torch.equal(out[0], full[0][:cap])


def test_plan_raytrace_counts():
    o, d = _random_rays(np.float32)
    oct_j, ph_j, _, ex_j = SPC_J
    oct_t, ph_t, _, ex_t = SPC_T
    ref = jr.plan_raytrace(oct_j, ph_j, ex_j, jnp.asarray(o), jnp.asarray(d),
                           4, return_counts=True)
    out = tr.plan_raytrace(oct_t, ph_t, ex_t, torch.tensor(o),
                           torch.tensor(d), 4, return_counts=True)
    assert ref == out
    assert jr.level_offsets_from_octree(oct_j) == \
        tr.level_offsets_from_octree(oct_t)


def test_cpu_tensors_take_the_plain_version():
    o, d = _random_rays(np.float32)
    oct_t, ph_t, _, ex_t = SPC_T
    n = kst.traverse.launches
    out = kst.traverse(oct_t, ex_t, ph_t, torch.tensor(o), torch.tensor(d),
                       3)
    assert kst.traverse.launches == n
    ref = kst.traverse_plain(oct_t, ex_t, ph_t, torch.tensor(o),
                             torch.tensor(d), 3)
    for a, b in zip(out[:3], ref[:3]):
        assert torch.equal(a, b)
    assert out[3] == ref[3] == out[4][-1]


def _packs(dtype, seed=3):
    """Sorted pack ids (about 100 packs of 1 to 7 elements, as the ray ids
    of a trace run), features and densities."""
    rng = np.random.default_rng(seed)
    ridx = np.repeat(np.sort(rng.choice(1000, 100, replace=False)),
                     rng.integers(1, 8, 100)).astype(np.int32)
    feats = rng.random((ridx.shape[0], 3)).astype(dtype)
    tau = rng.random((ridx.shape[0], 1)).astype(dtype)
    return ridx, feats, tau


def _pack_cases():
    cases = [('diff', lambda m, f, b, n: m.diff(f, b)),
             ('sum_reduce', lambda m, f, b, n: m.sum_reduce(f, b)),
             ('num_packs', lambda m, f, b, n: m.sum_reduce(f, b,
                                                          num_packs=n))]
    for op in ('cumsum', 'cumprod'):
        for exclusive in (False, True):
            for reverse in (False, True):
                cases.append(((op, exclusive, reverse),
                              lambda m, f, b, n, op=op, e=exclusive,
                              r=reverse: getattr(m, op)(f, b, exclusive=e,
                                                        reverse=r)))
    return cases


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_pack_ops(dtype):
    """Every pack op and its gradient (``kaolin_tpu``'s jitted, which its
    associative scans need to compile in reasonable time)."""
    ridx, feats, _ = _packs(dtype)
    bj = jr.mark_pack_boundaries(jnp.asarray(ridx))
    bt = tr.mark_pack_boundaries(torch.tensor(ridx))
    np.testing.assert_array_equal(np.asarray(bj), bt.numpy())
    with pytest.warns(DeprecationWarning):
        np.testing.assert_array_equal(
            bt.numpy(), tr.mark_first_hit(torch.tensor(ridx)).numpy())
    n = int(bt.sum())
    fj, ft = jnp.asarray(feats), torch.tensor(feats)
    w = np.random.default_rng(4).random((feats.shape[0], 3)).astype(dtype)
    for name, fn in _pack_cases():
        x = ft.clone().requires_grad_(True)
        out = fn(tr, x, bt, n)
        wr = w[:out.shape[0]]

        @jax.jit
        def ref_and_grad(f):
            return fn(jr, f, bj, n), jax.grad(
                lambda f: jnp.sum(fn(jr, f, bj, n) * wr))(f)

        ref, g_ref = ref_and_grad(fj)
        assert tuple(out.shape) == ref.shape, name
        np.testing.assert_allclose(np.asarray(ref), out.detach().numpy(),
                                   rtol=TOL[dtype], atol=TOL[dtype],
                                   err_msg=str(name))
        g, = torch.autograd.grad(torch.sum(out * torch.tensor(wr)), [x])
        np.testing.assert_allclose(
            np.asarray(g_ref), g.numpy(), rtol=GRAD_TOL[dtype],
            atol=GRAD_TOL[dtype] * np.abs(np.asarray(g_ref)).max(),
            err_msg=str(name))


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
@pytest.mark.parametrize('exclusive', [True, False])
def test_exponential_integration(dtype, exclusive):
    ridx, feats, tau = _packs(dtype)
    bj = jr.mark_pack_boundaries(jnp.asarray(ridx))
    bt = tr.mark_pack_boundaries(torch.tensor(ridx))

    def fwd(f, t):
        return jr.exponential_integration(f, t, bj, exclusive=exclusive)

    def loss_j(f, t):
        a, b = fwd(f, t)
        return jnp.sum(a ** 2) + jnp.sum(b)

    ref, (gf_ref, gt_ref) = jax.jit(
        lambda f, t: (fwd(f, t), jax.grad(loss_j, argnums=(0, 1))(f, t)))(
            jnp.asarray(feats), jnp.asarray(tau))
    f = torch.tensor(feats, requires_grad=True)
    t = torch.tensor(tau, requires_grad=True)
    out = tr.exponential_integration(f, t, bt, exclusive=exclusive)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(np.asarray(r), o.detach().numpy(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
    gf, gt = torch.autograd.grad(torch.sum(out[0] ** 2) + torch.sum(out[1]),
                                 [f, t])
    for r, g in ((gf_ref, gf), (gt_ref, gt)):
        np.testing.assert_allclose(
            np.asarray(r), g.numpy(), rtol=GRAD_TOL[dtype],
            atol=GRAD_TOL[dtype] * np.abs(np.asarray(r)).max())


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_primary_and_shadow_rays(dtype):
    torch_dtype = torch.float64 if dtype == np.float64 else torch.float32
    cam = ([0.31, 0.17, 2.5], [0.05, -0.03, 0.], [0., 1., 0.], math.pi / 3)
    oj, dj = jr.generate_primary_rays(30, 34, *(jnp.asarray(v, dtype)
                                                for v in cam[:3]), cam[3],
                                      dtype=dtype)
    ot, dt = tr.generate_primary_rays(30, 34, *cam, dtype=torch_dtype,
                                      device='cpu')
    np.testing.assert_array_equal(np.asarray(oj), ot.numpy())
    np.testing.assert_allclose(np.asarray(dj), dt.numpy(),
                               rtol=DEPTH_RTOL[dtype], atol=1e-7
                               if dtype == np.float32 else 1e-15)
    ridx = torch.arange(30 * 34, dtype=torch.int32)
    o2, d2 = tr.primary_rays_fn(30, 34, *cam, dtype=torch_dtype,
                                device='cpu')(ridx)
    assert torch.equal(o2, ot) and torch.equal(d2, dt)
    cols = tr.primary_rays_fn_cols(30, 34, *cam, dtype=torch_dtype,
                                   device='cpu')(ridx)
    jcols = jr.primary_rays_fn_cols(30, 34, *(jnp.asarray(v, dtype)
                                              for v in cam[:3]), cam[3],
                                    dtype)(jnp.arange(30 * 34))
    for a, (c, jc) in enumerate(zip(cols, jcols)):
        ref = (ot if a < 3 else dt)[:, a % 3].numpy()
        np.testing.assert_allclose(ref, c.numpy(), rtol=DEPTH_RTOL[dtype],
                                   atol=1e-7 if dtype == np.float32
                                   else 1e-15)
        np.testing.assert_allclose(np.asarray(jc), c.numpy(),
                                   rtol=DEPTH_RTOL[dtype],
                                   atol=1e-7 if dtype == np.float32
                                   else 1e-15)
    light = np.array([0.5, 3., 0.2], dtype)
    plane = np.array([0., 1., 0., 0.6], dtype)
    ref = jr.generate_shadow_rays(jnp.asarray(oj), jnp.asarray(dj),
                                  jnp.asarray(light), jnp.asarray(plane))
    out = tr.generate_shadow_rays(torch.tensor(np.asarray(oj)),
                                  torch.tensor(np.asarray(dj)),
                                  torch.tensor(light), torch.tensor(plane))
    np.testing.assert_array_equal(np.asarray(ref[2]), out[2].numpy())
    assert out[2].shape[0] > 100 and out[2].dtype == torch.int32
    for r, o in zip(ref[:2], out[:2]):
        np.testing.assert_allclose(np.asarray(r), o.numpy(), rtol=TOL[dtype],
                                   atol=TOL[dtype])
