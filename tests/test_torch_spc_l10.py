"""Config 5's level-10 path at a small size, the port against
``kaolin_tpu``'s XLA route on the CPU: a level-10 octree of 2,000 points
on a sphere shell (the port's quantize, octree build, scan and points
against the JAX package's), 32x32 primary rays traced in the array and
the ``ray_fn`` forms, ``plan_raytrace``, and the pack ops over the hits.

The shell has radius 0.02 and the camera looks at it off-axis with a
field of view of 0.024 rad, so that the rays cross cells of a dense part
of the octree (2,000 points on config 5's radius 0.7 leave level 10 so
sparse that 32x32 rays make almost no hit). Tolerances are
``tests/test_torch_raytrace.py``'s for config 5: ids and counts equal,
depths relative 5e-7 (float32, against ``kaolin_tpu``'s array form:
each of its level-10 traces compiles for about 12 s, so it traces once,
at float32); the port's two forms bit-equal. The port traces
``kaolin_tpu``'s rows (XLA's float32 tan of the half fov rounds
otherwise than PyTorch's). The pack ops to 1e-5, absolute and relative
to the largest value.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import kaolin_tpu as kal
import kaolin_tpu_torch as kt
from kaolin_tpu.render.spc import raytrace as jr
from kaolin_tpu_torch.render.spc import raytrace as tr

LEVEL, POINTS, RES = 10, 2000, 32
CAM = ([0.031, 0.017, 2.5], [0.0013, -0.0021, 0.], [0., 1., 0.], 0.024)
DEPTH_RTOL = {np.float32: 5e-7, np.float64: 1e-15}
PACK_TOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread: many small tensor ops, under the suite's
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _shell():
    rng = np.random.default_rng(0)
    d = rng.normal(size=(POINTS, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (d * 0.02).astype(np.float32)


def _spc_jax():
    q = kal.ops.spc.quantize_points(jnp.asarray(_shell()), LEVEL)
    octree = kal.ops.spc.unbatched_points_to_octree(q, LEVEL)
    _, pyr, exsum = kal.ops.spc.scan_octrees(octree,
                                             np.array([octree.shape[0]]))
    ph = kal.ops.spc.generate_points(octree, pyr, exsum)
    return octree, ph, pyr[0], exsum


SPC_J = _spc_jax()
SPC_T = kt.utils.interop.spc_from_numpy(*SPC_J, device='cpu')


def test_level10_octree_matches():
    q = kt.ops.spc.quantize_points(torch.as_tensor(_shell()), LEVEL)
    octree = kt.ops.spc.unbatched_points_to_octree(q, LEVEL)
    _, pyr, exsum = kt.ops.spc.scan_octrees(octree, [octree.shape[0]])
    ph = kt.ops.spc.generate_points(octree, pyr, exsum)
    for out, ref in zip((octree, ph, pyr[0], exsum), SPC_J):
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def _rays(dtype):
    """(kaolin_tpu's ray_fn and rows, the port's ray_fn and rows)."""
    jfn = jr.primary_rays_fn(RES, RES, *(jnp.asarray(v, dtype)
                                         for v in CAM[:3]), CAM[3], dtype)
    oj, dj = jfn(jnp.arange(RES * RES, dtype=jnp.int32))
    if dtype == np.float64:
        tfn = tr.primary_rays_fn(RES, RES, *CAM, dtype=torch.float64,
                                 device='cpu')
    else:
        rows = (torch.tensor(np.asarray(oj)), torch.tensor(np.asarray(dj)))

        def tfn(ridx):
            return rows[0][ridx.long()], rows[1][ridx.long()]
    ot, dt = tfn(torch.arange(RES * RES, dtype=torch.int32))
    return jfn, (oj, dj), tfn, (ot, dt)


def test_level10_trace_both_forms():
    """One float32 trace by ``kaolin_tpu`` (its array form with the level
    counts: each of its level-10 traces compiles for about 12 s), against
    the port's ``plan_raytrace`` and both of the port's forms."""
    dtype = np.float32
    jfn, (oj, dj), tfn, (ot, dt) = _rays(dtype)
    oct_j, ph_j, _, ex_j = SPC_J
    oct_t, ph_t, _, ex_t = SPC_T
    sched, counts = tr.plan_raytrace(oct_t, ph_t, ex_t, ot, dt, LEVEL,
                                     return_counts=True)
    cap = max(max(sched), RES * RES)
    ref = jr.unbatched_raytrace_fixed(oct_j, ph_j, ex_j, oj, dj, LEVEL, cap,
                                      return_level_counts=True,
                                      backend='xla')
    assert tuple(counts) == tuple(int(c) for c in np.asarray(ref[4]))
    assert tuple(sched) == tuple(-(-int(c * 1.25) // 1024) * 1024
                                 for c in counts)
    arr = tr.unbatched_raytrace_fixed(oct_t, ph_t, ex_t, ot, dt, LEVEL, cap)
    by_fn = tr.unbatched_raytrace_fixed(oct_t, ph_t, ex_t, ot, dt, LEVEL,
                                        cap, ray_fn=tfn)
    n = int(arr[3])
    assert n == int(ref[3]) == int(by_fn[3]) > RES * RES
    for a, b in zip(arr, by_fn):
        assert torch.equal(a, b)
    for r, a in zip(ref[:2], arr[:2]):
        np.testing.assert_array_equal(np.asarray(r), a.numpy())
    np.testing.assert_allclose(arr[2].numpy(), np.asarray(ref[2]),
                               rtol=DEPTH_RTOL[dtype], atol=0)
    _check_pack_ops(np.asarray(ref[0])[:n], np.asarray(ref[2])[:n, 0],
                    arr[0][:n], arr[2][:n, 0], dtype)


def _pack_ops(m, ridx, depth, n):
    """The pack ops of module ``m`` over one ray's hits a pack (``n``
    packs), the depth as the feature and a twentieth of it as the
    density (elementwise: a density from a reduction, such as the spread
    about the mean, differs by the reductions' rounding, which the
    transmittance's exp of a sum grows)."""
    b = m.mark_pack_boundaries(ridx)
    x = depth[:, None] * 10.
    tau = x * 0.05
    feats, trans = m.exponential_integration(x, tau, b)
    return (b, m.diff(x, b), m.sum_reduce(x, b), m.sum_reduce(x, b, n),
            m.cumsum(x, b), m.cumsum(x, b, exclusive=True, reverse=True),
            m.cumprod(x, b), m.cumprod(x, b, exclusive=True), feats, trans)


def _check_pack_ops(ridx_j, depth_j, ridx_t, depth_t, dtype):
    n = int(np.unique(ridx_j).shape[0])
    ref = jax.jit(lambda r, d: _pack_ops(jr, r, d, n))(jnp.asarray(ridx_j),
                                                       jnp.asarray(depth_j))
    out = _pack_ops(tr, ridx_t, depth_t, n)
    np.testing.assert_array_equal(np.asarray(ref[0]), out[0].numpy())
    with pytest.warns(DeprecationWarning):
        np.testing.assert_array_equal(tr.mark_first_hit(ridx_t).numpy(),
                                      out[0].numpy())
    tol = PACK_TOL[dtype]
    for r, o in zip(ref[1:], out[1:]):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, rtol=tol,
                                   atol=tol * np.abs(r).max())
