"""Gradients of the PyTorch port against ``kaolin_tpu``'s on the CPU.

The same seeded numpy inputs and cotangents go through ``jax.grad`` of the
JAX function (``backend='xla'``, and once each its Pallas kernel in
interpret mode) and through ``torch.autograd.grad`` of the port, which runs
its plain versions on CPU tensors: ``rasterize``, ``dibr_soft_mask`` and
the whole DIB-R train step (``prepare_vertices`` -> ``dibr_rasterization``
-> L1 + ``mask_iou``, gradients to the vertices).

Tolerances, relative to the largest entry of the reference gradient: 1e-9
at float64 and 1e-4 at float32 (the two packages sum over pixels in
other orders and exp differs in the last bit; measured: 0 for rasterize,
5e-6 for the soft mask).
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import kaolin_tpu as kal
import kaolin_tpu_torch as kt
from __graft_entry__ import _scene

DTYPES = [np.float64, np.float32]
TOL = {np.float64: 1e-9, np.float32: 1e-4}


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


def _close(ref, out, dtype):
    ref = np.asarray(ref)
    out = out.detach().numpy()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    scale = float(np.abs(ref).max())
    assert scale > 0, 'degenerate test: zero gradient'
    np.testing.assert_allclose(out, ref, rtol=TOL[dtype],
                               atol=TOL[dtype] * scale)


def _soup(dtype, seed, batch=2, faces=40, dim=4, spread=0.9):
    rng = np.random.default_rng(seed)
    fvz = (-1. - rng.random((batch, faces, 3))).astype(dtype)
    fvi = rng.uniform(-spread, spread, (batch, faces, 3, 2)).astype(dtype)
    ff = rng.standard_normal((batch, faces, 3, dim)).astype(dtype)
    return fvz, fvi, ff


def _sphere(dtype, batch=2, subdiv=2):
    verts, faces, rot, trans, proj = _scene(batch, subdiv, jnp.dtype(dtype))
    fvc, fvi, fn = kal.render.mesh.prepare_vertices(
        verts, faces, proj, camera_rot=rot, camera_trans=trans)
    ff = jnp.concatenate([fvc, jnp.ones(fvc.shape[:3] + (1,), fvc.dtype)],
                         axis=-1)
    return (np.asarray(fvc[..., 2]), np.asarray(fvi), np.asarray(ff),
            np.asarray(fn[..., 2] >= 0.))


def _rasterize_grads(H, W, fvz, fvi, ff, valid=None, backend='xla',
                     split=None, **kw):
    """(JAX grads, port grads) of sum(features * cotangent) with respect
    to the image verts and the features. ``split`` passes the features
    as a list of two parts."""
    cot = np.random.default_rng(1).standard_normal(
        fvz.shape[:1] + (H, W, ff.shape[-1])).astype(fvz.dtype)
    jvalid = None if valid is None else jnp.asarray(valid)

    def parts(f):
        return [f[..., :split], f[..., split:]] if split else f

    def jloss(fvi_, ff_):
        feat, _ = kal.render.mesh.rasterize(
            H, W, jnp.asarray(fvz), fvi_, parts(ff_), jvalid,
            backend=backend, **kw)
        if split:
            feat = jnp.concatenate(feat, axis=-1)
        return jnp.sum(feat * cot)

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(fvi),
                                                   jnp.asarray(ff))
    tz, tv, tf = _t(fvz, True), _t(fvi, True), _t(ff, True)
    feat, _ = kt.render.mesh.rasterize(
        H, W, tz, tv, parts(tf), None if valid is None else _t(valid),
        **kw)
    if split:
        feat = torch.cat(feat, dim=-1)
    gz, gv, gf = torch.autograd.grad((feat * _t(cot)).sum(), [tz, tv, tf],
                                     allow_unused=True)
    assert gz is None, 'face_vertices_z gets no gradient'
    return ref, (gv, gf)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('size', [(16, 128), (24, 40)])
def test_rasterize_grad_sphere(dtype, size):
    """D = 4 with normal-z culling (``valid_faces``), the fused route."""
    fvz, fvi, ff, valid = _sphere(dtype)
    ref, out = _rasterize_grads(*size, fvz, fvi, ff, valid)
    for r, o in zip(ref, out):
        _close(r, o, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', ['list', 'valid', 'slab', 'wide'])
def test_rasterize_grad_soup(dtype, case):
    """A list of features; random ``valid_faces``; rows 8..23 of a 40-row
    image; D = 40 (the select route, beyond the JAX Pallas backward's
    ``7 + 3*D <= 128``)."""
    dim = 40 if case == 'wide' else 4
    fvz, fvi, ff = _soup(dtype, seed=5, dim=dim)
    kw = {}
    if case == 'list':
        kw['split'] = 1
    elif case == 'valid':
        kw['valid'] = np.random.default_rng(5).random(fvz.shape[:2]) > 0.4
    elif case == 'slab':
        kw.update(row_start=8, total_height=40)
    H = 16 if case == 'slab' else 24
    ref, out = _rasterize_grads(H, 40, fvz, fvi, ff, **kw)
    for r, o in zip(ref, out):
        _close(r, o, dtype)


def test_rasterize_grad_against_pallas_interpret():
    """One tiny case against the JAX package's Pallas backward in
    interpret mode, with the tolerance of its own test of that kernel
    against the XLA path (another summation order)."""
    fvz, fvi, ff = _soup(np.float32, seed=4, batch=1, faces=12)
    ref, out = _rasterize_grads(16, 128, fvz, fvi, ff,
                                backend='pallas_interpret')
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)


def _mask_soup(dtype, seed, faces, batch=2, H=16, W=128):
    """Random triangles and their face indices from the JAX rasterizer."""
    fvz, fvi, ff = _soup(dtype, seed, batch=batch, faces=faces, dim=1)
    _, idx = kal.render.mesh.rasterize(H, W, jnp.asarray(fvz),
                                       jnp.asarray(fvi), jnp.asarray(ff),
                                       backend='xla')
    return fvi, np.asarray(idx)


def _soft_mask_grads(fvi, idx, backend='xla', **kw):
    cot = np.random.default_rng(2).standard_normal(idx.shape).astype(
        fvi.dtype)

    def jloss(fvi_):
        return jnp.sum(kal.render.mesh.dibr_soft_mask(
            fvi_, jnp.asarray(idx), backend=backend, **kw) * cot)

    ref = jax.jit(jax.grad(jloss))(jnp.asarray(fvi))
    tv = _t(fvi, True)
    mask = kt.render.mesh.dibr_soft_mask(tv, _t(idx), **kw)
    out, = torch.autograd.grad((mask * _t(cot)).sum(), [tv])
    return ref, out


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('knum,faces', [(30, 24), (4, 60)])
def test_soft_mask_grad(dtype, knum, faces):
    """``knum`` not binding (at most 11 hits) and binding."""
    fvi, idx = _mask_soup(dtype, seed=7, faces=faces)
    ref, out = _soft_mask_grads(fvi, idx, sigmainv=7000, boxlen=0.05,
                                knum=knum, multiplier=1000.)
    _close(ref, out, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('sigmainv,boxlen', [(7000, 0.02), (70, 0.2)])
def test_soft_mask_grad_slab(dtype, sigmainv, boxlen):
    """Rows 8..23 of a 40-row image, odd width."""
    fvi, idx = _mask_soup(dtype, seed=9, faces=30, H=40, W=72)
    ref, out = _soft_mask_grads(fvi, idx[:, 8:24], sigmainv=sigmainv,
                                boxlen=boxlen, knum=30, multiplier=1000.,
                                row_start=8, total_height=40)
    _close(ref, out, dtype)


def test_soft_mask_grad_against_pallas_interpret():
    """One tiny case where ``knum`` does not bind against the JAX
    package's Pallas backward in interpret mode, with the tolerance of its
    own test of that kernel against the XLA path."""
    fvi, idx = _mask_soup(np.float32, seed=7, faces=24, batch=1)
    ref, out = _soft_mask_grads(fvi, idx, backend='pallas_interpret',
                                sigmainv=7000, boxlen=0.02, knum=30,
                                multiplier=1000.)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=5e-4,
                               atol=1e-4)


def test_gradcheck_soft_mask():
    """Finite differences at float64 on the plain path, as
    ``tests/test_gradcheck.py::test_soft_mask_grad``."""
    rng = np.random.default_rng(4)
    F = 5
    fvi = (rng.uniform(-0.6, 0.6, (1, F, 1, 2))
           + rng.uniform(-0.4, 0.4, (1, F, 3, 2)))
    fvz = torch.tensor(-(rng.uniform(1.5, 3.0, (1, F, 1))
                         * np.ones((1, 1, 3))))
    feats = torch.tensor(rng.uniform(0, 1, (1, F, 3, 2)))

    def f(v):
        _, mask, _ = kt.render.mesh.dibr_rasterization(
            12, 12, fvz, v, feats, torch.ones((1, F), dtype=v.dtype),
            sigmainv=70)
        return mask

    assert torch.autograd.gradcheck(f, (_t(fvi, True),), eps=3e-6,
                                    atol=1e-5, rtol=2e-3)


def test_gradcheck_rasterize_features():
    """As ``tests/test_gradcheck.py::test_rasterize_feature_grad``."""
    rng = np.random.default_rng(5)
    F = 6
    fvi = torch.tensor(rng.uniform(-0.7, 0.7, (1, F, 1, 2))
                       + rng.uniform(-0.5, 0.5, (1, F, 3, 2)))
    fvz = torch.tensor(-(rng.uniform(1.5, 3.0, (1, F, 1))
                         * np.ones((1, 1, 3))))

    def f(feats):
        out, _ = kt.render.mesh.rasterize(12, 12, fvz, fvi, feats)
        return out ** 2

    feats = _t(rng.uniform(0, 1, (1, F, 3, 2)), True)
    assert torch.autograd.gradcheck(f, (feats,), eps=1e-5, atol=5e-6,
                                    rtol=5e-4)


def _disc(H, W, radius, dtype):
    x = (2. * np.arange(W) + 1. - W) / W
    y = (H - 2. * np.arange(H) - 1.) / H
    return (x[None] ** 2 + y[:, None] ** 2 < radius ** 2).astype(dtype)


@pytest.mark.parametrize('dtype', DTYPES)
def test_train_step(dtype):
    """``bench.py``'s loss at a small size: L1 of the features to 0 plus
    ``mask_iou`` to a disc, gradient to the vertices; the loss, the
    gradient, and the vertices after 3 chained ``v - lr*g`` steps."""
    H, W, lr, steps = 32, 48, 1e-2, 3
    verts, faces, rot, trans, proj = _scene(2, 2, jnp.dtype(dtype))
    target = np.broadcast_to(_disc(H, W, 0.4, dtype), (2, H, W))

    def jloss(v):
        fvc, fvi, fn = kal.render.mesh.prepare_vertices(
            v, faces, proj, camera_rot=rot, camera_trans=trans)
        ff = jnp.concatenate([fvc, jnp.ones(fvc.shape[:3] + (1,),
                                            fvc.dtype)], axis=-1)
        feat, mask, _ = kal.render.mesh.dibr_rasterization(
            H, W, fvc[..., 2], fvi, ff, fn[..., 2], rast_backend='xla',
            mask_backend='xla')
        return (jnp.mean(jnp.abs(feat))
                + kal.metrics.render.mask_iou(mask, jnp.asarray(target)))

    tv, tf, trot, ttrans, tproj = kt.utils.interop.dibr_params_from_numpy(
        *(np.asarray(a) for a in (verts, faces, rot, trans, proj)),
        device='cpu')
    ttarget = _t(target)

    def tloss(v):
        fvc, fvi, fn = kt.render.mesh.prepare_vertices(
            v, tf, tproj, camera_rot=trot, camera_trans=ttrans)
        ff = torch.cat([fvc, torch.ones(fvc.shape[:3] + (1,),
                                        dtype=fvc.dtype)], dim=-1)
        feat, mask, _ = kt.render.mesh.dibr_rasterization(
            H, W, fvc[..., 2], fvi, ff, fn[..., 2])
        return feat.abs().mean() + kt.metrics.render.mask_iou(mask, ttarget)

    jgrad = jax.jit(jax.value_and_grad(jloss))
    jv, v = verts, tv
    for _ in range(steps):
        jl, jg = jgrad(jv)
        v = v.detach().requires_grad_(True)
        loss = tloss(v)
        g, = torch.autograd.grad(loss, [v])
        assert math.isclose(loss.item(), float(jl), rel_tol=TOL[dtype])
        _close(jg, g, dtype)
        assert float(g.abs().max()) > 0
        jv, v = jv - lr * jg, v - lr * g
    _close(jv, v, dtype)
