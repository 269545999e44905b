"""The PyTorch port's ``rasterize`` against ``kaolin_tpu``'s on the CPU.

The reference is ``kaolin_tpu.render.mesh.rasterize(..., backend='xla')``
(and once its Pallas kernel in interpret mode); the port runs its plain
version, which is what its CUDA kernel is held to on the card. Inputs are
the DIB-R demo scene (an icosphere, normal-z culling) and seeded random
triangle soups, fed to both packages as the same numpy arrays.

Tolerances: at float64 ``face_idx`` is identical and features and weights
agree to 1e-10. At float32 the two packages' operation orders may differ
in the last bit (XLA fuses and reorders; the port does not), which can flip
an edge pixel: at most 0.5% of ``face_idx`` may differ, and features agree
to 1e-5 where the indices do.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import kaolin_tpu as kal
import kaolin_tpu_torch as kt
from kaolin_tpu_torch.kernels import rasterize as kr
from __graft_entry__ import _scene

DTYPES = [np.float64, np.float32]


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread: under the suite's six workers the default
    threads contend for the cores (one case of this file's took 10-20x its
    time alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.tensor(np.asarray(a))


def _compare(ref_feat, ref_idx, feat, idx, dtype):
    ref_feat, ref_idx = np.asarray(ref_feat), np.asarray(ref_idx)
    feat, idx = feat.numpy(), idx.numpy()
    assert idx.dtype == np.int32 and feat.dtype == ref_feat.dtype
    assert (idx >= 0).mean() > 0.05, 'degenerate test: nothing covered'
    same = ref_idx == idx
    if dtype == np.float64:
        np.testing.assert_array_equal(ref_idx, idx)
        np.testing.assert_allclose(ref_feat, feat, rtol=0, atol=1e-10)
    else:
        assert (~same).mean() <= 0.005, f'{(~same).sum()} pixels differ'
        np.testing.assert_allclose(ref_feat[same], feat[same], rtol=0,
                                   atol=1e-5)


def _sphere(dtype, batch=2, subdiv=2):
    verts, faces, rot, trans, proj = _scene(batch, subdiv, jnp.dtype(dtype))
    fvc, fvi, fn = kal.render.mesh.prepare_vertices(
        verts, faces, proj, camera_rot=rot, camera_trans=trans)
    ff = jnp.concatenate([fvc, jnp.ones(fvc.shape[:3] + (1,), fvc.dtype)],
                         axis=-1)
    return fvc[..., 2], fvi, ff, fn[..., 2] >= 0.


def _soup(dtype, seed=3, batch=2, faces=40, dim=4):
    rng = np.random.default_rng(seed)
    fvz = (-1. - rng.random((batch, faces, 3))).astype(dtype)
    fvi = rng.uniform(-0.9, 0.9, (batch, faces, 3, 2)).astype(dtype)
    ff = rng.standard_normal((batch, faces, 3, dim)).astype(dtype)
    return fvz, fvi, ff


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('size', [(32, 128), (40, 72)])
def test_sphere_culled(dtype, size):
    """D = 4, normal-z culling: the fused (interp) route."""
    fvz, fvi, ff, valid = _sphere(dtype)
    ref = kal.render.mesh.rasterize(*size, fvz, fvi, ff, valid,
                                    backend='xla')
    out = kt.render.mesh.rasterize(*size, _t(fvz), _t(fvi), _t(ff),
                                   _t(valid))
    _compare(*ref, *out, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
def test_list_features(dtype):
    fvz, fvi, ff = _soup(dtype)
    parts = [ff[..., :1], ff[..., 1:]]
    ref = kal.render.mesh.rasterize(32, 48, jnp.asarray(fvz),
                                    jnp.asarray(fvi),
                                    [jnp.asarray(p) for p in parts],
                                    backend='xla')
    out = kt.render.mesh.rasterize(32, 48, _t(fvz), _t(fvi),
                                   [_t(p) for p in parts])
    assert isinstance(out[0], tuple) and len(out[0]) == 2
    for r, o in zip(ref[0], out[0]):
        _compare(r, ref[1], o, out[1], dtype)


@pytest.mark.parametrize('dtype', DTYPES)
def test_valid_faces_soup(dtype):
    fvz, fvi, ff = _soup(dtype, seed=5)
    valid = np.random.default_rng(5).random(fvz.shape[:2]) > 0.4
    ref = kal.render.mesh.rasterize(24, 40, jnp.asarray(fvz),
                                    jnp.asarray(fvi), jnp.asarray(ff),
                                    jnp.asarray(valid), backend='xla')
    out = kt.render.mesh.rasterize(24, 40, _t(fvz), _t(fvi), _t(ff),
                                   _t(valid))
    _compare(*ref, *out, dtype)
    culled = ~valid
    idx = out[1].numpy()
    for b in range(idx.shape[0]):
        hit = idx[b][idx[b] >= 0]
        assert not culled[b][hit].any()


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('row_start', [0, 16, 33])
def test_slab(dtype, row_start):
    """Rows ``row_start ..`` of a taller image: the slab hook."""
    fvz, fvi, ff, valid = _sphere(dtype, batch=1)
    kw = dict(row_start=row_start, total_height=64)
    ref = kal.render.mesh.rasterize(16, 48, fvz, fvi, ff, valid,
                                    backend='xla', **kw)
    out = kt.render.mesh.rasterize(16, 48, _t(fvz), _t(fvi), _t(ff),
                                   _t(valid), **kw)
    _compare(*ref, *out, dtype)
    full = kt.render.mesh.rasterize(64, 48, _t(fvz), _t(fvi), _t(ff),
                                    _t(valid))
    np.testing.assert_array_equal(
        full[1][:, row_start:row_start + 16].numpy(), out[1].numpy())


@pytest.mark.parametrize('dtype', DTYPES)
def test_wide_features(dtype):
    """D = 40 > 38: the select route with the gather epilogue."""
    fvz, fvi, ff = _soup(dtype, seed=11, dim=40)
    assert 14 + 3 * ff.shape[-1] > 128
    ref = kal.render.mesh.rasterize(24, 56, jnp.asarray(fvz),
                                    jnp.asarray(fvi), jnp.asarray(ff),
                                    backend='xla')
    out = kt.render.mesh.rasterize(24, 56, _t(fvz), _t(fvi), _t(ff))
    _compare(*ref, *out, dtype)


@pytest.mark.parametrize('multiplier,eps', [(1000, 1e-8), (100., 1e-5)])
def test_multiplier_eps(multiplier, eps):
    fvz, fvi, ff = _soup(np.float64, seed=2)
    ref = kal.render.mesh.rasterize(20, 36, jnp.asarray(fvz),
                                    jnp.asarray(fvi), jnp.asarray(ff),
                                    multiplier=multiplier, eps=eps,
                                    backend='xla')
    out = kt.render.mesh.rasterize(20, 36, _t(fvz), _t(fvi), _t(ff),
                                   multiplier=multiplier, eps=eps)
    _compare(*ref, *out, np.float64)


def test_against_pallas_interpret():
    """One tiny case against the JAX package's Pallas kernel, run in
    interpret mode as its own tests run it."""
    fvz, fvi, ff = _soup(np.float32, seed=4, batch=1, faces=12)
    ref = kal.render.mesh.rasterize(16, 128, jnp.asarray(fvz),
                                    jnp.asarray(fvi), jnp.asarray(ff),
                                    backend='pallas_interpret')
    out = kt.render.mesh.rasterize(16, 128, _t(fvz), _t(fvi), _t(ff))
    np.testing.assert_array_equal(np.asarray(ref[1]), out[1].numpy())
    np.testing.assert_allclose(np.asarray(ref[0]), out[0].numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('route', ['interp', 'select'])
def test_kernel_outputs_on_cpu(route):
    """The wrappers on CPU tensors run the plain version and launch
    nothing; interp and select agree on the winner."""
    fvz, fvi, ff = (torch.tensor(a) for a in _soup(np.float32, seed=6))
    img = (fvi * 1000.).reshape(2, -1, 6)
    bbox = torch.cat([(fvi * 1000.).amin(2), (fvi * 1000.).amax(2)], -1)
    kw = dict(height=16, width=24, multiplier=1000., eps=1e-8)
    before = (kr.rasterize_interp.launches, kr.rasterize_select.launches)
    _, idx_i, w = kr.rasterize_interp(fvz, img, bbox, ff.reshape(2, -1, 12),
                                      **kw)
    zbuf, idx_s = kr.rasterize_select(fvz, img, bbox, **kw)
    assert (kr.rasterize_interp.launches,
            kr.rasterize_select.launches) == before
    assert torch.equal(idx_i, idx_s)
    if route == 'interp':
        covered = idx_i >= 0
        assert torch.allclose(w.sum(-1)[covered], torch.ones(()),
                              atol=1e-5)
        assert (w[~covered] == 0).all()
    else:
        assert torch.isneginf(zbuf[idx_s < 0]).all()
        assert torch.isfinite(zbuf[idx_s >= 0]).all()


@pytest.mark.parametrize('case', ['tensor', 'list', 'zero_cotangent'])
def test_backward_runs(case):
    """The backward gives the image verts and the features finite
    gradients, and ``face_vertices_z`` none; a zero cotangent (a
    silhouette-only loss) gives zeros, and a list of features (sliced,
    non-contiguous cotangents) the gradient of each part."""
    fvz, fvi, ff = (torch.tensor(a) for a in _soup(np.float64))
    for t in (fvz, fvi, ff):
        t.requires_grad_(True)
    feats = [ff[..., :1], ff[..., 1:]] if case == 'list' else ff
    feat, _ = kt.render.mesh.rasterize(16, 24, fvz, fvi, feats)
    out = feat[1] if case == 'list' else feat
    scale = 0. if case == 'zero_cotangent' else 1.
    gz, gv, gf = torch.autograd.grad((out * scale).sum(), [fvz, fvi, ff],
                                     allow_unused=True)
    assert gz is None
    assert gv.shape == fvi.shape and gf.shape == ff.shape
    assert torch.isfinite(gv).all() and torch.isfinite(gf).all()
    if case == 'zero_cotangent':
        assert (gv == 0).all() and (gf == 0).all()
    else:
        assert (gv != 0).any() and (gf != 0).any()
    if case == 'list':
        assert (gf[..., 0] == 0).all() and (gf[..., 1:] != 0).any()
