"""The PyTorch port's ``dibr_soft_mask`` and the whole forward slice
(``prepare_vertices`` -> ``dibr_rasterization`` -> ``mask_iou``) against
``kaolin_tpu`` on the CPU.

The reference is the JAX package's order-exact XLA path
(``backend='xla'``), and once its Pallas kernel in interpret mode where
``knum`` does not bind (the Pallas kernel keeps the first ``knum`` hits in
a spatially sorted order, so it differs by design where ``knum`` binds).
Both packages get the same face indices, so the soft mask is compared on
its own.

Tolerances: float64 1e-10; float32 2e-5 absolute (the masks lie in
[0, 1]; the JAX path multiplies a chunk's factors in another order than the
port, and exp differs in the last bit between the two libraries).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import kaolin_tpu as kal
import kaolin_tpu_torch as kt
from kaolin_tpu_torch.kernels import soft_mask as ks
from __graft_entry__ import _scene

DTYPES = [np.float64, np.float32]
TOL = {np.float64: 1e-10, np.float32: 2e-5}


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


def _soup(dtype, seed, faces, batch=2, H=16, W=128, spread=0.9):
    """Random triangles and their face indices from the JAX rasterizer."""
    rng = np.random.default_rng(seed)
    fvz = (-1. - rng.random((batch, faces, 3))).astype(dtype)
    fvi = rng.uniform(-spread, spread, (batch, faces, 3, 2)).astype(dtype)
    ff = rng.random((batch, faces, 3, 1)).astype(dtype)
    _, idx = kal.render.mesh.rasterize(H, W, jnp.asarray(fvz),
                                       jnp.asarray(fvi), jnp.asarray(ff),
                                       backend='xla')
    return fvi, np.asarray(idx)


def _hits(fvi, idx, boxlen, H, W):
    """Most enlarged-bbox hits on an uncovered pixel (numpy)."""
    m = 1000.
    v = fvi * m
    lo, hi = v.min(2) - boxlen * m, v.max(2) + boxlen * m
    x = m / W * (2 * np.arange(W) + 1 - W)
    y = m / H * (H - 2 * np.arange(H) - 1)
    inx = (x[None, None] >= lo[..., 0, None]) & (x < hi[..., 0, None])
    iny = (y[None, None] >= lo[..., 1, None]) & (y < hi[..., 1, None])
    count = np.einsum('bfh,bfw->bhw', iny.astype(int), inx.astype(int))
    return count[idx < 0].max()


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('knum,faces', [(30, 24), (4, 60), (1, 60)])
def test_soft_mask(dtype, knum, faces):
    fvi, idx = _soup(dtype, seed=7, faces=faces)
    kw = dict(sigmainv=7000, boxlen=0.05, knum=knum, multiplier=1000.)
    binds = _hits(fvi, idx, 0.05, 16, 128) > knum
    assert binds == (knum < 30), 'the case must (not) bind as named'
    ref = kal.render.mesh.dibr_soft_mask(jnp.asarray(fvi), jnp.asarray(idx),
                                         backend='xla', **kw)
    out = kt.render.mesh.dibr_soft_mask(_t(fvi), _t(idx), **kw)
    assert out.dtype == getattr(torch, np.dtype(dtype).name)
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=0,
                               atol=TOL[dtype])
    assert (out.numpy()[idx >= 0] == 1).all()


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('sigmainv,boxlen', [(7000, 0.02), (70, 0.2)])
def test_soft_mask_slab(dtype, sigmainv, boxlen):
    """Rows 8..23 of a 40-row image, odd width."""
    fvi, idx = _soup(dtype, seed=9, faces=30, H=40, W=72)
    kw = dict(sigmainv=sigmainv, boxlen=boxlen, knum=30, multiplier=1000.,
              row_start=8, total_height=40)
    sub = idx[:, 8:24]
    ref = kal.render.mesh.dibr_soft_mask(jnp.asarray(fvi), jnp.asarray(sub),
                                         backend='xla', **kw)
    out = kt.render.mesh.dibr_soft_mask(_t(fvi), _t(sub), **kw)
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=0,
                               atol=TOL[dtype])


def test_soft_mask_against_pallas_interpret():
    """One tiny case where knum does not bind against the JAX package's
    Pallas kernel in interpret mode; same tolerance as its own test of
    that kernel against the XLA path."""
    fvi, idx = _soup(np.float32, seed=7, faces=24, batch=1)
    kw = dict(sigmainv=7000, boxlen=0.02, knum=30, multiplier=1000.)
    ref = kal.render.mesh.dibr_soft_mask(jnp.asarray(fvi), jnp.asarray(idx),
                                         backend='pallas_interpret', **kw)
    out = kt.render.mesh.dibr_soft_mask(_t(fvi), _t(idx), **kw)
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize('knum_exact', [False, True])
def test_knum_exact_changes_nothing(knum_exact):
    fvi, idx = _soup(np.float64, seed=7, faces=60)
    kw = dict(knum=4, boxlen=0.05)
    base = kt.render.mesh.dibr_soft_mask(_t(fvi), _t(idx), **kw)
    out = kt.render.mesh.dibr_soft_mask(_t(fvi), _t(idx),
                                        knum_exact=knum_exact, **kw)
    assert torch.equal(base, out)


def test_plain_chunk_does_not_matter(monkeypatch):
    """The plain version's face chunking leaves the result unchanged: the
    product is taken face by face in face order, as the kernel takes it."""
    fvi, idx = _soup(np.float32, seed=8, faces=50)
    img = _t(fvi * np.float32(1000.)).reshape(2, -1, 6)
    lo, hi = img.reshape(2, -1, 3, 2).amin(2), img.reshape(2, -1, 3, 2).amax(2)
    bbox = torch.cat([lo - 50., hi + 50.], -1)
    kw = dict(height=16, width=128, knum=5, sigmainv=7000., multiplier=1000.)
    outs = []
    for chunk in (1, 7, 32):         # faces per chunk: budget // pixels
        monkeypatch.setattr(ks, '_PLAIN_BUDGET', chunk * 2 * 16 * 128)
        outs.append(ks.soft_mask_forward_plain(img, bbox, _t(idx), **kw))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    before = ks.soft_mask_forward.launches
    assert torch.equal(ks.soft_mask_forward(img, bbox, _t(idx), **kw),
                       outs[0])
    assert ks.soft_mask_forward.launches == before


@pytest.mark.parametrize('knum', [0, 1, 4, 30])
def test_plain_cut(monkeypatch, knum):
    """The cut the forward returns for the backward: per uncovered pixel
    the id of its knum-th enlarged-bbox hit in face order, or F where it has
    fewer; -1 on covered pixels and everywhere when knum is 0. Counted
    here pixel by pixel in numpy, at several face chunkings."""
    fvi, idx = _soup(np.float32, seed=8, faces=50)
    img = _t(fvi * np.float32(1000.)).reshape(2, -1, 6)
    lo, hi = img.reshape(2, -1, 3, 2).amin(2), img.reshape(2, -1, 3, 2).amax(2)
    bbox = torch.cat([lo - 50., hi + 50.], -1)
    H, W, F = 16, 128, 50
    x = (np.float32(1000. / W) * (2 * np.arange(W) + 1 - W)).astype(np.float32)
    y = (np.float32(1000. / H) * (H - 2 * np.arange(H) - 1)).astype(np.float32)
    bb = bbox.numpy()[:, :, None, None]
    hit = ((x >= bb[..., 0]) & (x < bb[..., 2])
           & (y[:, None] >= bb[..., 1]) & (y[:, None] < bb[..., 3]))
    want = np.full(idx.shape, F if knum else -1, np.int32)
    for b, r, c in zip(*np.nonzero(hit.sum(1) >= max(knum, 1))):
        if knum:
            want[b, r, c] = np.flatnonzero(hit[b, :, r, c])[knum - 1]
    want[idx >= 0] = -1
    if knum:        # 1 and 4 bind on some pixels, 30 on none
        assert (want == F).any()
        assert ((want >= 0) & (want < F)).any() == (knum < 30)
    kw =dict(height=H, width=W, knum=knum, sigmainv=7000., multiplier=1000.)
    for chunk in (1, 7, 32):
        monkeypatch.setattr(ks, '_PLAIN_BUDGET', chunk * 2 * H * W)
        mask, cut = ks.soft_mask_forward(img, bbox, _t(idx), return_cut=True,
                                         **kw)
        assert cut.dtype == torch.int32 and np.array_equal(cut.numpy(), want)
        assert torch.equal(mask, ks.soft_mask_forward(img, bbox, _t(idx),
                                                      **kw))


@pytest.mark.parametrize('covered', [False, True])
def test_soft_mask_backward_runs(covered):
    """The backward gives the image verts a finite gradient; where every
    pixel is covered the mask is 1 and the gradient 0."""
    fvi, idx = _soup(np.float64, seed=7, faces=24)
    if covered:
        idx = np.zeros_like(idx)
    fvi_t = _t(fvi).requires_grad_(True)
    mask = kt.render.mesh.dibr_soft_mask(fvi_t, _t(idx))
    grad, = torch.autograd.grad((mask * mask).sum(), [fvi_t])
    assert grad.shape == fvi_t.shape and torch.isfinite(grad).all()
    assert bool((grad == 0).all()) == covered


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('size', [(32, 128), (40, 72)])
def test_forward_slice(dtype, size):
    """prepare_vertices -> dibr_rasterization -> mask_iou, end to end."""
    H, W = size
    verts, faces, rot, trans, proj = _scene(2, 2, jnp.dtype(dtype))
    fvc, fvi, fn = kal.render.mesh.prepare_vertices(
        verts, faces, proj, camera_rot=rot, camera_trans=trans)
    ff = jnp.concatenate([fvc, jnp.ones(fvc.shape[:3] + (1,), fvc.dtype)],
                         -1)
    feat, mask, idx = kal.render.mesh.dibr_rasterization(
        H, W, fvc[..., 2], fvi, ff, fn[..., 2], rast_backend='xla',
        mask_backend='xla')
    target = jnp.roll(mask, 3, axis=2)
    loss = kal.metrics.render.mask_iou(mask, target)

    tv, tf, trot, ttrans, tproj = kt.utils.interop.dibr_params_from_numpy(
        *(np.asarray(a) for a in (verts, faces, rot, trans, proj)),
        device='cpu')
    tfvc, tfvi, tfn = kt.render.mesh.prepare_vertices(
        tv, tf, tproj, camera_rot=trot, camera_trans=ttrans)
    tff = torch.cat([tfvc, torch.ones(tfvc.shape[:3] + (1,),
                                      dtype=tfvc.dtype)], -1)
    tfeat, tmask, tidx = kt.render.mesh.dibr_rasterization(
        H, W, tfvc[..., 2], tfvi, tff, tfn[..., 2])
    tloss = kt.metrics.render.mask_iou(tmask, torch.roll(tmask, 3, dims=2))

    idx, tidx = np.asarray(idx), tidx.numpy()
    same = idx == tidx
    if dtype == np.float64:
        assert same.all()
    else:
        assert (~same).mean() <= 0.005
    np.testing.assert_allclose(np.asarray(feat)[same], tfeat.numpy()[same],
                               rtol=0, atol=TOL[dtype])
    np.testing.assert_allclose(np.asarray(mask), tmask.numpy(), rtol=0,
                               atol=TOL[dtype])
    np.testing.assert_allclose(float(loss), float(tloss), rtol=0,
                               atol=TOL[dtype])
    assert 0.3 < (tidx >= 0).mean() < 0.8
