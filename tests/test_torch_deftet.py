"""The port's DefTet renderer against ``kaolin_tpu`` on the CPU: the
per-pixel top-``knum`` selection (``_select_topk``, the XLA route), the
interpolated features and the gradients of ``deftet_sparse_render``, and
config 4's step at a small size.

The same seeded numpy inputs go to both packages. Face ids must be equal;
features within 1e-10 at float64 and 1e-5 at float32; gradients within
1e-9 and 1e-4 of the largest entry. The XLA CPU backend fuses products
into sums (``fma``) where the port does not, so at float32 two candidate
depths of a pixel within an ulp may rank the other way (random slanted
faces at ``knum=300`` have such pairs). The float32 scenes therefore use
faces of constant depth, the depths of distinct faces 2^-12 apart, far
more than an ulp; duplicated faces there give exact ties, which both
packages break by the lower id. Slanted faces are compared at float64,
and kernel against plain version on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import kaolin_tpu as kal
import kaolin_tpu_torch as kt
from kaolin_tpu.render.mesh.deftet import _select_topk as jax_select
from kaolin_tpu_torch.kernels import deftet_topk as kd
from kaolin_tpu_torch.render.mesh.deftet import _select_topk

TOL = {np.float64: 1e-10, np.float32: 1e-5}
GRAD_TOL = {np.float64: 1e-9, np.float32: 1e-4}


def _pixels(side, dtype):
    ys, xs = np.meshgrid(np.linspace(-1, 1, side), np.linspace(-1, 1, side))
    pc = np.stack([xs.ravel(), ys.ravel()], -1)[None].astype(dtype)
    rr = np.tile([[-1e10, 0.]], (side * side, 1))[None].astype(dtype)
    return pc, rr


def _scene(kind, dtype, faces=2000, side=32, seed=0, dim=2):
    """(pixel coords, ranges, z, image coords, features), batch 1.
    'random': config 4's slanted faces; 'terraced': each face at one
    depth, distinct faces 2^-12 apart in a random order."""
    rng = np.random.default_rng(seed)
    pc, rr = _pixels(side, dtype)
    fvi = rng.uniform(-1, 1, (1, faces, 3, 2))
    ff = rng.random((1, faces, 3, dim))
    if kind == 'random':
        fvz = -1. - rng.random((1, faces, 3))
    else:
        z = -1. - (rng.permutation(faces) + 1) * 2. ** -12
        fvz = np.repeat(z[None, :, None], 3, axis=2)
    return tuple(a.astype(dtype) for a in (pc, rr, fvz, fvi, ff))


def _t(*arrays):
    return tuple(torch.tensor(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _select_both(pc, rr, fvz, fvi, valid, knum):
    ref = jax_select(*_j(pc, rr, fvz, fvi, valid), knum, 1e-8,
                     backend='xla')
    out = _select_topk(*_t(pc, rr, fvz, fvi, valid), knum, 1e-8)
    return np.asarray(ref), out


def _render_both(pc, rr, fvz, fvi, ff, **kw):
    ref = kal.render.mesh.deftet_sparse_render(*_j(pc, rr, fvz, fvi), (
        [jnp.asarray(f) for f in ff] if isinstance(ff, list)
        else jnp.asarray(ff)), **kw)
    out = kt.render.mesh.deftet_sparse_render(*_t(pc, rr, fvz, fvi), (
        [torch.tensor(f) for f in ff] if isinstance(ff, list)
        else torch.tensor(ff)), **{k: torch.tensor(v)
                                   if isinstance(v, np.ndarray) else v
                                   for k, v in kw.items()})
    return ref, out


def _feat_close(ref, out, dtype):
    np.testing.assert_allclose(np.asarray(ref), out.detach().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize('kind,dtype', [('random', np.float64),
                                        ('terraced', np.float64),
                                        ('terraced', np.float32)])
@pytest.mark.parametrize('knum', [1, 30, 300])
def test_select_topk_matches_xla(kind, dtype, knum):
    pc, rr, fvz, fvi, _ = _scene(kind, dtype)
    valid = np.ones((1, fvz.shape[1]), bool)
    ref, out = _select_both(pc, rr, fvz, fvi, valid, knum)
    assert out.dtype == torch.int32 and tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(ref, out.numpy())
    assert int((out >= 0).all(-1).sum()) > 0      # pixels where knum binds


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
@pytest.mark.parametrize('knum', [7, 30])
def test_tied_duplicates_straddle_knum(dtype, knum):
    """Every face twice (the copy at a higher id): every depth ties, and
    the ties straddle ``knum`` wherever a pixel holds more than ``knum``
    candidates; both keep the lower id first."""
    pc, rr, fvz, fvi, _ = _scene('terraced', dtype, faces=300, seed=1)
    perm = np.random.default_rng(2).permutation(300)
    fvz = np.concatenate([fvz, fvz[:, perm]], axis=1)
    fvi = np.concatenate([fvi, fvi[:, perm]], axis=1)
    valid = np.ones((1, 600), bool)
    ref, out = _select_both(pc, rr, fvz, fvi, valid, knum)
    np.testing.assert_array_equal(ref, out.numpy())
    full = (out >= 0).all(-1)
    assert int(full.sum()) > 0             # pixels where knum binds


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_signed_zero_depths(dtype):
    """Four faces over the whole image at depths -0.0, +0.0, -0.0, +0.0
    (ids 0-3), range (-1, 1): ``lax.top_k`` ranks +0.0 above -0.0, so the
    order is 1, 3, 0, 2 (the Pallas kernel's ``>`` would give 0, 1, 2,
    3)."""
    pc, rr = _pixels(8, dtype)
    rr = np.tile(np.array([[-1., 1.]], dtype), (64, 1))[None]
    tri = np.array([[-3., -3.], [3., -3.], [0., 3.]])
    fvi = np.tile(tri[None, None], (1, 4, 1, 1)).astype(dtype)
    fvz = np.array([-0., 0., -0., 0.], dtype)[None, :, None].repeat(3, 2)
    valid = np.ones((1, 4), bool)
    for knum in (4, 3, 1):
        ref, out = _select_both(pc, rr, fvz, fvi, valid, knum)
        np.testing.assert_array_equal(ref, out.numpy())
        assert (out.numpy() == np.array([1, 3, 0, 2])[:knum]).all()


def _split_merge_plain(pixel_coords, render_ranges, face_vertices_z,
                       face_vertices_image, valid_mask, knum, eps, splits):
    """The card's selection written out in PyTorch (float32): each of
    ``splits`` contiguous face ranges keeps, per pixel, its ``knum``
    largest 64-bit keys (the depth's total-order key in the high word,
    the complemented face id in the low word, hits only), then each
    pixel's ``splits * knum`` keys give its first ``knum`` face ids, -1
    past the last hit."""
    B, P, _ = pixel_coords.shape
    F = face_vertices_z.shape[1]
    img = face_vertices_image.reshape(B, F, 6)
    bbox = kd.face_bboxes(face_vertices_image, valid_mask)
    score = kd._scores(pixel_coords, render_ranges, face_vertices_z, img,
                       bbox, eps)
    ids = torch.arange(F, dtype=torch.int64)
    keys = (kd._order_key(score).to(torch.int64) << 32) | (~ids & 0xffffffff)
    empty = torch.iinfo(torch.int64).min
    keys = torch.where(score > float('-inf'), keys, empty)
    lists = []
    for s in range(splits):
        part = keys[..., F * s // splits:F * (s + 1) // splits]
        top = torch.sort(part, dim=-1, descending=True)[0][..., :knum]
        lists.append(torch.cat([top, torch.full(
            (B, P, knum - top.shape[-1]), empty)], dim=-1))
    top = torch.sort(torch.cat(lists, dim=-1), dim=-1,
                     descending=True)[0][..., :knum]
    return torch.where(top > empty, ~(top & 0xffffffff) & 0xffffffff,
                       -1).to(torch.int32)


def _split_case(case):
    """(pixel coords, ranges, z, image coords, valid mask) of one
    split-and-merge case, float32 torch tensors, batch 2 but 'signed_zero'
    (batch 1)."""
    if case == 'signed_zero':
        pc, rr = _pixels(8, np.float32)
        rr = np.tile(np.array([[-1., 1.]], np.float32), (64, 1))[None]
        tri = np.array([[-3., -3.], [3., -3.], [0., 3.]])
        fvi = np.tile(tri[None, None], (1, 6, 1, 1)).astype(np.float32)
        fvz = np.array([-0., 0., -0., 0., -0.5, 0.5],
                       np.float32)[None, :, None].repeat(3, 2)
        return _t(pc, rr, fvz, fvi, np.ones((1, 6), bool))
    scenes = [_scene('random', np.float32, faces=333, side=19, seed=s)
              for s in (5, 6)]
    pc, rr, fvz, fvi = (np.concatenate([sc[i] for sc in scenes])
                        for i in range(4))
    if case == 'ties':
        fvz = np.concatenate([fvz, fvz[:, ::-1]], axis=1)
        fvi = np.concatenate([fvi, fvi[:, ::-1]], axis=1)
    valid = np.random.default_rng(7).random(fvz.shape[:2]) > 0.2
    return _t(pc, rr, fvz, fvi, valid)


@pytest.mark.parametrize('case,knum', [('random', 1), ('random', 30),
                                       ('random', 64), ('random', 500),
                                       ('ties', 7), ('ties', 30),
                                       ('signed_zero', 5),
                                       ('signed_zero', 9)])
def test_split_merge_selection_matches_plain(case, knum):
    """The card's selection written out (each contiguous face range keeps
    its first ``knum`` 64-bit keys, then the ranges' lists merge) against
    :func:`deftet_topk_plain`: every face doubled (exact ties across
    ranges), +0.0 above -0.0, ``knum`` above the face count (500 > 333, 9
    > 6), face counts that no range count divides, and range counts up to
    the kernel's most, 32."""
    pc, rr, fvz, fvi, valid = _split_case(case)
    ref = kd.deftet_topk_plain(pc, rr, fvz, fvi, valid, knum, 1e-8)
    for splits in (1, 3, 4, 16, 32):
        out = _split_merge_plain(pc, rr, fvz, fvi, valid, knum, 1e-8,
                                 splits)
        assert torch.equal(out, ref), splits
    assert int((ref >= 0).sum()) > 0
    if case == 'signed_zero':
        assert (ref[0, :, :6] == torch.tensor([5, 1, 3, 0, 2, 4])[:knum]).all()
        assert (ref[..., 6:] == -1).all()


@pytest.mark.parametrize('kind,dtype', [('random', np.float64),
                                        ('terraced', np.float32)])
def test_valid_faces_and_list_features(kind, dtype):
    pc, rr, fvz, fvi, ff = _scene(kind, dtype, faces=800, dim=4, seed=3)
    valid = np.random.default_rng(4).random((1, 800)) > 0.3
    feats = [ff[..., :1], ff[..., 1:]]
    ref, out = _render_both(pc, rr, fvz, fvi, feats, knum=30,
                            valid_faces=valid)
    np.testing.assert_array_equal(np.asarray(ref[1]), out[1].numpy())
    assert not np.isin(out[1].numpy(), np.nonzero(~valid[0])[0]).any()
    assert isinstance(out[0], tuple) and len(out[0]) == 2
    for r, o in zip(ref[0], out[0]):
        assert tuple(o.shape) == r.shape
        _feat_close(r, o, dtype)


@pytest.mark.parametrize('kind,dtype', [('random', np.float64),
                                        ('terraced', np.float32)])
@pytest.mark.parametrize('knum', [30, 300])
def test_render_matches(kind, dtype, knum):
    """Ids and features, ``knum`` below and above the faces (60): empty
    slots hold -1 and zero features."""
    pc, rr, fvz, fvi, ff = _scene(kind, dtype, faces=60, seed=5)
    ref, out = _render_both(pc, rr, fvz, fvi, ff, knum=knum)
    np.testing.assert_array_equal(np.asarray(ref[1]), out[1].numpy())
    _feat_close(ref[0], out[0], dtype)
    assert tuple(out[0].shape) == (1, 1024, knum, 2)
    empty = out[1] < 0
    assert bool((out[0][empty] == 0).all()) and bool(empty.any())


def _loss_grads_jax(pc, rr, fvz, fvi, ff, knum):
    def loss(fvi, ff):
        feat, _ = kal.render.mesh.deftet_sparse_render(pc, rr, fvz, fvi, ff,
                                                       knum=knum)
        return jnp.sum(feat ** 2)
    val, (gi, gf) = jax.value_and_grad(loss, argnums=(0, 1))(
        jnp.asarray(fvi), jnp.asarray(ff))
    return float(val), np.asarray(gi), np.asarray(gf)


def _loss_grads_port(pc, rr, fvz, fvi, ff, knum):
    fvi_t = torch.tensor(fvi, requires_grad=True)
    ff_t = torch.tensor(ff, requires_grad=True)
    loss = kt.utils.interop.deftet_loss(*_t(pc, rr, fvz), fvi_t, ff_t,
                                        knum=knum)
    gi, gf = torch.autograd.grad(loss, [fvi_t, ff_t])
    return float(loss.detach()), gi.numpy(), gf.numpy()


def _grad_close(ref, out, dtype):
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(ref, out, rtol=GRAD_TOL[dtype],
                               atol=GRAD_TOL[dtype] * scale)


@pytest.mark.parametrize('kind,dtype', [('random', np.float64),
                                        ('terraced', np.float32)])
def test_gradients_match_jax_grad(kind, dtype):
    pc, rr, fvz, fvi, ff = _scene(kind, dtype, faces=400, side=24, seed=6)
    ref = _loss_grads_jax(*_j(pc, rr, fvz), fvi, ff, 30)
    out = _loss_grads_port(pc, rr, fvz, fvi, ff, 30)
    np.testing.assert_allclose(ref[0], out[0], rtol=TOL[dtype])
    _grad_close(ref[1], out[1], dtype)
    _grad_close(ref[2], out[2], dtype)


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_config4_step_small(dtype):
    """``bench_suite.py``'s config-4 step (sum of squared features,
    gradient to the image coords, ``fvi - 1e-9 * g``) on its seeded
    scene cut to 16x16 pixels and 500 faces, ``knum=30``; the seeded
    float32 scene holds no pair of candidates within an ulp."""
    torch_dtype = {np.float64: torch.float64, np.float32: torch.float32}
    scene = kt.utils.interop.deftet_scene(seed=0, side=16, num_faces=500,
                                          dtype=torch_dtype[dtype],
                                          device='cpu')
    pc, rr, fvz, fvi, ff = (a.numpy() for a in scene)
    ref = _loss_grads_jax(*_j(pc, rr, fvz), fvi, ff, 30)
    out = _loss_grads_port(pc, rr, fvz, fvi, ff, 30)
    np.testing.assert_allclose(ref[0], out[0], rtol=TOL[dtype])
    _grad_close(ref[1], out[1], dtype)
    step_ref = fvi - 1e-9 * ref[1]
    step = scene[3] - 1e-9 * torch.tensor(out[1])
    np.testing.assert_allclose(step_ref, step.numpy(), rtol=TOL[dtype])
    sel_ref = jax_select(*_j(pc, rr, fvz, fvi), jnp.ones((1, 500), bool),
                         30, 1e-8, backend='xla')
    sel = _select_topk(*scene[:4], torch.ones((1, 500), dtype=torch.bool),
                       30, 1e-8)
    np.testing.assert_array_equal(np.asarray(sel_ref), sel.numpy())


def test_deftet_scene_matches_bench_suite():
    """``deftet_scene`` draws config 4's inputs as ``bench_suite.py``
    does."""
    rng = np.random.default_rng(0)
    fvz = -1. - rng.random((1, 100, 3))
    fvi = rng.uniform(-1, 1, (1, 100, 3, 2))
    ff = rng.random((1, 100, 3, 2))
    pc, rr, z, img, feat = kt.utils.interop.deftet_scene(
        side=8, num_faces=100, device='cpu')
    for ref, out in ((fvz, z), (fvi, img), (ff, feat)):
        np.testing.assert_array_equal(ref.astype(np.float32), out.numpy())
    assert tuple(pc.shape) == (1, 64, 2) and float(rr[0, 0, 0]) == -1e10


def test_cpu_tensors_take_the_plain_version():
    pc, rr, fvz, fvi, _ = _t(*_scene('terraced', np.float32, faces=50,
                                     side=8))
    valid = torch.ones((1, 50), dtype=torch.bool)
    n = kd.deftet_topk.launches
    out = kd.deftet_topk(pc, rr, fvz, fvi, valid, 5, 1e-8)
    assert kd.deftet_topk.launches == n
    assert torch.equal(out, kd.deftet_topk_plain(pc, rr, fvz, fvi, valid, 5,
                                                 1e-8))
    with pytest.raises(ValueError):
        kd.deftet_topk(pc, rr, fvz[:, :10], fvi, valid, 5, 1e-8)
