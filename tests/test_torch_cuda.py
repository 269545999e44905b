"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``; each test skips where no CUDA device is visible.
Run them on a GPU machine with::

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(``--noconftest``: ``tests/conftest.py`` sets up JAX, which this file
does not use.)

The kernels repeat the plain versions' operations in their order without
fused multiply-adds, so face indices, weights and features agree exactly;
the soft mask to 1e-6 (``expf``). The backward kernels sum over pixels in
another order than the plain versions: each gradient entry agrees to 1e-4
of itself plus 1e-4 of the median nonzero entry, and two launches give the
same bits. The soft mask's cut agrees exactly. The grid-sample kernels
repeat the plain versions' operations too: the samples and the coordinate
gradients agree exactly (in their UV mode, behind ``texture_mapping``, the
samples and both gradients are the PyTorch composition's bits); the
texture gradient sums in a fixed order of its own, agrees entry by entry
as the other gradients do, and is bit for bit the order written out in
``texture_grad_tiled_plain``, its lists those of ``tile_lists_plain``.
The DefTet
selection and the SPC traversal score and test as their plain versions do,
so face ids, ray and point ids, counts and depths agree exactly.
"""

import numpy as np
import pytest
import torch

import kaolin_tpu_torch as kt
from kaolin_tpu_torch.kernels import deftet_topk as kd
from kaolin_tpu_torch.kernels import nn_distance as kn
from kaolin_tpu_torch.kernels import p2m_distance as kp
from kaolin_tpu_torch.kernels import rasterize as kr
from kaolin_tpu_torch.kernels import rasterize_bwd as krb
from kaolin_tpu_torch.kernels import soft_mask as ks
from kaolin_tpu_torch.kernels import spc_traverse as kst
from kaolin_tpu_torch.kernels import texture as ktex
from kaolin_tpu_torch.render.mesh.dibr import _scaled_inputs
from kaolin_tpu_torch.render.mesh.rasterization import _kernel_inputs

GRAD_TOL = 1e-4

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _inputs(device, seed=0, batch=2, faces=300, dim=4):
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-0.9, 0.9, (batch, faces, 1, 2))
    fvi = centre + rng.uniform(-0.1, 0.1, (batch, faces, 3, 2))
    fvz = -1. - rng.random((batch, faces, 3))
    ff = rng.standard_normal((batch, faces, 3, dim))
    return tuple(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in (fvz, fvi, ff))


@pytest.mark.parametrize('size', [(64, 64), (40, 72), (33, 130)])
@pytest.mark.parametrize('dim', [4, 40])
def test_rasterize_kernel_matches_plain(cuda, size, dim):
    fvz, fvi, ff = _inputs(cuda, dim=dim)
    valid = torch.rand(fvz.shape[:2], device=cuda) > 0.2
    fz, img, bbox = _kernel_inputs(fvz, fvi, valid, 1000.)
    kw = dict(height=size[0], width=size[1], multiplier=1000., eps=1e-8,
              row_start=3, total_height=size[0] + 7)
    feats = ff.reshape(2, -1, 3 * dim)
    n = kr.rasterize_interp.launches
    out = kr.rasterize_interp(fz, img, bbox, feats, **kw)
    assert kr.rasterize_interp.launches == n + 1
    ref = kr.rasterize_interp_plain(fz, img, bbox, feats, **kw)
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    z, idx = kr.rasterize_select(fz, img, bbox, **kw)
    zp, idxp = kr.rasterize_select_plain(fz, img, bbox, **kw)
    assert torch.equal(idx, idxp) and torch.equal(z, zp)


@pytest.mark.parametrize('knum', [30, 3])
def test_soft_mask_kernel_matches_plain(cuda, knum):
    fvz, fvi, ff = _inputs(cuda, faces=400)
    _, idx = kt.render.mesh.rasterize(48, 80, fvz, fvi, ff)
    img, bbox = _scaled_inputs(fvi, 0.05, 1000.)
    kw = dict(height=48, width=80, knum=knum, sigmainv=7000.,
              multiplier=1000.)
    n = ks.soft_mask_forward.launches
    out = ks.soft_mask_forward(img, bbox, idx, **kw)
    assert ks.soft_mask_forward.launches == n + 1
    ref = ks.soft_mask_forward_plain(img, bbox, idx, **kw)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)


def test_cuda_rejects_float64(cuda):
    fvz, fvi, ff = (t.double() for t in _inputs(cuda))
    with pytest.raises(TypeError, match='float32'):
        kt.render.mesh.rasterize(16, 16, fvz, fvi, ff)


def test_no_faces_on_card(cuda):
    """No faces: ``rasterize`` (D = 2 and 40), ``dibr_rasterization`` and
    ``deftet_sparse_render`` give the empty render and zero gradients, and
    launch no kernel."""
    counters = (kr.rasterize_interp, kr.rasterize_select,
                ks.soft_mask_forward, krb.rasterize_backward,
                ks.soft_mask_backward, kd.deftet_topk)
    before = [c.launches for c in counters]
    fvz = torch.zeros(2, 0, 3, device=cuda)
    fvi = torch.zeros(2, 0, 3, 2, device=cuda, requires_grad=True)
    for dim in (2, 40):
        ff = torch.zeros(2, 0, 3, dim, device=cuda, requires_grad=True)
        feat, idx = kt.render.mesh.rasterize(8, 8, fvz, fvi, ff)
        assert feat.shape == (2, 8, 8, dim) and not feat.any()
        assert idx.shape == (2, 8, 8) and (idx == -1).all()
        gv, gf = torch.autograd.grad(feat.sum(), [fvi, ff])
        assert gv.shape == fvi.shape and gf.shape == ff.shape
    ff = torch.zeros(2, 0, 3, 2, device=cuda, requires_grad=True)
    feat, mask, idx = kt.render.mesh.dibr_rasterization(
        8, 8, fvz, fvi, ff, torch.zeros(2, 0, device=cuda))
    assert not feat.any() and not mask.any() and (idx == -1).all()
    gv, = torch.autograd.grad(feat.sum() + mask.sum(), [fvi])
    assert gv.shape == fvi.shape
    pc = torch.rand(2, 16, 2, device=cuda, requires_grad=True)
    rr = torch.tensor([-1e10, 0.], device=cuda).expand(2, 16, 2)
    feat, sel = kt.render.mesh.deftet_sparse_render(pc, rr, fvz, fvi, ff,
                                                    knum=3)
    assert feat.shape == (2, 16, 3, 2) and not feat.any()
    assert sel.shape == (2, 16, 3) and (sel == -1).all()
    gp, = torch.autograd.grad(feat.sum(), [pc])
    assert not gp.any()
    assert [c.launches for c in counters] == before


FWD_CASES = ['sphere', 'large', 'edges', 'slab', 'ties', 'offscreen', 'many']


def _same_bits(a, b):
    if a.is_floating_point():
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _fwd_scene(case, device):
    """The forward kernels' inputs for a scene: rasterize's (z, scaled
    verts, bboxes with culled faces empty, flat features), the soft mask's
    (scaled verts, enlarged bboxes) and the image (H, W, row_start,
    total_height). 'many': 3,000 faces over a few tiles of a 128x128 image
    (lists of several slots and stages)."""
    H = W = 64
    row_start, total, valid = 0, 64, None
    rng = np.random.default_rng(len(case))
    if case in ('sphere', 'large'):
        subdiv, scale = (2, 1.) if case == 'sphere' else (1, 1.35)
        verts, faces, rot, trans, proj = kt.utils.interop.scene(
            2, subdiv, device=device)
        fvc, fvi, fn = kt.render.mesh.prepare_vertices(
            verts * scale, faces, proj, camera_rot=rot, camera_trans=trans)
        ff = torch.cat([fvc, torch.ones(fvc.shape[:3] + (1,),
                                        device=device)], -1)
        fvz, valid = fvc[..., 2], fn[..., 2] >= 0.
    else:
        n = 3000 if case == 'many' else 40
        fvi = rng.uniform(-0.9, 0.9, (2, n, 1, 2)) + rng.uniform(
            -0.2, 0.2, (2, n, 3, 2))
        fvz = -1. - rng.random((2, n, 3))
        if case == 'many':
            H = W = total = 128
            fvi = rng.uniform(-0.1, 0.1, (2, n, 1, 2)) + rng.uniform(
                -0.03, 0.03, (2, n, 3, 2))
        elif case == 'edges':
            # vertices on pixel centres, bboxes ending on tile edges'
            cols = rng.choice([14, 15, 16, 17, 31, 32, 33, 47, 48],
                              (2, n, 3))
            rows = rng.choice([14, 15, 16, 17, 31, 32, 47, 48, 49],
                              (2, n, 3))
            fvi = np.stack([(2 * cols + 1 - W) / W, (H - 2 * rows - 1) / H],
                           -1)
        elif case == 'slab':
            H, row_start, total = 24, 20, 72
        elif case == 'ties':
            fvz[:, :20:3] = 0.
            fvz[:, 1:20:6] = -0.
            fvi[:, 20:] = fvi[:, :20]
            fvz[:, 20:] = fvz[:, :20]
        elif case == 'offscreen':
            fvi[:, :15] += 3.
            fvi[:, 15:20] -= 3.
        fvi = torch.tensor(fvi, dtype=torch.float32, device=device)
        fvz = torch.tensor(fvz, dtype=torch.float32, device=device)
        ff = torch.tensor(rng.random((2, n, 3, 3)), dtype=torch.float32,
                          device=device)
    fz, img, bbox = _kernel_inputs(fvz, fvi, valid, 1000.)
    sm_img, sm_bbox = _scaled_inputs(fvi, 0.02, 1000.)
    B, F = fvi.shape[:2]
    return ((fz, img, bbox, ff.reshape(B, F, -1)), (sm_img, sm_bbox),
            (H, W, row_start, total))


@pytest.mark.parametrize('case', FWD_CASES)
def test_tile_bins_match_plain(cuda, case):
    """The card's per-tile lists are the plain binning's, bit for bit, and
    two launches agree."""
    (_, _, bbox, _), (_, sm_bbox), (H, W, row_start, total) = _fwd_scene(
        case, cuda)
    kw = dict(height=H, width=W, total_height=total, multiplier=1000.)
    for bb in (bbox, sm_bbox):
        bins = kr.tile_bins(bb, row_start, **kw)
        assert torch.equal(bins, kr.tile_bins_plain(bb, row_start, **kw))
        assert torch.equal(bins, kr.tile_bins(bb, row_start, **kw))
        assert bool(bins.any())


@pytest.mark.parametrize('case', FWD_CASES)
def test_forward_kernels_scenes(cuda, case):
    """Both rasterize modes and the soft mask (knum 1, 2, 30 and F) against
    their plain versions, over their own lists and over the soft mask's
    enlarged ones (``dibr_rasterization``'s shared binning); two launches
    bit-identical; one count a call."""
    (fz, img, bbox, feat), (sm_img, sm_bbox), (H, W, row_start, total) = \
        _fwd_scene(case, cuda)
    F = fz.shape[1]
    kw = dict(height=H, width=W, total_height=total, multiplier=1000.,
              eps=1e-8)
    shared = kr.tile_bins(sm_bbox, row_start, height=H, width=W,
                          total_height=total, multiplier=1000.)
    ref = kr.rasterize_interp_plain(fz, img, bbox, feat, row_start, **kw)
    ref_s = kr.rasterize_select_plain(fz, img, bbox, row_start, **kw)
    assert bool((ref[1] >= 0).any())
    for bkw in ({}, {'bins': shared}):
        n = kr.rasterize_interp.launches, kr.rasterize_select.launches
        out = kr.rasterize_interp(fz, img, bbox, feat, row_start, **kw, **bkw)
        again = kr.rasterize_interp(fz, img, bbox, feat, row_start, **kw,
                                    **bkw)
        sel = kr.rasterize_select(fz, img, bbox, row_start, **kw, **bkw)
        sel2 = kr.rasterize_select(fz, img, bbox, row_start, **kw, **bkw)
        assert (kr.rasterize_interp.launches, kr.rasterize_select.launches
                ) == (n[0] + 2, n[1] + 2)
        for o, a, r in zip(out + sel, again + sel2, ref + ref_s):
            assert torch.equal(o, r) and _same_bits(o, a)
    idx = ref[1]
    for knum in (1, 2, 30, F):
        skw = dict(height=H, width=W, total_height=total, knum=knum,
                   sigmainv=7000., multiplier=1000.)
        m_p, c_p = ks.soft_mask_forward_plain(sm_img, sm_bbox, idx, row_start,
                                              return_cut=True, **skw)
        for bkw in ({}, {'bins': shared}):
            n = ks.soft_mask_forward.launches
            m, c = ks.soft_mask_forward(sm_img, sm_bbox, idx, row_start,
                                        return_cut=True, **skw, **bkw)
            m2, c2 = ks.soft_mask_forward(sm_img, sm_bbox, idx, row_start,
                                          return_cut=True, **skw, **bkw)
            assert ks.soft_mask_forward.launches == n + 2
            torch.testing.assert_close(m, m_p, rtol=0, atol=1e-6)
            assert torch.equal(c, c_p)
            assert _same_bits(m, m2) and torch.equal(c, c2)


def test_forward_empty_calls_count_no_launch(cuda):
    """A forward call with no pixel launches and counts nothing; one with
    no faces launches once and writes the empty render."""
    counters = (kr.rasterize_interp, kr.rasterize_select,
                ks.soft_mask_forward)
    before = [c.launches for c in counters]
    kw = dict(multiplier=1000., eps=1e-8)
    skw = dict(knum=3, sigmainv=7000., multiplier=1000.)
    for B, h, w in ((0, 16, 16), (2, 0, 16), (2, 16, 0)):
        fz, img, bbox = (torch.zeros(B, 5, k, device=cuda) for k in (3, 6, 4))
        feat = torch.zeros(B, 5, 12, device=cuda)
        f, i, wt = kr.rasterize_interp(fz, img, bbox, feat, height=h,
                                       width=w, **kw)
        assert f.shape == (B, h, w, 4) and i.shape == (B, h, w)
        z, i = kr.rasterize_select(fz, img, bbox, height=h, width=w, **kw)
        assert z.shape == (B, h, w)
        m, c = ks.soft_mask_forward(img, bbox, i, height=h, width=w,
                                    return_cut=True, **skw)
        assert m.shape == c.shape == (B, h, w)
    assert [c.launches for c in counters] == before
    empty = [torch.zeros(2, 0, k, device=cuda) for k in (3, 6, 4, 12)]
    f, i, wt = kr.rasterize_interp(*empty, height=8, width=8, **kw)
    m, c = ks.soft_mask_forward(empty[1], empty[2], i, height=8, width=8,
                                return_cut=True, **skw)
    assert bool((i == -1).all()) and not f.any() and not wt.any()
    assert not m.any() and bool((c == 0).all())
    assert [c.launches for c in counters] == [before[0] + 1, before[1],
                                              before[2] + 1]


def test_render_on_card_matches_cpu(cuda):
    verts, faces, rot, trans, proj = kt.utils.interop.scene(2, 2,
                                                            device=cuda)
    fvc, fvi, fn = kt.render.mesh.prepare_vertices(
        verts, faces, proj, camera_rot=rot, camera_trans=trans)
    args = (fvc[..., 2], fvi, fvc, fn[..., 2])
    gpu = kt.render.mesh.dibr_rasterization(64, 96, *args)
    cpu = kt.render.mesh.dibr_rasterization(64, 96,
                                            *(a.cpu() for a in args))
    assert torch.equal(gpu[2].cpu(), cpu[2])
    torch.testing.assert_close(gpu[0].cpu(), cpu[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(gpu[1].cpu(), cpu[1], rtol=0, atol=1e-6)


def _grad_close(out, ref):
    """Every entry within GRAD_TOL of itself plus GRAD_TOL of the median
    nonzero entry, so a wrong sum for one face fails however large the
    largest gradient is."""
    nonzero = ref[ref != 0].abs()
    assert nonzero.numel() > 0
    torch.testing.assert_close(out, ref, rtol=GRAD_TOL,
                               atol=GRAD_TOL * float(nonzero.median()))


@pytest.mark.parametrize('size', [(64, 64), (33, 130)])
@pytest.mark.parametrize('dim', [4, 40])
def test_rasterize_backward_kernel_matches_plain(cuda, size, dim):
    fvz, fvi, ff = _inputs(cuda, dim=dim)
    fz, img, bbox = _kernel_inputs(fvz, fvi, None, 1000.)
    feats = ff.reshape(2, -1, 3 * dim)
    slab = dict(row_start=3, total_height=size[0] + 7)
    _, idx, weights = kr.rasterize_interp(
        fz, img, bbox, feats, height=size[0], width=size[1],
        multiplier=1000., eps=1e-8, **slab)
    grad = torch.randn(2, *size, dim, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(0))
    args = (grad, idx, weights, fvi.reshape(2, -1, 6), feats)
    n = krb.rasterize_backward.launches
    out = krb.rasterize_backward(*args, eps=1e-8, **slab)
    again = krb.rasterize_backward(*args, eps=1e-8, **slab)
    assert krb.rasterize_backward.launches == n + 2
    ref = krb.rasterize_backward_plain(*args, eps=1e-8)
    for o, a, r in zip(out, again, ref):
        assert torch.equal(o, a)
        _grad_close(o, r)


@pytest.mark.parametrize('knum', [30, 3])
def test_soft_mask_backward_kernel_matches_plain(cuda, knum):
    fvz, fvi, ff = _inputs(cuda, faces=400)
    _, idx = kt.render.mesh.rasterize(48, 80, fvz, fvi, ff)
    img, bbox = _scaled_inputs(fvi, 0.05, 1000.)
    kw = dict(height=48, width=80, knum=knum, sigmainv=7000.,
              multiplier=1000.)
    mask, cut = ks.soft_mask_forward(img, bbox, idx, return_cut=True, **kw)
    mask_p, cut_p = ks.soft_mask_forward_plain(img, bbox, idx,
                                               return_cut=True, **kw)
    assert torch.equal(cut, cut_p)
    torch.testing.assert_close(mask, mask_p, rtol=0, atol=1e-6)
    grad = torch.randn(2, 48, 80, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(1))
    n = ks.soft_mask_backward.launches
    del kw['knum']                 # the cut carries it
    out = ks.soft_mask_backward(img, bbox, cut, mask, grad, **kw)
    again = ks.soft_mask_backward(img, bbox, cut, mask, grad, **kw)
    assert ks.soft_mask_backward.launches == n + 2
    assert torch.equal(out, again)
    _grad_close(out, ks.soft_mask_backward_plain(img, bbox, cut, mask, grad,
                                                 **kw))


def _bwd_scene(device, case, dim=4, faces=40):
    """A scene of the backward kernels' walks (as
    ``tests/test_torch_render_bwd.py`` writes them out): (fvz, fvi,
    features, valid, H, W, row_start, total height). 'whole': a sliver
    along the diagonal, whose rectangle is the whole 72x72 image, in
    front; 'unowned': faces off screen and culled; 'slab': rows 10..21 of
    a 32-row image; 'big': faces larger than a warp's share, which take
    the whole block; 'many8k', 'many64k': 8,192 or 65,536 small faces a
    batch entry, so that a warp culls 4 or 32 faces at once; else random
    faces."""
    rng = np.random.default_rng(21)
    H = W = 48
    row_start, total = 0, None
    size = 0.6 if case == 'big' else 0.2
    if case.startswith('many'):
        faces, size, H, W = {'many8k': 8192, 'many64k': 65536}[case], 0.03, 64, 64
    fvi = (rng.uniform(-0.9, 0.9, (2, faces, 1, 2))
           + rng.uniform(-size, size, (2, faces, 3, 2)))
    fvz = -1. - rng.random((2, faces, 3))
    valid = np.ones((2, faces), bool)
    if case == 'whole':
        fvi[:, 0] = [[-1.2, -1.2], [1.2, 1.2], [1.2, 1.1]]
        fvz[:, 0] = -0.5
        H = W = 72
    elif case == 'unowned':
        fvi[:, :6] += 3.
        valid[:, 6:14] = False
    elif case == 'slab':
        H, row_start, total = 12, 10, 32
    elif case == 'big':
        H = W = 96
    ff = rng.standard_normal((2, faces, 3, dim))
    fvz, fvi, ff = (torch.tensor(a, dtype=torch.float32, device=device)
                    for a in (fvz, fvi, ff))
    return (fvz, fvi, ff, torch.tensor(valid, device=device), H, W,
            row_start, total or H)


@pytest.mark.parametrize('case,dim', [('soup', 1), ('soup', 9),
                                      ('whole', 4), ('whole', 40),
                                      ('unowned', 4), ('slab', 40),
                                      ('big', 4), ('big', 70),
                                      ('many8k', 4), ('many64k', 40)])
def test_rasterize_backward_scenes(cuda, case, dim):
    """The redesigned rasterize backward against its plain version, two
    launches bit-identical: a face whose rectangle is the whole image,
    faces that own no pixel, slab rows, faces that take the whole block,
    warps that cull 4 and 32 faces, D = 1, 9, 40 (one walk) and 70 (two
    walks)."""
    fvz, fvi, ff, valid, H, W, row_start, total = _bwd_scene(cuda, case, dim)
    B, F = fvi.shape[:2]
    fz, img, bbox = _kernel_inputs(fvz, fvi, valid, 1000.)
    feats = ff.reshape(B, F, 3 * dim)
    slab = dict(row_start=row_start, total_height=total)
    _, idx, weights = kr.rasterize_interp_plain(
        fz, img, bbox, feats, height=H, width=W, multiplier=1000., eps=1e-8,
        **slab)
    grad = torch.randn(B, H, W, dim, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(2))
    args = (grad, idx, weights, fvi.reshape(B, F, 6), feats)
    n = krb.rasterize_backward.launches
    out = krb.rasterize_backward(*args, eps=1e-8, **slab)
    again = krb.rasterize_backward(*args, eps=1e-8, **slab)
    assert krb.rasterize_backward.launches == n + 2
    ref = krb.rasterize_backward_plain(*args, eps=1e-8)
    for o, a, r in zip(out, again, ref):
        assert torch.equal(o, a)
        _grad_close(o, r)
    if case == 'unowned':
        assert not out[0][:, :14].any() and not out[1][:, :14].any()


@pytest.mark.parametrize('case,knum', [('whole', 30), ('unowned', 2),
                                       ('slab', 1), ('big', 30),
                                       ('soup', 30), ('many8k', 30),
                                       ('many64k', 30)])
def test_soft_mask_backward_scenes(cuda, case, knum):
    """The redesigned soft-mask backward against its plain version, two
    launches bit-identical, on the same scenes (boxlen 0.05), knum 1, 2
    and 30, a zero cotangent on every third column."""
    fvz, fvi, ff, valid, H, W, row_start, total = _bwd_scene(cuda, case)
    B = fvi.shape[0]
    _, idx = kt.render.mesh.rasterize(H, W, fvz, fvi, ff, valid,
                                      row_start=row_start,
                                      total_height=total)
    img, bbox = _scaled_inputs(fvi, 0.05, 1000.)
    kw = dict(row_start=row_start, height=H, width=W, total_height=total,
              sigmainv=7000., multiplier=1000.)
    mask, cut = ks.soft_mask_forward(img, bbox, idx, knum=knum,
                                     return_cut=True, **kw)
    grad = torch.randn(B, H, W, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(3))
    grad[..., ::3] = 0.
    n = ks.soft_mask_backward.launches
    out = ks.soft_mask_backward(img, bbox, cut, mask, grad, **kw)
    again = ks.soft_mask_backward(img, bbox, cut, mask, grad, **kw)
    assert ks.soft_mask_backward.launches == n + 2
    assert torch.equal(out, again)
    _grad_close(out, ks.soft_mask_backward_plain(img, bbox, cut, mask, grad,
                                                 **kw))


def test_render_backward_empty_calls_count_no_launch(cuda):
    """With no faces the backward wrappers return empty gradients and
    count no launch."""
    counters = (krb.rasterize_backward, ks.soft_mask_backward)
    before = [c.launches for c in counters]
    img = torch.zeros(2, 0, 6, device=cuda)
    gi, gf = krb.rasterize_backward(
        torch.ones(2, 8, 8, 4, device=cuda),
        torch.full((2, 8, 8), -1, dtype=torch.int32, device=cuda),
        torch.zeros(2, 8, 8, 3, device=cuda), img,
        torch.zeros(2, 0, 12, device=cuda), eps=1e-8)
    assert gi.shape == (2, 0, 6) and gf.shape == (2, 0, 12)
    g = ks.soft_mask_backward(
        img, torch.zeros(2, 0, 4, device=cuda),
        torch.full((2, 8, 8), 0, dtype=torch.int32, device=cuda),
        torch.zeros(2, 8, 8, device=cuda), torch.ones(2, 8, 8, device=cuda),
        height=8, width=8, sigmainv=7000., multiplier=1000.)
    assert g.shape == (2, 0, 6)
    assert [c.launches for c in counters] == before


def test_train_step_on_card_matches_cpu(cuda):
    """The gradient of L1 + mask_iou to the vertices, on the card and
    with the plain versions on the CPU."""
    scene = kt.utils.interop.scene(2, 2, device=cuda)

    def grad_of(device):
        verts, faces, rot, trans, proj = (t.to(device) for t in scene)
        verts = verts.clone().requires_grad_(True)
        fvc, fvi, fn = kt.render.mesh.prepare_vertices(
            verts, faces, proj, camera_rot=rot, camera_trans=trans)
        feat, mask, _ = kt.render.mesh.dibr_rasterization(
            64, 96, fvc[..., 2], fvi, fvc, fn[..., 2])
        target = torch.roll(mask.detach(), 5, dims=2)
        loss = feat.abs().mean() + kt.metrics.render.mask_iou(mask, target)
        return torch.autograd.grad(loss, [verts])[0]

    gpu, cpu = grad_of(cuda), grad_of('cpu')
    assert torch.isfinite(gpu).all() and (gpu != 0).any()
    _grad_close(gpu.cpu(), cpu)


def _sampler_coords(device, B, P, H, W, seed):
    """Sampler coordinates over the whole texture, a tenth of them on the
    clip bounds and on texel centres."""
    g = torch.Generator(device).manual_seed(seed)
    ix = torch.rand(B, P, device=device, generator=g) * (W - 1)
    iy = torch.rand(B, P, device=device, generator=g) * (H - 1)
    k = P // 40
    ix[:, :k], iy[:, k:2 * k] = 0., float(H - 1)
    ix[:, 2 * k:3 * k] = float(W - 1)
    ix[:, 3 * k:4 * k] = torch.floor(ix[:, 3 * k:4 * k])
    return ix, iy


@pytest.mark.parametrize('shape', [(3, 64, 64), (3, 256, 256), (2, 9, 200)])
@pytest.mark.parametrize('mode', ['bilinear', 'nearest'])
def test_grid_sample_kernels_match_plain(cuda, shape, mode):
    C, H, W = shape
    B, P = 2, 5000
    maps = torch.rand(B, C, H, W, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(2))
    ix, iy = _sampler_coords(cuda, B, P, H, W, 3)
    cot = torch.randn(B, P, C, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(4))
    n, nb = ktex.grid_sample.launches, ktex.grid_sample_backward.launches
    out = ktex.grid_sample(maps, ix, iy, mode)
    assert torch.equal(out, ktex.grid_sample_plain(maps, ix, iy, mode))
    dmaps, dix, diy = ktex.grid_sample_backward(maps, ix, iy, cot, mode)
    again = ktex.grid_sample_backward(maps, ix, iy, cot, mode)
    assert ktex.grid_sample.launches == n + 1
    assert ktex.grid_sample_backward.launches == nb + 2
    rmaps, rix, riy = ktex.grid_sample_backward_plain(maps, ix, iy, cot,
                                                      mode)
    assert torch.equal(dix, again[1]) and torch.equal(diy, again[2])
    assert torch.equal(dix, rix) and torch.equal(diy, riy)
    if mode == 'nearest':
        assert not dix.any() and not diy.any()
    _grad_close(dmaps, rmaps)
    _grad_close(again[0], rmaps)


@pytest.mark.parametrize('shape', [(1, 16, 24), (2, 16, 24), (4, 16, 24),
                                   (5, 16, 24), (3, 1, 24), (3, 16, 1),
                                   (5, 1, 1), (40, 16, 24)])
@pytest.mark.parametrize('mode', ['bilinear', 'nearest'])
def test_grid_sample_forward_channels_and_edges(cuda, shape, mode):
    """The interleaved texture's padding to 4 channels (C = 1 to 5), H or
    W = 1, coordinates on the clip bounds and on texel centres, and C = 40
    (ten 16-byte loads a tap): equal to the plain version, and the same
    bits at every launch."""
    C, H, W = shape
    B, P = 3, 2000
    maps = torch.randn(B, C, H, W, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(5))
    ix, iy = _sampler_coords(cuda, B, P, H, W, 6)
    out = ktex.grid_sample(maps, ix, iy, mode)
    assert torch.equal(out, ktex.grid_sample_plain(maps, ix, iy, mode))
    assert torch.equal(out, ktex.grid_sample(maps, ix, iy, mode))


def test_grid_sample_rejects_bad_input(cuda):
    maps = torch.rand(1, 3, 8, 8, device=cuda)
    ix = torch.zeros(1, 4, device=cuda)
    with pytest.raises(TypeError, match='float32'):
        ktex.grid_sample(maps.double(), ix.double(), ix.double())
    with pytest.raises(ValueError, match='coordinates on cpu'):
        ktex.grid_sample(maps, ix.cpu(), ix.cpu())


def test_textured_step_on_card_matches_cpu(cuda):
    """Config 2's loss at a small size (B=2, 320 faces, 24x40, 16^2
    texture): its gradients to the vertices, the texture and the 6-DoF
    params on the card and with the plain versions on the CPU."""
    scene = kt.utils.interop.textured_scene(2, 2, 16, device=cuda)

    def grads(device):
        s = {k: v.to(device) for k, v in scene.items()}
        params = [s[k].clone().requires_grad_(True)
                  for k in ('vertices', 'texture', 'cam_params')]
        loss = kt.utils.interop.textured_loss(
            *params, s['faces'], s['face_uvs'], s['cam_proj'],
            torch.zeros(2, 24, 40, 3, device=device))
        return loss, torch.autograd.grad(loss, params)

    n = ktex.grid_sample_uv_backward.launches
    (lg, gpu), (lc, cpu) = grads(cuda), grads('cpu')
    assert ktex.grid_sample_uv_backward.launches == n + 1
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-5, atol=0)
    for g, c in zip(gpu, cpu):
        assert torch.isfinite(g).all() and (g != 0).any()
        _grad_close(g.cpu(), c)


def _nan_equal(a, b):
    """``torch.equal`` with NaN equal to NaN, of one shape and dtype."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.isnan(), b.isnan())
            and torch.equal(torch.where(a.isnan(), 0., a),
                            torch.where(b.isnan(), 0., b)))


UV_SHAPES = {'dense': (2, 24, 33, 2), 'raster': (2, 24, 33, 3),
             'sparse': (2, 700, 2), 'transposed': (2, 33, 24, 2),
             'hot': (2, 20000, 2)}


def _uv_case(device, layout, C, H, W, seed):
    """A texture (2, C, H, W), UVs as texture_mapping meets them (a
    contiguous map, the rasterizer's stride-3 view of a (2, h, w, 3) map,
    sparse points, a transposed map whose points do not flatten with one
    stride, 20,000 points nine in ten at UV 0) with 0, 1, values below 0
    and above 1, the UVs of the clip bounds (1/(2W), 1 - 1/(2W), 1/(2H),
    1 - 1/(2H)), NaN and +-inf planted, and a cotangent with NaN and +-inf
    entries. Returns (leaf, uv, maps, cot)."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-0.2, 1.2, UV_SHAPES[layout])
    if layout == 'hot':
        uv[:, rng.random(uv.shape[1]) < 0.9] = 0.
    flat = uv.reshape(-1)
    flat[:24] = [0., 1., 0., 0., 1., 1., -0.3, 1.4, 1. / (2 * W),
                 1. - 1. / (2 * W), 1. / (2 * H), 1. - 1. / (2 * H), np.nan,
                 np.inf, -np.inf, np.nan, 0.5, 1. / (2 * W), 0., 1.,
                 1. / (2 * H), 1. - 1. / (2 * W), -np.inf, 2.]
    leaf = torch.tensor(uv, dtype=torch.float32, device=device,
                        requires_grad=True)
    view = {'raster': lambda t: t[..., :2],
            'transposed': lambda t: t.transpose(1, 2)}.get(layout,
                                                             lambda t: t)
    maps = torch.tensor(rng.random((2, C, H, W)), dtype=torch.float32,
                        device=device, requires_grad=True)
    cot = rng.standard_normal(view(leaf).shape[:-1] + (C,))
    cot.reshape(-1)[[5, 40, 41, 97]] = [np.nan, np.inf, -np.inf, np.nan]
    return leaf, view(leaf), maps, torch.tensor(cot, dtype=torch.float32,
                                                device=device)


@pytest.mark.parametrize('layout', list(UV_SHAPES))
@pytest.mark.parametrize('C', [1, 2, 3, 4, 5])
@pytest.mark.parametrize('mode', ['bilinear', 'nearest'])
def test_uv_route_matches_composition(cuda, layout, C, mode):
    """texture_mapping's UV route (the sampler's kernels in their UV mode)
    against the PyTorch composition it replaces (``grid_sample_coords``
    on ``_uv_coords``): the samples, the texture gradient and the UVs'
    gradient the same bits, NaN where it has NaN; one launch of the UV
    route's forward and backward a call, none of the sampler route's."""
    from kaolin_tpu_torch.render.mesh.utils import _uv_coords
    H, W = 37, 40
    leaf, uv, maps, cot = _uv_case(cuda, layout, C, H, W, 12)
    counters = (ktex.grid_sample_uv, ktex.grid_sample_uv_backward,
                ktex.grid_sample, ktex.grid_sample_backward)
    before = [c.launches for c in counters]
    out = kt.render.mesh.texture_mapping(uv, maps, mode)
    got = torch.autograd.grad(out, (maps, leaf), cot)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [1, 1, 0, 0]
    ref_out = ktex.grid_sample_coords(maps, *_uv_coords(uv, H, W), mode)
    ref = torch.autograd.grad(ref_out, (maps, leaf),
                              cot.reshape(ref_out.shape))
    assert _nan_equal(out, ref_out.reshape(out.shape))
    assert _nan_equal(got[0], ref[0]) and _nan_equal(got[1], ref[1])
    assert got[1].isnan().any() == (mode == 'bilinear')
    if mode == 'nearest':
        assert not got[1].any()
    again = torch.autograd.grad(kt.render.mesh.texture_mapping(uv, maps, mode),
                                (maps, leaf), cot)
    assert all(_nan_equal(a, b) for a, b in zip(got, again))


def test_uv_route_counts_only_cuda_float32(cuda):
    """The UV route's counters move on CUDA float32 alone: on CPU tensors
    texture_mapping runs the composition, and in float64 on the card the
    composition's sampler raises as before."""
    leaf, uv, maps, _ = _uv_case(cuda, 'raster', 3, 16, 16, 13)
    before = (ktex.grid_sample_uv.launches,
              ktex.grid_sample_uv_backward.launches)
    out = kt.render.mesh.texture_mapping(uv.cpu(), maps.cpu(), 'bilinear')
    out.sum().backward()
    with pytest.raises(TypeError, match='float32'):
        kt.render.mesh.texture_mapping(uv.double(), maps.double(),
                                       'bilinear')
    assert before == (ktex.grid_sample_uv.launches,
                      ktex.grid_sample_uv_backward.launches)


def _clouds(device, seed, shape1, shape2):
    g = torch.Generator(device).manual_seed(seed)
    return (torch.rand(shape1, device=device, generator=g),
            torch.rand(shape2, device=device, generator=g))


@pytest.mark.parametrize('n1,n2', [(100, 77), (513, 1025), (3000, 20000)])
def test_nearest_idx_kernels_match_plain(cuda, n1, n2):
    p1, p2 = _clouds(cuda, 5, (2, n1, 3), (2, n2, 3))
    n, npr = kn.nearest_idx.launches, kn.nearest_idx_pruned.launches
    out = kn.nearest_idx(p1, p2)
    pruned = kn.nearest_idx_pruned(p1, p2)
    assert kn.nearest_idx.launches == n + 1
    assert kn.nearest_idx_pruned.launches == npr + 1
    ref = kn.nearest_idx_plain(p1, p2)
    assert torch.equal(out, ref) and torch.equal(pruned, ref)


def test_nearest_idx_kernels_keep_lowest_index_on_ties(cuda):
    """Exact duplicates in the reference cloud, and queries on them."""
    p1, p2 = _clouds(cuda, 6, (1, 2000, 3), (1, 9000, 3))
    p2 = torch.cat([p2, p2.flip(1), p2[:, :500]], dim=1)
    p1 = torch.cat([p1, p2[:, 100:600]], dim=1)
    ref = kn.nearest_idx_plain(p1, p2)
    assert torch.equal(kn.nearest_idx(p1, p2), ref)
    assert torch.equal(kn.nearest_idx_pruned(p1, p2), ref)


def test_nearest_idx_pruned_on_clusters_and_surfaces(cuda):
    """Two far clusters, and points on a sphere against points on an
    ellipsoid: the pruned scan against brute force on every query."""
    g = torch.Generator(cuda).manual_seed(7)
    a = torch.rand(1, 30000, 3, device=cuda, generator=g)
    clusters = torch.cat([a[:, :15000] * 0.1, a[:, 15000:] * 0.1 + 5.], 1)
    s = torch.randn(1, 40000, 3, device=cuda, generator=g)
    sphere = s / s.norm(dim=-1, keepdim=True)
    ellipsoid = sphere[:, :30000] * torch.tensor([1.3, 0.75, 1.], device=cuda)
    for p1, p2 in ((clusters, clusters.flip(1)), (sphere, ellipsoid),
                   (ellipsoid, sphere)):
        assert torch.equal(kn.nearest_idx_pruned(p1, p2),
                           kn.nearest_idx(p1, p2))


def _nn_scene(device, case):
    """(queries, references) of one pruned-scan scene, float32 on
    ``device``."""
    g = torch.Generator(device).manual_seed(17)
    if case == 'ragged':
        # sizes no tile or chunk divides, N1 != N2, B = 2
        return (torch.rand(2, 3001, 3, device=device, generator=g),
                torch.rand(2, 20_011, 3, device=device, generator=g))
    if case == 'lattice_ties':
        # references on a 32^3 lattice, every one twice (the copies at far
        # indices); queries at cell centres, equidistant from 8 corners
        # that lie far apart in Morton order: exact ties across chunks
        # visited out of order
        k = torch.arange(32, device=device, dtype=torch.float32) / 32.
        lat = torch.stack(torch.meshgrid(k, k, k, indexing='ij'), -1)
        lat = lat.reshape(1, -1, 3)[:, torch.randperm(
            32 ** 3, device=device, generator=g)]
        cells = (torch.randint(0, 31, (1, 4000, 3), device=device,
                               generator=g).float() + 0.5) / 32.
        return cells, torch.cat([lat, lat.flip(1)], dim=1)
    if case == 'clusters':
        a = torch.rand(1, 30_000, 3, device=device, generator=g)
        far = torch.cat([a[:, :15_000] * 0.1, a[:, 15_000:] * 0.1 + 5.], 1)
        return far[:, ::3].contiguous(), far.flip(1).contiguous()
    if case == 'zero_span':
        return (torch.full((1, 700, 3), 0.25, device=device),
                torch.full((1, 2500, 3), 0.25, device=device))
    # sphere_centre: queries within 1e-3 of the origin, references on the
    # unit sphere; every distance lies within 0.2% of every other, so the
    # box tests can skip almost nothing
    q = (torch.rand(1, 3000, 3, device=device, generator=g) - 0.5) * 1e-3
    s = torch.randn(1, 20_000, 3, device=device, generator=g)
    return q, s / s.norm(dim=-1, keepdim=True)


@pytest.mark.parametrize('case', ['ragged', 'lattice_ties', 'clusters',
                                  'zero_span', 'sphere_centre'])
def test_nearest_idx_pruned_scenes(cuda, case):
    """The pruned scan equals brute force and the plain version on every
    query, one launch counted per call, two launches bit-identical."""
    p1, p2 = _nn_scene(cuda, case)
    n = kn.nearest_idx_pruned.launches
    out = kn.nearest_idx_pruned(p1, p2)
    again = kn.nearest_idx_pruned(p1, p2)
    assert kn.nearest_idx_pruned.launches == n + 2
    ref = kn.nearest_idx_plain(p1, p2)
    assert torch.equal(out, ref) and torch.equal(again, out)
    assert torch.equal(kn.nearest_idx(p1, p2), ref)
    if case == 'lattice_ties':
        d = kn._sq_dist(p1[0, :, None], p2[0, None])
        assert int((d == d.amin(dim=1, keepdim=True)).sum()) >= 8 * 4000


@pytest.mark.parametrize('case', ['ragged', 'lattice_ties', 'zero_span'])
def test_nearest_idx_prepass_matches_plain(cuda, case):
    """The card's prepass (two kernels, the sort, a third kernel) gives
    the plain prepass's keys, order, records and frame bit for bit, and
    its chunk boxes by value (their keys, in w, bit for bit)."""
    p1, p2 = _nn_scene(cuda, case)
    got = kn.prepass(p1, p2)
    ref = kn._prepass_plain(p1, p2)
    for a, b in zip(got[:4] + got[5:], ref[:4] + ref[5:]):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b)
    assert torch.equal(got[4][..., :3], ref[4][..., :3])
    assert torch.equal(got[4][..., 3].contiguous().view(torch.int32),
                       ref[4][..., 3].contiguous().view(torch.int32))


def test_empty_calls_count_no_launch(cuda):
    """A call that launches nothing counts nothing: the NN kernels on an
    empty cloud, DefTet's selection at knum 0 and on no pixels."""
    p = torch.rand(1, 50, 3, device=cuda)
    empty = torch.zeros(1, 0, 3, device=cuda)
    for fn in (kn.nearest_idx, kn.nearest_idx_pruned):
        n = fn.launches
        for a, b in ((empty, p), (p, empty), (empty, empty)):
            out = fn(a, b)
            assert out.shape == a.shape[:2] and not bool(out.any())
        assert fn.launches == n
    pc, rr, fvz, fvi = kt.utils.interop.deftet_scene(seed=0, side=8,
                                                     num_faces=40,
                                                     device=cuda)[:4]
    valid = torch.ones(fvz.shape[:2], dtype=torch.bool, device=cuda)
    n = kd.deftet_topk.launches
    assert kd.deftet_topk(pc, rr, fvz, fvi, valid, 0, 1e-8).shape == (1, 64,
                                                                      0)
    assert kd.deftet_topk(pc[:, :0], rr[:, :0], fvz, fvi, valid, 5,
                          1e-8).shape == (1, 0, 5)
    assert kd.deftet_topk.launches == n
    kd.deftet_topk(pc, rr, fvz, fvi, valid, 5, 1e-8)
    assert kd.deftet_topk.launches == n + 1


def test_nearest_idx_pruned_skips_chunks(cuda):
    """Config 3's clouds at a small size: the box tests skip most chunks
    and change no result."""
    p1, p2, _ = kt.utils.interop.metrics_scene(18, 20_000, 20_000, 1,
                                               device=cuda)
    scanned = torch.zeros(1, dtype=torch.int64, device=cuda)
    out = kn.scan_cuda(p1, p2, scanned=scanned)
    assert torch.equal(out, kn.nearest_idx_plain(p1, p2))
    assert 0 < int(scanned) * kn.TQ * kn.CH < 20_000 ** 2 // 5


def _brute_scene(device, case):
    """(queries, references) of one brute-force scene, float32 on
    ``device``: lattice points (exact distances, exact ties) with NaN
    coordinates where the case names them."""
    g = torch.Generator(device).manual_seed(19)

    def grid(*shape):
        return torch.randint(0, 64, shape, device=device, generator=g,
                             dtype=torch.int32).float() / 64.
    if case == 'probe':
        # the CPU probe of the NaN-chunk fault: 50 queries, 3,000
        # references, a NaN coordinate at reference 1,500
        p1, p2 = grid(1, 50, 3), grid(1, 3000, 3)
        p2[0, 1500, 1] = float('nan')
    elif case == 'nan_last_partial':
        p1, p2 = grid(2, 700, 3), grid(2, 2600, 3)
        p2[1, 2599, 0] = float('nan')
        p2[0, 100, 2] = float('nan')
    elif case == 'nonfinite':
        p1, p2 = grid(1, 600, 3), grid(1, 5000, 3)
        p1[0, :3, 0] = torch.tensor([float('nan'), float('inf'),
                                     float('-inf')])
        p2[0, 10:20, 1] = float('inf')
        p2[0, 3000:3010, 2] = float('-inf')
        p2[0, 4100, 0] = float('nan')
    else:
        # border ties: the same point at every slice border of 32, 256 and
        # 1024 references below 4,100, and queries on it and a step off it
        p1, p2 = grid(1, 1500, 3), grid(1, 4100, 3)
        borders = torch.arange(32, 4100, 32, device=device)
        point = p2[0, 31].clone()
        p2[0, borders] = point
        p2[0, borders - 1] = point
        p1[0, :500] = point
        p1[0, 500:1000] = point + torch.tensor([1. / 64, 0., 0.],
                                               device=device)
    return p1, p2


@pytest.mark.parametrize('case', ['probe', 'nan_last_partial', 'nonfinite',
                                  'border_ties'])
@pytest.mark.parametrize('plan', ['host', 1, 32, 256, 1024, 2048])
def test_nearest_idx_brute_plans(cuda, case, plan, monkeypatch):
    """The brute-force kernel under the host's plan and with each kind of
    slice forced (one slice, slices below a chunk, of a chunk and of two):
    the plain version's indices, NaN chunks passed over and ties to the
    lowest index across slice borders, one launch counted a call, two
    launches bit-identical."""
    p1, p2 = _brute_scene(cuda, case)
    N2 = p2.shape[1]
    if plan != 'host':
        L = -(-N2 // 1024) * 1024 if plan == 1 else plan
        monkeypatch.setattr(kn, 'brute_plan',
                            lambda *a: (-(-N2 // L), L))
    ref = kn.nearest_idx_plain(p1, p2)
    n = kn.nearest_idx.launches
    out = kn.nearest_idx(p1, p2)
    again = kn.nearest_idx(p1, p2)
    assert kn.nearest_idx.launches == n + 2
    assert torch.equal(out, ref) and torch.equal(again, out)
    if case == 'probe':
        assert not bool(((out >= 1024) & (out < 2048)).any())
    if case == 'border_ties':
        assert bool((out[0, :500] == 31).all())


@pytest.mark.parametrize('case', ['probe', 'nan_last_partial', 'nonfinite'])
def test_nearest_idx_pruned_nan_chunks(cuda, case):
    """The pruned scan passes over the references of a chunk of 1024 that
    holds a NaN coordinate, as its plain version does; its prepass on the
    card gives the plain prepass's keys, order, records and frame bit for
    bit and its chunk boxes by value (NaN where a box holds only NaN)."""
    p1, p2 = _brute_scene(cuda, case)
    n = kn.nearest_idx_pruned.launches
    out = kn.nearest_idx_pruned(p1, p2)
    again = kn.nearest_idx_pruned(p1, p2)
    assert kn.nearest_idx_pruned.launches == n + 2
    assert torch.equal(out, kn.nearest_idx_plain(p1, p2))
    assert torch.equal(again, out)
    got, ref = kn.prepass(p1, p2), kn._prepass_plain(p1, p2)
    for a, b in zip(got[:4] + got[5:], ref[:4] + ref[5:]):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b)
    box, rbox = got[4][..., :3], ref[4][..., :3]
    assert torch.equal(box.isnan(), rbox.isnan())
    assert torch.equal(box.nan_to_num(0.), rbox.nan_to_num(0.))


@pytest.mark.parametrize('shape', [(1, 10_000, 10_000), (1, 2048, 2048),
                                   (2, 3001, 20_011), 'fill'])
def test_nearest_idx_brute_sizes(cuda, shape):
    """The brute-force kernel at the slice's sizes and at one the query
    tiles fill alone (one slice): the plain version's indices, no host
    sync, one launch counted a call."""
    sms = kn._sms(torch.cuda.current_device())
    if shape == 'fill':
        shape = (1, 2 * sms * kn.QB, 1500)
    B, N1, N2 = shape
    p1, p2 = _clouds(cuda, 23, (B, N1, 3), (B, N2, 3))
    S, _ = kn.brute_plan(B, N1, N2, sms)
    assert (S == 1) == (N2 == 1500)
    out = kn.nearest_idx(p1, p2)
    assert torch.equal(out, kn.nearest_idx_plain(p1, p2))
    n = kn.nearest_idx.launches
    assert _sync_count(lambda: kn.nearest_idx(p1, p2)) == 0
    assert kn.nearest_idx.launches == n + 1


def _grid_mesh_points(device):
    """The grid mesh of ``tests/test_metrics.py`` with points above its
    vertices and edge midpoints (exact ties, summed codes above 6)."""
    g = np.mgrid[0:5, 0:5].reshape(2, -1).T.astype(np.float32)
    verts = np.concatenate([g, np.zeros((25, 1), np.float32)], 1)
    quads = np.array([[i * 5 + j, i * 5 + j + 1, (i + 1) * 5 + j,
                       (i + 1) * 5 + j + 1]
                      for i in range(4) for j in range(4)])
    faces = np.concatenate([quads[:, [0, 1, 2]], quads[:, [1, 3, 2]]])
    mid = verts[:-1] * 0.5 + verts[1:] * 0.5 + [0, 0, 2]
    pts = np.concatenate([verts + [0, 0, 1], mid]).astype(np.float32)
    return (torch.tensor(pts[None], device=device),
            torch.tensor(verts[faces][None], device=device))


@pytest.mark.parametrize('case', ['random', 'grid', 'degenerate'])
def test_p2m_select_kernel_matches_plain(cuda, case):
    if case == 'grid':
        pts, fv = _grid_mesh_points(cuda)
    else:
        pts, fv = _clouds(cuda, 8, (2, 3000, 3), (2, 700, 3, 3))
        if case == 'degenerate':
            fv[0, 5] = fv[0, 5, :1]                 # a point
            fv[1, 9, 2] = fv[1, 9, 0] * 0.5 + fv[1, 9, 1] * 0.5  # a segment
    n = kp.p2m_select.launches
    idx, types = kp.p2m_select(pts, fv)
    assert kp.p2m_select.launches == n + 1
    ridx, rtypes = kp.p2m_select_plain(pts, fv)
    assert torch.equal(idx, ridx) and torch.equal(types, rtypes)
    if case == 'grid':
        assert int(types.max()) > 6


def _p2m_case(device, case):
    if case == 'ragged':        # N, F multiples of no tile, chunk or split
        return _clouds(device, 9, (2, 1001, 3), (2, 203, 3, 3))
    if case == 'one_face':
        return _clouds(device, 10, (2, 777, 3), (2, 1, 3, 3))
    if case == 'batch':         # a different mesh in each batch entry
        return _clouds(device, 11, (3, 1500, 3), (3, 333, 3, 3))
    if case == 'doubled':       # every distance ties; the lower id wins
        pts, fv = _clouds(device, 12, (1, 2000, 3), (1, 300, 3, 3))
        return pts, torch.cat([fv, fv], dim=1)
    if case == 'grid':
        return _grid_mesh_points(device)
    if case == 'all_degenerate':    # every distance inf: face 0, type 0
        pts, fv = _clouds(device, 13, (2, 900, 3), (2, 150, 3, 3))
        return pts, fv[:, :, :1].expand(-1, -1, 3, -1).contiguous()
    if case == 'degenerate':
        pts, fv = _clouds(device, 8, (2, 3000, 3), (2, 700, 3, 3))
        fv[0, 5] = fv[0, 5, :1]                 # a point
        fv[1, 9, 2] = fv[1, 9, 0] * 0.5 + fv[1, 9, 1] * 0.5  # a segment
        return pts, fv
    # points 0-2 ulps off the faces' planes, on both sides: the cull's
    # margin
    return kt.utils.interop.near_plane_scene(14, 4000, 500, device=device)


P2M_CASES = ['ragged', 'one_face', 'batch', 'doubled', 'grid',
             'all_degenerate', 'degenerate', 'near_plane']


@pytest.mark.parametrize('case', P2M_CASES)
def test_p2m_select_scenes_match_plain(cuda, case):
    """The scan's edge cases give the plain version's faces and types, and
    the same bits at every launch."""
    pts, fv = _p2m_case(cuda, case)
    ridx, rtypes = kp.p2m_select_plain(pts, fv)
    if case == 'all_degenerate':
        assert not ridx.any() and not rtypes.any()
    idx, types = kp.p2m_select(pts, fv)
    again = kp.p2m_select(pts, fv)
    assert torch.equal(idx, ridx) and torch.equal(types, rtypes)
    assert torch.equal(idx, again[0]) and torch.equal(types, again[1])


def test_p2m_select_cull_skips_pairs(cuda):
    """Config 3's scene at a small size: the cull skips most pairs and
    changes no result."""
    p1, _, fv = kt.utils.interop.metrics_scene(15, 5000, 10, 2000,
                                               device=cuda)
    scored = torch.zeros(1, dtype=torch.int64, device=cuda)
    out = kp.select_cuda(p1, fv, scored=scored)
    assert all(torch.equal(a, b) for a, b in
               zip(out, kp.p2m_select_plain(p1, fv)))
    assert 0 < int(scored) < 5000 * 2000 // 5


def test_p2m_select_many_point_tiles(cuda):
    """More than 65,535 tiles of points (256 a tile): the scan's grid is
    1-D, so a cloud of any size launches."""
    n = 65_536 * 256 + 1
    gen = torch.Generator(cuda).manual_seed(16)
    pts = torch.rand(1, n, 3, device=cuda, generator=gen)
    fv = torch.rand(1, 3, 3, 3, device=cuda, generator=gen)
    idx, types = kp.p2m_select(pts, fv)
    ridx, rtypes = kp.p2m_select_plain(pts, fv)
    assert torch.equal(idx, ridx) and torch.equal(types, rtypes)


def test_config3_fit_loss_on_card_matches_cpu(cuda):
    """Config 3's mesh-fit loss (icosphere subdivision 2, 2,000 target
    points, 1,500 samples from fixed uniforms) and its gradient to the
    vertices, on the card and with the plain versions on the CPU. The
    selections agree exactly; the gradient's gathers add with atomics on
    the card, in another order than the CPU's."""
    verts, faces = kt.utils.interop.icosphere(2)
    rng = np.random.default_rng(13)
    s = rng.standard_normal((1, 2000, 3))
    target = (s / np.linalg.norm(s, axis=-1, keepdims=True)
              * [1.3, 0.75, 1.]).astype(np.float32)
    uniforms = [rng.random(shape).astype(np.float32)
                for shape in ((1, 1500), (1, 1500, 1), (1, 1500, 1))]

    def loss_and_grad(device):
        v, f = kt.utils.interop.mesh_from_numpy(verts[None] * 0.9, faces,
                                                device=device)
        v.requires_grad_(True)
        loss = kt.utils.interop.mesh_fit_loss(
            v, f, torch.tensor(target, device=device), 1500, 0.1,
            uniforms=[torch.tensor(u, device=device) for u in uniforms])
        return loss, torch.autograd.grad(loss, [v])[0]

    n = kn.nearest_idx.launches, kp.p2m_select.launches
    (lg, gg), (lc, gc) = loss_and_grad(cuda), loss_and_grad('cpu')
    assert (kn.nearest_idx.launches, kp.p2m_select.launches) == (
        n[0] + 2, n[1] + 1)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-5, atol=0)
    assert torch.isfinite(gg).all() and (gg != 0).any()
    _grad_close(gg.cpu(), gc)


def _deftet_case(device, case):
    """(pixel coords, ranges, z, image coords, valid mask, knum) of one
    selection case, float32 on ``device``."""
    pc, rr, fvz, fvi, _ = kt.utils.interop.deftet_scene(
        seed=3, side=40, num_faces=1500, device=device)
    valid = torch.ones(fvz.shape[:2], dtype=torch.bool, device=device)
    knum = 30
    if case == 'knum300':
        knum = 300
    elif case == 'ties':
        fvz = torch.cat([fvz, fvz.flip(1)], dim=1)
        fvi = torch.cat([fvi, fvi.flip(1)], dim=1)
        valid = torch.ones(fvz.shape[:2], dtype=torch.bool, device=device)
        knum = 7
    elif case == 'valid':
        g = torch.Generator(device).manual_seed(4)
        valid = torch.rand(fvz.shape[:2], device=device, generator=g) > 0.4
    elif case == 'few_faces':
        fvz, fvi, valid = fvz[:, :20], fvi[:, :20], valid[:, :20]
    elif case == 'signed_zero':
        rr = torch.tensor([-1., 1.], device=device).expand_as(pc)
        fvi = torch.tensor([[-3., -3.], [3., -3.], [0., 3.]],
                           device=device).expand(1, 6, 3, 2)
        fvz = torch.tensor([-0., 0., -0., 0., -0.5, 0.5],
                           device=device)[None, :, None].expand(1, 6, 3)
        valid = torch.ones((1, 6), dtype=torch.bool, device=device)
        knum = 5
    return pc, rr, fvz.contiguous(), fvi.contiguous(), valid, knum


@pytest.mark.parametrize('case', ['random', 'knum300', 'ties', 'valid',
                                  'few_faces', 'signed_zero'])
def test_deftet_topk_kernel_matches_plain(cuda, case):
    pc, rr, fvz, fvi, valid, knum = _deftet_case(cuda, case)
    n = kd.deftet_topk.launches
    out = kd.deftet_topk(pc, rr, fvz, fvi, valid, knum, 1e-8)
    assert kd.deftet_topk.launches == n + 1
    ref = kd.deftet_topk_plain(pc, rr, fvz, fvi, valid, knum, 1e-8)
    assert torch.equal(out, ref)
    assert int((out >= 0).sum()) > 0
    if case == 'signed_zero':
        assert (out.cpu() == torch.tensor([5, 1, 3, 0, 2],
                                          dtype=torch.int32)).all()


def _deftet_split_case(device, case):
    """(pixel coords, ranges, z, image coords, valid mask, knum) of one
    split-and-merge scene, float32 on ``device``."""
    if case == 'full_cover':
        # every face covers the whole image, its depth rising with its id:
        # every pair passes, and every face enters its list at the top
        pc, rr = kt.utils.interop.deftet_scene(seed=0, side=40, num_faces=1,
                                               device=device)[:2]
        F = 1531
        fvi = torch.tensor([[-3., -3.], [3., -3.], [0., 3.]],
                           device=device).expand(1, F, 3, 2).contiguous()
        z = -1. + torch.arange(F, device=device, dtype=torch.float32) / F
        fvz = z[None, :, None].expand(1, F, 3).contiguous()
        return (pc, rr, fvz, fvi, torch.ones((1, F), dtype=torch.bool,
                                             device=device), 30)
    if case == 'signed_zero':
        return _deftet_case(device, 'signed_zero')
    if case == 'batch2':
        # B = 2, P not a multiple of 32, invalid faces
        scenes = [kt.utils.interop.deftet_scene(seed=s, side=37,
                                                num_faces=1531,
                                                device=device)
                  for s in (8, 9)]
        pc, rr, fvz, fvi = (torch.cat([sc[i] for sc in scenes])
                            for i in range(4))
        g = torch.Generator(device).manual_seed(10)
        valid = torch.rand(fvz.shape[:2], device=device, generator=g) > 0.3
        return pc, rr, fvz, fvi, valid, 30
    pc, rr, fvz, fvi, _ = kt.utils.interop.deftet_scene(
        seed=11, side=40, num_faces=1531, device=device)
    valid = torch.ones(fvz.shape[:2], dtype=torch.bool, device=device)
    if case == 'doubled':
        fvz = torch.cat([fvz, fvz.flip(1)], dim=1)
        fvi = torch.cat([fvi, fvi.flip(1)], dim=1)
        valid = torch.cat([valid, valid], dim=1)
        return pc, rr, fvz, fvi, valid, 30
    knum = int(case[4:])            # 'knum<k>'
    return pc, rr, fvz, fvi, valid, knum


@pytest.mark.parametrize('case', ['knum1', 'knum30', 'knum64', 'knum300',
                                  'knum2000', 'doubled', 'signed_zero',
                                  'batch2', 'full_cover'])
def test_deftet_topk_split_scenes(cuda, case):
    """The split-and-merge kernels against the plain version, two launches
    bit-identical: ``knum`` 1, 30, 64 (the largest list in shared memory),
    300 (lists in device memory) and 2000 > F, 1,531 faces (no range count
    or stage divides them), every face doubled (ties across ranges), +0.0
    and -0.0 depths, batch 2 with 1,369 pixels and invalid faces, and a
    full-cover scene."""
    pc, rr, fvz, fvi, valid, knum = _deftet_split_case(cuda, case)
    out = kd.deftet_topk(pc, rr, fvz, fvi, valid, knum, 1e-8)
    again = kd.deftet_topk(pc, rr, fvz, fvi, valid, knum, 1e-8)
    ref = kd.deftet_topk_plain(pc, rr, fvz, fvi, valid, knum, 1e-8)
    assert torch.equal(out, ref) and torch.equal(again, out)
    assert int((out >= 0).sum()) > 0
    if case == 'full_cover':
        F = fvz.shape[1]
        top = torch.arange(F - 1, F - 31, -1, device=cuda, dtype=torch.int32)
        assert bool((out == top).all())
    if case == 'signed_zero':
        assert (out.cpu() == torch.tensor([5, 1, 3, 0, 2],
                                          dtype=torch.int32)).all()


def test_deftet_step_on_card_matches_cpu(cuda):
    """Config 4's loss and its gradients to the image coords and the
    features (24x24 pixels, 600 faces): the selections agree exactly; the
    gathers' backward adds with atomics on the card."""
    def loss_and_grads(device):
        pc, rr, fvz, fvi, ff = kt.utils.interop.deftet_scene(
            seed=5, side=24, num_faces=600, device=device)
        fvi.requires_grad_(True)
        ff.requires_grad_(True)
        loss = kt.utils.interop.deftet_loss(pc, rr, fvz, fvi, ff)
        return (loss,) + torch.autograd.grad(loss, [fvi, ff])

    n = kd.deftet_topk.launches
    card, cpu = loss_and_grads(cuda), loss_and_grads('cpu')
    assert kd.deftet_topk.launches == n + 1
    torch.testing.assert_close(card[0].cpu(), cpu[0], rtol=1e-5, atol=0)
    for g, ref in zip(card[1:], cpu[1:]):
        assert torch.isfinite(g).all()
        _grad_close(g.cpu(), ref)


def _shell_spc(device, level=6):
    return kt.utils.interop.sphere_shell_spc(level=level, n=30000,
                                             device=device)


def _rays(device, kind, n=4096, seed=6):
    """Rays: 'random' from around the unit cube toward its middle;
    'axis': along +-x/y/z with 0.0 and -0.0 components from dyadic
    origins, some on cell planes; 'lattice': general directions from
    origins on the level-6 cell planes (every coordinate a multiple of
    2^-5), so rays start on and cross planes and edges."""
    rng = np.random.default_rng(seed)
    if kind == 'random':
        o = rng.uniform(-1.5, 1.5, (n, 3))
        d = rng.uniform(-0.5, 0.5, (n, 3)) - o
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
    elif kind == 'axis':
        axis = rng.integers(0, 3, n)
        sign = rng.choice([-1., 1.], n)
        d = np.where(rng.random((n, 3)) < 0.5, 0., -0.)
        d[np.arange(n), axis] = sign
        o = np.round(rng.uniform(-1, 1, (n, 3)) * 32.) / 32.
        o[np.arange(n), axis] = -1.5 * sign
    else:
        o = np.round(rng.uniform(-1, 1, (n, 3)) * 32.) / 32.
        d = rng.normal(size=(n, 3))
        d[: n // 2, 0] = 0.
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.tensor(o, dtype=torch.float32, device=device),
            torch.tensor(d, dtype=torch.float32, device=device))


@pytest.mark.parametrize('level', [0, 1, 3, 6])
@pytest.mark.parametrize('with_exit', [False, True])
@pytest.mark.parametrize('kind', ['random', 'axis', 'lattice'])
def test_spc_traverse_kernel_matches_plain(cuda, level, with_exit, kind):
    octree, ph, _, exsum = _shell_spc(cuda)
    o, d = _rays(cuda, kind)
    n = kst.traverse.launches
    out = kst.traverse(octree, exsum, ph, o, d, level, with_exit)
    assert kst.traverse.launches == n + 1
    ref = kst.traverse_plain(octree, exsum, ph, o, d, level, with_exit)
    for a, b in zip(out[:3], ref[:3]):
        assert torch.equal(a, b)
    assert out[3] == ref[3] and out[4] == ref[4]
    # lattice rays start inside the root cell, which level 0 does not count
    assert (out[3] > 0) == (level > 0 or kind != 'lattice')


def test_spc_traverse_cap_and_empty(cuda):
    """A cap below the count (the prefix, -1 and 0 after it, the true
    count), and rays that miss the octree (no nugget after level 0)."""
    octree, ph, _, exsum = _shell_spc(cuda)
    o, d = _rays(cuda, 'random')
    full = kst.traverse(octree, exsum, ph, o, d, 6, True)
    cap = full[3] // 2
    out = kst.traverse(octree, exsum, ph, o, d, 6, True, cap=cap)
    assert out[3] == full[3] and out[0].shape[0] == cap
    for a, b in zip(out[:3], full[:3]):
        assert torch.equal(a, b[:cap])
    big = kst.traverse(octree, exsum, ph, o, d, 6, True, cap=full[3] + 50)
    assert (big[0][full[3]:] == -1).all() and (big[2][full[3]:] == 0).all()
    away = torch.ones_like(d)
    miss = kst.traverse(octree, exsum, ph, o.abs() + 2., away, 6)
    assert miss[3] == 0 and miss[0].shape[0] == 0 and miss[4] == [0] * 6


def test_spc_traverse_rejects_bad_input(cuda):
    octree, ph, _, exsum = _shell_spc(cuda, level=3)
    o, d = _rays(cuda, 'random', n=64)
    with pytest.raises(TypeError):
        kst.traverse(octree, exsum, ph, o.double(), d.double(), 3)
    with pytest.raises(TypeError):
        kst.traverse(octree, exsum.long(), ph, o, d, 3)
    with pytest.raises(ValueError):
        kst.traverse(octree.cpu(), exsum, ph, o, d, 3)


def test_raytrace_on_card_matches_cpu(cuda):
    """``unbatched_raytrace`` of config 5's camera at 64x64 on a level-6
    shell, on the card and on the CPU from the same rays (made on the CPU:
    the card's ``tan`` may round the camera's constant otherwise, and this
    on-axis grid has rays on cell edges), and the pack ops over its
    hits."""
    spc_c, spc_g = _shell_spc('cpu'), _shell_spc(cuda)
    cam = ([0., 0., 2.5], [0., 0., 0.], [0., 1., 0.], np.pi / 3)
    rays = kt.render.spc.generate_primary_rays(64, 64, *cam, device='cpu')
    out = {}
    for dev, (octree, ph, pyr, exsum) in (('cpu', spc_c), (cuda, spc_g)):
        o, d = (r.to(dev) for r in rays)
        ridx, pidx, depth = kt.render.spc.unbatched_raytrace(
            octree, ph, pyr, exsum, o, d, 6, with_exit=True)
        b = kt.render.spc.mark_pack_boundaries(ridx)
        tau = depth[:, 1:] - depth[:, :1]
        feats, trans = kt.render.spc.exponential_integration(
            torch.ones_like(tau), tau, b)
        out[str(dev)] = (ridx, pidx, depth, b, feats, trans)
    for a, b in zip(out['cuda'][:4], out['cpu'][:4]):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(out['cuda'][4:], out['cpu'][4:]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)


def _backward_case(device, C, H, W, B, P, kind, seed):
    """Sampler inputs of the backward's binning tests: random coordinates
    with a third of the cotangents zero ('random'), every point at texel 0
    ('hot'), or coordinates on the tile edges ('edges')."""
    g = torch.Generator('cpu').manual_seed(seed)
    maps = torch.rand(B, C, H, W, generator=g)
    ix = torch.rand(B, P, generator=g) * (W - 1)
    iy = torch.rand(B, P, generator=g) * (H - 1)
    cot = torch.randn(B, P, C, generator=g)
    if kind == 'hot':
        ix.zero_()
        iy.zero_()
    elif kind == 'edges':
        ix = (torch.randint(0, max(W // 32, 1) + 1, (B, P), generator=g)
              * 32. - 1. + torch.rand(B, P, generator=g)).clamp(0, W - 1)
        iy = (torch.randint(0, max(H // 32, 1) + 1, (B, P), generator=g)
              * 32. - 1. + torch.rand(B, P, generator=g)).clamp(0, H - 1)
    else:
        cot[:, ::3] = 0.
    return [t.to(device) for t in (maps, ix, iy, cot)]


@pytest.mark.parametrize('case', [
    (3, 64, 64, 2, 700, 'random'), (3, 5, 7, 2, 300, 'random'),
    (1, 1, 1, 2, 200, 'random'), (5, 70, 45, 2, 600, 'edges'),
    (3, 64, 64, 2, 400, 'hot'), (2, 40, 33, 1, 20000, 'hot')])
@pytest.mark.parametrize('mode', ['bilinear', 'nearest'])
def test_grid_sample_backward_lists_and_order(cuda, case, mode):
    """The backward's lists equal ``tile_lists_plain``'s and its texture
    gradient ``texture_grad_tiled_plain``'s bits (20,000 points on one
    texel: two chunks of a tile's list, added in chunk order), the same
    bits at every launch and with the forward's interleaved copy; dix and
    diy the plain version's."""
    C, H, W, B, P, kind = case
    maps, ix, iy, cot = _backward_case(cuda, C, H, W, B, P, kind, 11)
    dmaps, dix, diy, (lst, starts, counts) = ktex._backward(
        maps, ix, iy, cot, mode, lists=True)
    ref = ktex.tile_lists_plain(ix.cpu(), iy.cpu(), cot.cpu(), H, W, mode)
    for got, want in zip((lst, starts, counts), ref):
        assert torch.equal(got.cpu().long(), want)
    model = ktex.texture_grad_tiled_plain(ix.cpu(), iy.cpu(), cot.cpu(), H,
                                          W, mode)
    assert torch.equal(dmaps.cpu().view(torch.int32),
                       model.view(torch.int32))
    inter = ktex._grid_sample(maps, ix, iy, mode)[1]
    again = ktex.grid_sample_backward(maps, ix, iy, cot, mode, inter)
    assert torch.equal(dmaps.view(torch.int32), again[0].view(torch.int32))
    _, rix, riy = ktex.grid_sample_backward_plain(maps, ix, iy, cot, mode)
    assert torch.equal(dix, rix) and torch.equal(diy, riy)
    assert torch.equal(dix, again[1]) and torch.equal(diy, again[2])
    assert ktex._backward_layout(B, C, H, W, P, mode == 'nearest',
                                 False)[5] == ktex.partial_slots(
                                     B, P, H, W, mode)


def test_grid_sample_backward_no_points(cuda):
    """No points: a zero texture gradient, written by the kernels."""
    maps = torch.rand(2, 3, 40, 50, device=cuda)
    empty = torch.zeros(2, 0, device=cuda)
    dmaps, dix, diy = ktex.grid_sample_backward(
        maps, empty, empty, torch.zeros(2, 0, 3, device=cuda))
    assert dmaps.shape == maps.shape and not dmaps.any()
    assert dix.shape == (2, 0) and diy.shape == (2, 0)


@pytest.mark.parametrize('C', [3, 0])
@pytest.mark.parametrize('mode', ['bilinear', 'nearest'])
def test_grid_sample_backward_zero_cotangent(cuda, mode, C):
    """No live point (a zero cotangent, or no channel) while the layout
    has slots of partial tiles (B * P >= 512), on a scratch that the
    caching allocator hands back holding 0x7f bytes (as an int, an index
    far past every buffer): a zero texture gradient, dix and diy the plain
    version's, and no fault."""
    B, P, H, W = 2, 4096, 70, 45
    g = torch.Generator('cpu').manual_seed(5)
    maps = torch.rand(B, C, H, W, generator=g).to(cuda)
    ix = (torch.rand(B, P, generator=g) * (W - 1)).to(cuda)
    iy = (torch.rand(B, P, generator=g) * (H - 1)).to(cuda)
    cot = torch.zeros(B, P, C, device=cuda)
    layout = ktex._backward_layout(B, C, H, W, P, mode == 'nearest', False)
    assert layout[5] == ktex.partial_slots(B, P, H, W, mode) > 0
    for _ in range(2):
        junk = torch.full((layout[0],), 0x7f, dtype=torch.uint8, device=cuda)
        del junk
        dmaps, dix, diy = ktex.grid_sample_backward(maps, ix, iy, cot, mode)
        torch.cuda.synchronize()
        _, rix, riy = ktex.grid_sample_backward_plain(maps, ix, iy, cot,
                                                      mode)
        assert dmaps.shape == maps.shape and not dmaps.any()
        assert torch.equal(dix, rix) and torch.equal(diy, riy)


def _sync_count(fn):
    """The synchronizing operations of a call of ``fn`` that
    ``set_sync_debug_mode`` reports."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    return sum('called a synchronizing' in str(w.message) for w in caught)


@pytest.mark.parametrize('level', [0, 1, 4, 6])
def test_spc_traverse_budget_and_syncs(cuda, level, monkeypatch):
    """A budget below the levels' totals: the trace is sized exactly and
    run again (``traverse.resized``), with the plain version's outputs,
    with and without a cap; with the default budget a trace reads the host
    once."""
    octree, ph, _, exsum = kt.utils.interop.sphere_shell_spc(
        level=6, n=20000, seed=3, radius=0.6, device=cuda)
    o, d = kt.render.spc.generate_primary_rays(
        48, 48, (0.3, 0.2, 2.5), (0., 0., 0.), (0., 1., 0.), 0.9,
        device=cuda)
    for cap in (None, 100, 100000):
        ref = kst.traverse_plain(octree, exsum, ph, o, d, level, True, cap)
        n = kst.traverse.resized
        with monkeypatch.context() as m:
            m.setattr(kst, 'BUDGET_PER_RAY', 0)
            m.setattr(kst, 'BUDGET_MIN', 64)
            out = kst.traverse(octree, exsum, ph, o, d, level, True, cap)
        over = any(c > 64 for c in ref[4][:-1]) or (
            cap is None and ref[4][-1] > 64)
        assert kst.traverse.resized == n + int(over)
        for a, b in zip(out[:3], ref[:3]):
            assert torch.equal(a, b)
        assert out[3:] == ref[3:]
    assert _sync_count(lambda: kst.traverse(octree, exsum, ph, o, d,
                                            level)) == 1


def test_usd_cuda_round_trip(cuda, tmp_path):
    """USD files written from CUDA tensors that require grad, in ``.usda``
    and ``.usdc``, read back onto the card bit-equal, in float32, int64
    and bool."""
    usd = kt.io.usd
    rng = np.random.default_rng(14)
    v = torch.tensor(rng.standard_normal((40, 3)), dtype=torch.float32,
                     device=cuda, requires_grad=True)
    f = torch.tensor(rng.integers(0, 40, (70, 3)), device=cuda)
    grid = torch.tensor(rng.random((9, 9, 9)) > 0.6, device=cuda)
    for ext in ('usda', 'usdc'):
        path = str(tmp_path / f'c.{ext}')
        usd.export_mesh(path, vertices=v, faces=f, time=1)
        usd.export_pointcloud(path, v * 2, colors=v.abs())
        usd.export_voxelgrid(path, grid)
        mesh = usd.import_mesh(path, time=1)
        cloud = usd.import_pointcloud(path)
        back = usd.import_voxelgrid(path)
        for got, ref in ((mesh.vertices, v), (mesh.faces, f),
                         (cloud.points, v * 2), (cloud.colors, v.abs()),
                         (back, grid)):
            assert got.device.type == 'cuda' and got.dtype == ref.dtype
            assert torch.equal(got, ref.detach())
