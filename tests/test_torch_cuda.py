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
gradients agree exactly; the texture gradient sums with atomics in no fixed
order and agrees entry by entry as the other gradients do. The DefTet
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

    n = ktex.grid_sample_backward.launches
    (lg, gpu), (lc, cpu) = grads(cuda), grads('cpu')
    assert ktex.grid_sample_backward.launches == n + 1
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-5, atol=0)
    for g, c in zip(gpu, cpu):
        assert torch.isfinite(g).all() and (g != 0).any()
        _grad_close(g.cpu(), c)


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
