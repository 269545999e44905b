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
order and agrees entry by entry as the other gradients do.
"""

import numpy as np
import pytest
import torch

import kaolin_tpu_torch as kt
from kaolin_tpu_torch.kernels import rasterize as kr
from kaolin_tpu_torch.kernels import rasterize_bwd as krb
from kaolin_tpu_torch.kernels import soft_mask as ks
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
