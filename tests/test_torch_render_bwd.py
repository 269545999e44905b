"""The render backwards' decomposition on the card, written out in PyTorch.

``csrc/soft_mask.cu`` and ``csrc/rasterize_bwd.cu`` run only on a CUDA
card. What they do to find and order their work is written out here, on
the CPU, and held against the plain versions (``soft_mask_backward_plain``,
``rasterize_backward_plain``) and, through the same inputs, against
``kaolin_tpu``'s gradients (``jax.grad`` of its XLA path), as
``tests/test_torch_grad.py`` does for the plain versions:

- the soft mask: the live bitmap (a bit a pixel, 32 a word along the row:
  uncovered and a nonzero cotangent), each face's pixel rectangle (its
  enlarged bbox's, padded by one, clipped to the slab, trimmed by the
  float bbox test) in row segments of 32 columns, the candidates (the live pixels of the segments, in segment
  and bit order), the recorded pairs among them (inside the float bbox, at
  or under the cut), and a face of more than ``BIG_SEGS`` segments split
  over the block's warps step by step, their sums added in warp order;
- the rasterize backward: the faces the forward culled skipped, each
  other face's pixel rectangle walked row-major, the pixels it owns
  listed in that order and taken 32 at a time, the
  channels split into walks of 64 and over the lanes (``DL`` lanes a
  pixel group), and a face of more than ``BIG_PIX`` pixels split over the
  warps batch by batch.

The pair and pixel sets the walks find must be exactly those the plain
versions sum; the gradients agree with the plain versions and with
``kaolin_tpu`` at the float32 tolerance of ``tests/test_torch_grad.py``.
The card's own kernels are held against the plain versions in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import kaolin_tpu as kal
import kaolin_tpu_torch as kt
from kaolin_tpu_torch.kernels import rasterize_bwd as krb
from kaolin_tpu_torch.kernels import soft_mask as ks
from kaolin_tpu_torch.kernels.rasterize import _pixel_coords
from kaolin_tpu_torch.render.mesh.dibr import _scaled_inputs

TOL = 1e-4                 # float32, relative to the largest entry
WARPS = 8                  # faces per block, both kernels
BIG_SEGS = 4 * 32          # csrc/soft_mask.cu
AHEAD, DC = 2, 64          # csrc/rasterize_bwd.cu
BIG_PIX = 32 * AHEAD * WARPS
SM = dict(sigmainv=7000., multiplier=1000.)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread: under the suite's six workers the default
    threads contend for the cores (one case of this file's took 10-20x its
    time alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(ref, out):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    scale = float(np.abs(ref).max())
    assert scale > 0, 'degenerate test: zero gradient'
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL * scale)


def _f32(x):
    return torch.tensor(np.float32(x))


def _span(v0, v1, n, scale=None):
    """The kernels' ``centre_span`` and clamps, in float32: indices whose
    centre can lie in [v0, v1), padded by one, unclipped then clamped to
    [0, n] and [-1, n - 1]. ``scale``: the soft mask multiplies by the
    reciprocal of its pixel scale, the rasterizer by n."""
    def edge(v, rnd):
        u = v * (_f32(1.) / scale) if scale is not None else v * float(n)
        return rnd((u + float(n - 1)) * 0.5)
    lo, hi = edge(v0, torch.floor) - 1., edge(v1, torch.ceil) + 1.
    return (torch.fmin(torch.fmax(lo, _f32(0.)), _f32(n)).long(),
            torch.fmin(torch.fmax(hi, _f32(-1.)), _f32(n - 1)).long())


def _slab_rows(lo, hi, row_start, height):
    return ((lo - row_start).clamp(0, height),
            (hi - row_start).clamp(-1, height - 1))


# ---------------------------------------------------------------- soft mask

def _live_bitmap(cut, grad):
    """(B, H, ceil(W / 32)) words: bit c of word q is pixel 32q + c,
    uncovered (cut >= 0) with a nonzero cotangent."""
    B, H, W = cut.shape
    W32 = (W + 31) // 32
    bits = torch.zeros(B, H, 32 * W32, dtype=torch.int64)
    bits[..., :W] = ((cut >= 0) & (grad != 0)).long()
    weights = 1 << torch.arange(32, dtype=torch.int64)
    return (bits.reshape(B, H, W32, 32) * weights).sum(-1)


def _pair_terms(v, px, py, g, m, sigmainv, multiplier):
    """(N, 6) terms of N recorded pairs, the plain version's formulas: ``v``
    (N, 6) the faces' scaled coords, ``px``, ``py`` the pixel centres,
    ``g`` the cotangent and ``m`` the mask at the pixels."""
    dissquare, which = ks._min6(px, py, v, multiplier)
    mult = v.new_tensor(multiplier)
    prob = torch.exp(-(sigmainv * dissquare / mult / mult))
    dLdz = -1. * sigmainv * g * (1. - m) / (1. - prob + ks._EPS) * prob
    out = v.new_zeros(v.shape)

    def add(col, sel, term):
        out[:, col] += torch.where(sel, term, 0.)

    for i in range(3):
        sel = which == 3 + i
        add(2 * i, sel, dLdz * 2. * (v[:, 2 * i] - px))
        add(2 * i + 1, sel, dLdz * 2. * (v[:, 2 * i + 1] - py))
    for e in range(3):
        sel, j = which == e, (e + 1) % 3
        x1, y1, x2, y2 = v[:, 2 * e], v[:, 2 * e + 1], v[:, 2 * j], v[:, 2 * j + 1]
        A, B_, C_ = y2 - y1, x1 - x2, x2 * y1 - x1 * y2
        up = A * px + B_ * py + C_
        down = A * A + B_ * B_
        dsq = up * up / (down + ks._EPS)
        dzdA = 2. * (px * up - dsq * A) / (down + ks._EPS)
        dzdB = 2. * (py * up - dsq * B_) / (down + ks._EPS)
        dzdC = 2. * up / (down + ks._EPS)
        add(2 * e, sel, dLdz * (dzdB - y2 * dzdC))
        add(2 * e + 1, sel, dLdz * (x2 * dzdC - dzdA))
        add(2 * j, sel, dLdz * (y1 * dzdC - dzdB))
        add(2 * j + 1, sel, dLdz * (dzdA - x1 * dzdC))
    return out


def _soft_mask_card(img, bboxes, cut, mask, grad, row_start=0, *, height,
                    width, total_height, sigmainv, multiplier):
    """The soft-mask backward as the card finds its work. Returns (the
    (B, F, 6) gradient, {(b, f): [(row, col), ...]} the pairs in the
    order the warps list them, the number of faces that take the whole
    block)."""
    B, F, _ = img.shape
    words = _live_bitmap(cut, grad).tolist()
    x0, y0 = (t.numpy() for t in _pixel_coords(
        height, width, multiplier, torch.float32, row_start, total_height))
    sx = _f32(multiplier / width)
    sy = _f32(multiplier / total_height)
    c0, c1 = _span(bboxes[..., 0], bboxes[..., 2], width, sx)
    lo, hi = _span(-bboxes[..., 3], -bboxes[..., 1], total_height, sy)
    r0, r1 = _slab_rows(lo, hi, row_start, height)
    c0, c1, r0, r1 = (t.tolist() for t in (c0, c1, r0, r1))
    bbn, cutn = bboxes.numpy(), cut.numpy()
    pairs, big, rows_of = {}, 0, []     # rows_of: (b, f, warp, row, col)
    for b in range(B):
        for f in range(F):
            bb = bbn[b, f]
            cl, ch, rl, rh = c0[b][f], c1[b][f], r0[b][f], r1[b][f]
            for _ in range(2):      # trimmed by the float test, two a side
                if cl <= ch and not x0[cl] >= bb[0]:
                    cl += 1
                if cl <= ch and not x0[ch] < bb[2]:
                    ch -= 1
                if rl <= rh and not y0[rl] < bb[3]:
                    rl += 1
                if rl <= rh and not y0[rh] >= bb[1]:
                    rh -= 1
            rows = range(rl, rh + 1) if ch >= cl else range(0)
            segs = [(r, q) for r in rows for q in range(cl >> 5, (ch >> 5) + 1)]
            split = len(segs) > BIG_SEGS
            big += split
            listed = []
            for n in range(0, len(segs), 32):      # steps of 32 segments
                warp = (n // 32) % WARPS if split else 0
                for r, q in segs[n:n + 32]:
                    word = words[b][r][q]
                    for col in range(max(32 * q, cl), min(32 * q + 32, ch + 1)):
                        if not word >> (col - 32 * q) & 1:
                            continue
                        px, py = x0[col], y0[r]
                        if (px >= bb[0] and px < bb[2] and py >= bb[1]
                                and py < bb[3] and f <= cutn[b, r, col]):
                            listed.append((r, col))
                            rows_of.append((b, f, warp, r, col))
            pairs[b, f] = listed
    out = torch.zeros(B * F * WARPS, 6, dtype=img.dtype)
    if rows_of:
        b, f, warp, r, col = torch.tensor(rows_of).unbind(1)
        terms = _pair_terms(img[b, f], torch.tensor(x0)[col].to(img.dtype),
                            torch.tensor(y0)[r].to(img.dtype), grad[b, r, col],
                            mask[b, r, col], sigmainv, multiplier)
        # each warp's sums in its listed order
        out.index_add_(0, (b * F + f) * WARPS + warp, terms)
    total = img.new_zeros(B * F, 6)
    for w in range(WARPS):                         # warp order
        total = total + out.reshape(B * F, WARPS, 6)[:, w]
    return (total / img.new_tensor(multiplier)).reshape(B, F, 6), pairs, big


def _plain_pairs(img, bboxes, cut, grad, row_start, height, width,
                 total_height, multiplier):
    """{(b, f): sorted [(row, col)]}: the pairs the plain version sums."""
    x0, y0 = _pixel_coords(height, width, multiplier, torch.float32,
                           row_start, total_height)
    px, py = x0[None, None, None, :], y0[None, None, :, None]
    bb = bboxes[:, :, :, None, None]
    hit = ((px >= bb[:, :, 0]) & (px < bb[:, :, 2]) & (py >= bb[:, :, 1])
           & (py < bb[:, :, 3]))
    ids = torch.arange(img.shape[1])[None, :, None, None]
    rec = hit & (ids <= cut[:, None]) & (grad[:, None] != 0)
    out = {}
    for b, f, r, c in rec.nonzero().tolist():
        out.setdefault((b, f), []).append((r, c))
    return out


def _triangles(seed, faces, spread=0.9, size=0.15, batch=2):
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-spread, spread, (batch, faces, 1, 2))
    return (centre + rng.uniform(-size, size, (batch, faces, 3, 2))).astype(
        np.float32)


def _soft_case(case):
    """(fvi (B, F, 3, 2) float32, height, width, row_start, total_height,
    knum) of one case."""
    H = W = 40
    row_start, total = 0, None
    knum = 30
    if case == 'whole':
        # a sliver along the diagonal, whose rectangle is the whole
        # image, and small faces
        fvi = _triangles(3, 12, spread=1.0, size=0.08)
        fvi[:, 0] = [[-1.2, -1.2], [1.2, 1.2], [1.2, 1.1]]
        H = W = 72                # 216 row segments: the whole block
    elif case == 'offscreen':
        fvi = _triangles(4, 20)
        fvi[:, :8] += 3.          # entirely right of and above the image
    elif case == 'slab':
        fvi = _triangles(5, 30)
        H, row_start, total = 16, 8, 40
    elif case == 'wide':
        fvi = _triangles(6, 24)
        H, W = 24, 70             # three words a row, the last one partial
    else:                          # 'knum1', 'knum2', 'knum30'
        fvi = _triangles(7, 60, size=0.2)
        knum = int(case[4:])
    return fvi, H, W, row_start, total or H, knum


def _soft_inputs(fvi, H, W, row_start, total, knum, boxlen=0.05):
    """The backward's inputs from a render of ``fvi``: scaled verts,
    enlarged bboxes, the cut, the mask and a seeded cotangent."""
    tv = torch.tensor(fvi)
    tz = torch.full(fvi.shape[:3], -2.)
    _, idx = kt.render.mesh.rasterize(H, W, tz, tv, tz[..., None],
                                      row_start=row_start, total_height=total)
    img, bboxes = _scaled_inputs(tv, boxlen, 1000.)
    kw = dict(height=H, width=W, total_height=total, **SM)
    mask, cut = ks.soft_mask_forward(img, bboxes, idx, row_start, knum=knum,
                                     return_cut=True, **kw)
    grad = torch.tensor(np.random.default_rng(2).standard_normal(
        mask.shape).astype(np.float32))
    grad[:, :, ::7] = 0.          # the bitmap drops zero cotangents
    return img, bboxes, cut, mask, grad, kw


@pytest.mark.parametrize('case', ['whole', 'offscreen', 'slab', 'wide',
                                  'knum1', 'knum2', 'knum30'])
def test_soft_mask_walk(case):
    """The pairs the card's walk lists are exactly the plain version's,
    and its sums agree with the plain version."""
    fvi, H, W, row_start, total, knum = _soft_case(case)
    img, bboxes, cut, mask, grad, kw = _soft_inputs(fvi, H, W, row_start,
                                                    total, knum)
    out, pairs, big = _soft_mask_card(img, bboxes, cut, mask, grad,
                                      row_start, **kw)
    ref_pairs = _plain_pairs(img, bboxes, cut, grad, row_start, H, W, total,
                             1000.)
    assert {k: sorted(v) for k, v in pairs.items() if v} == ref_pairs
    for listed in pairs.values():      # the walk's order: row, then column
        assert listed == sorted(listed)
    assert sum(map(len, pairs.values())) > 0
    ref = ks.soft_mask_backward_plain(img, bboxes, cut, mask, grad,
                                      row_start, **kw)
    _close(ref, out)
    if case == 'whole':
        assert big == 2                # the big face, in both batch entries
    if case == 'offscreen':
        assert not out[:, :8].any() and not any(
            pairs[b, f] for b in range(2) for f in range(8))


@pytest.mark.parametrize('case', ['whole', 'slab'])
def test_soft_mask_walk_against_kaolin_tpu(case):
    """The walk's sums against ``jax.grad`` of ``kaolin_tpu``'s soft mask
    (XLA path) on the same render."""
    fvi, H, W, row_start, total, knum = _soft_case(case)
    img, bboxes, cut, mask, grad, kw = _soft_inputs(fvi, H, W, row_start,
                                                    total, knum)
    _, idx = kt.render.mesh.rasterize(
        H, W, torch.full(fvi.shape[:3], -2.), torch.tensor(fvi),
        torch.full(fvi.shape[:3] + (1,), -2.), row_start=row_start,
        total_height=total)
    cot = grad.numpy()

    def jloss(v):
        return jnp.sum(kal.render.mesh.dibr_soft_mask(
            v, jnp.asarray(idx.numpy()), sigmainv=7000., boxlen=0.05,
            knum=knum, multiplier=1000., row_start=row_start,
            total_height=total, backend='xla') * cot)

    ref = jax.jit(jax.grad(jloss))(jnp.asarray(fvi))
    out, _, _ = _soft_mask_card(img, bboxes, cut, mask, grad, row_start, **kw)
    _close(np.asarray(ref), out.reshape(fvi.shape).numpy())


# ---------------------------------------------------------------- rasterize

def _lanes(D):
    """The kernel's lane map: (DL, [(walk start, {channel: (lane, q)})])."""
    dl_log = 0
    while (1 << dl_log) < D and dl_log < 5:
        dl_log += 1
    DL = 1 << dl_log
    walks = []
    for ch0 in range(0, max(D, 1), DC):
        ch1 = min(D, ch0 + DC)
        seen = {}
        for lane in range(DL):
            for q in range(DC // 32):
                d = ch0 + lane + q * DL
                if d < ch1:
                    assert d not in seen
                    seen[d] = (lane, q)
        walks.append((ch0, seen))
    return DL, walks


def _rasterize_card(grad, idx, weights, img, feats, row_start=0, *,
                    total_height, eps, valid=None):
    """The rasterize backward as the card finds its work: a face the
    forward culled (``valid`` False) is skipped unread. Returns (grad
    image verts (B, F, 6), grad features (B, F, 3D), {(b, f): [pixel,
    ...]} the owned pixels in the walk's order, the faces that take the
    whole block)."""
    B, H, W, D = grad.shape
    F = img.shape[1]
    seg, gi_pix, gf_pix = krb._pixel_terms(grad, idx, weights, img, feats,
                                           eps)
    row_of = torch.full((B * H * W,), -1, dtype=torch.int64)
    row_of[(idx.reshape(-1) >= 0).nonzero().flatten()] = torch.arange(
        seg.numel())
    xs, ys = img[..., 0::2], img[..., 1::2]
    c0, c1 = _span(xs.amin(-1), xs.amax(-1), W)
    lo, hi = _span(-ys.amax(-1), -ys.amin(-1), total_height)
    r0, r1 = _slab_rows(lo, hi, row_start, H)
    c0, c1, r0, r1 = (t.tolist() for t in (c0, c1, r0, r1))
    idxn = idx.numpy()
    _lanes(D)                          # every channel in one lane of a walk
    owned, big, where = {}, 0, []      # where: (row of the terms, slot)
    for b in range(B):
        for f in range(F):
            if valid is not None and not valid[b, f]:
                owned[b, f] = []
                continue
            rect = [(r, c) for r in range(r0[b][f], r1[b][f] + 1)
                    for c in range(c0[b][f], c1[b][f] + 1)]
            split = len(rect) > BIG_PIX
            big += split
            lists = [[] for _ in range(WARPS)]
            for n in range(0, len(rect), 32 * AHEAD):   # batches
                for r, c in rect[n:n + 32 * AHEAD]:
                    if idxn[b, r, c] == f:
                        warp = (n // (32 * AHEAD)) % WARPS if split else 0
                        lists[warp].append((b * H + r) * W + c)
            owned[b, f] = sorted(p - b * H * W for lst in lists for p in lst)
            for w, lst in enumerate(lists):
                where += [(int(row_of[p]), (b * F + f) * WARPS + w)
                          for p in lst]
    n, slot = torch.tensor(where, dtype=torch.int64).reshape(-1, 2).unbind(1)
    assert bool((seg[n] == slot // WARPS).all())
    gi = img.new_zeros(B * F * WARPS, 6).index_add_(0, slot, gi_pix[n])
    gf = img.new_zeros(B * F * WARPS, 3 * D).index_add_(0, slot, gf_pix[n])
    grad_img = img.new_zeros(B * F, 6)
    grad_feat = img.new_zeros(B * F, 3 * D)
    for w in range(WARPS):                         # warp order
        grad_img = grad_img + gi.reshape(B * F, WARPS, 6)[:, w]
        grad_feat = grad_feat + gf.reshape(B * F, WARPS, 3 * D)[:, w]
    return (grad_img.reshape(B, F, 6), grad_feat.reshape(B, F, 3 * D), owned,
            big)


def _raster_case(case, dim):
    """(fvz, fvi, features, valid, H, W, row_start, total) of a case."""
    H = W = 32
    row_start, total = 0, None
    fvi = _triangles(11, 40, size=0.25)
    rng = np.random.default_rng(12)
    fvz = (-1. - rng.random(fvi.shape[:3])).astype(np.float32)
    valid = np.ones(fvi.shape[:2], bool)
    if case == 'whole':
        fvi[:, 0] = [[-5., -5.], [5., -5.], [0., 5.]]
        fvz[:, 0] = -0.5          # in front: it owns most pixels
        H = W = 40                # 1,600 pixels: the whole block
    elif case == 'unowned':
        fvi[:, :6] += 3.          # off screen
        valid[:, 6:14] = False    # culled, as back faces are
    elif case == 'slab':
        H, row_start, total = 12, 10, 32
    ff = rng.standard_normal(fvi.shape[:3] + (dim,)).astype(np.float32)
    return fvz, fvi, ff, valid, H, W, row_start, total or H


@pytest.mark.parametrize('case,dim', [('soup', 1), ('soup', 4), ('soup', 9),
                                      ('soup', 40), ('whole', 4),
                                      ('unowned', 9), ('slab', 40)])
def test_rasterize_walk(case, dim):
    """The pixels the card's walk lists are exactly those each face owns,
    every channel lies in one lane of one walk, and the sums agree with
    the plain version."""
    fvz, fvi, ff, valid, H, W, row_start, total = _raster_case(case, dim)
    tz, tv, tf = (torch.tensor(a) for a in (fvz, fvi, ff))
    B, F = fvi.shape[:2]
    feats = tf.reshape(B, F, 3 * dim)
    fz, img_s, bbox = kt.render.mesh.rasterization._kernel_inputs(
        tz, tv, torch.tensor(valid), 1000.)
    _, idx, weights = kt.kernels.rasterize.rasterize_interp_plain(
        fz, img_s, bbox, feats, row_start, height=H, width=W,
        total_height=total, multiplier=1000., eps=1e-8)
    grad = torch.tensor(np.random.default_rng(3).standard_normal(
        (B, H, W, dim)).astype(np.float32))
    args = (grad, idx, weights, tv.reshape(B, F, 6), feats)
    gi, gf, owned, big = _rasterize_card(*args, row_start,
                                         total_height=total, eps=1e-8,
                                         valid=valid)
    for (b, f), lst in owned.items():
        assert lst == (idx[b].reshape(-1) == f).nonzero().flatten().tolist()
    ref_gi, ref_gf = krb.rasterize_backward_plain(*args, eps=1e-8)
    _close(ref_gi, gi)
    _close(ref_gf, gf)
    if case == 'whole':
        assert big == 2
    if case == 'unowned':
        assert not gi[:, :14].any() and not gf[:, :14].any()


def test_rasterize_walk_against_kaolin_tpu():
    """The walk's sums at D = 40 on slab rows against ``jax.grad`` of
    ``kaolin_tpu``'s rasterize (XLA path)."""
    fvz, fvi, ff, valid, H, W, row_start, total = _raster_case('slab', 40)
    B, F = fvi.shape[:2]
    cot = np.random.default_rng(3).standard_normal(
        (B, H, W, 40)).astype(np.float32)

    def jloss(v, f):
        feat, _ = kal.render.mesh.rasterize(
            H, W, jnp.asarray(fvz), v, f, row_start=row_start,
            total_height=total, backend='xla')
        return jnp.sum(feat * cot)

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(fvi),
                                                   jnp.asarray(ff))
    tv, tf = torch.tensor(fvi), torch.tensor(ff)
    feats = tf.reshape(B, F, 120)
    _, idx, weights = kt.kernels.rasterize.rasterize_interp_plain(
        *kt.render.mesh.rasterization._kernel_inputs(
            torch.tensor(fvz), tv, None, 1000.), feats, row_start, height=H,
        width=W, total_height=total, multiplier=1000., eps=1e-8)
    gi, gf, _, _ = _rasterize_card(torch.tensor(cot), idx, weights,
                                   tv.reshape(B, F, 6), feats, row_start,
                                   total_height=total, eps=1e-8)
    _close(np.asarray(ref[0]), gi.reshape(fvi.shape).numpy())
    _close(np.asarray(ref[1]), gf.reshape(ff.shape).numpy())


@pytest.mark.parametrize('dim', [1, 4, 9, 40, 70])
def test_rasterize_lane_map(dim):
    """Every channel in exactly one (lane, q) of one walk of 64: D <= 64
    takes one walk, D = 70 two; the groups of DL lanes cover the 32 lanes."""
    DL, walks = _lanes(dim)
    assert len(walks) == (1 if dim <= DC else 2)
    assert sorted(d for _, lanes in walks for d in lanes) == list(range(dim))
    assert DL == min(32, 1 << (dim - 1).bit_length()) and 32 % DL == 0


def test_constants_match_sources():
    """The constants the walks above are written with are the CUDA
    sources' own."""
    import re
    from pathlib import Path
    csrc = Path(ks.__file__).resolve().parent.parent / 'csrc'

    def consts(name):
        text = (csrc / f'{name}.cu').read_text()
        # the constants of the headers it includes come first
        for header in re.findall(r'#include "(\w+\.cuh)"', text):
            text = (csrc / header).read_text() + text
        out = {}
        for key, expr in re.findall(r'constexpr int (\w+) = ([^;]+);', text):
            out[key] = eval(expr, {}, dict(out))
        return out
    soft, rast = consts('soft_mask'), consts('rasterize_bwd')
    assert (soft['BWD_WARPS'], soft['BIG_SEGS']) == (WARPS, BIG_SEGS)
    assert (rast['WARPS'], rast['AHEAD'], rast['DC'], rast['BIG_PIX']) == (
        WARPS, AHEAD, DC, BIG_PIX)


def test_no_faces():
    """With no faces the plain versions give empty gradients, as the card's
    entry points (which return before any launch)."""
    img = torch.zeros(2, 0, 6)
    bboxes = torch.zeros(2, 0, 4)
    cut = torch.full((2, 8, 8), 2, dtype=torch.int32)
    mask = torch.zeros(2, 8, 8)
    g = ks.soft_mask_backward(img, bboxes, cut, mask, torch.ones(2, 8, 8),
                              height=8, width=8, **SM)
    assert g.shape == (2, 0, 6)
    gi, gf = krb.rasterize_backward(
        torch.ones(2, 8, 8, 4), torch.full((2, 8, 8), -1, dtype=torch.int32),
        torch.zeros(2, 8, 8, 3), img, torch.zeros(2, 0, 12), eps=1e-8)
    assert gi.shape == (2, 0, 6) and gf.shape == (2, 0, 12)
    out, pairs, big = _soft_mask_card(img, bboxes, cut, mask,
                                      torch.ones(2, 8, 8), height=8, width=8,
                                      total_height=8, **SM)
    assert out.shape == (2, 0, 6) and not pairs and big == 0
