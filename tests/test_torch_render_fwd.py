"""The forward render kernels' per-tile face lists, written out in PyTorch.

``csrc/rasterize.cu`` (both modes) and the forward of ``csrc/soft_mask.cu``
run only on a CUDA card. What they do to find and order their work is
written out here, on the CPU, and held against the plain versions
(``rasterize_interp_plain``, ``rasterize_select_plain``,
``soft_mask_forward_plain``, ``tile_bins_plain``: the lists bit for bit)
and, through
``dibr_rasterization``, against ``kaolin_tpu`` (its XLA path):

- the binning (``tile_bins``, ``csrc/tile_lists.cuh``): a face's span of
  16x16 tiles from its bbox by integer arithmetic, padded by one tile,
  trimmed at both ends by the walks' float test (the bbox overlaps the
  tile's pixel-centre rectangle); a bit in each slot (a tile's faces of
  ``CHUNK`` consecutive ids) it overlaps;
- the walks: a tile's nonempty slots in turn, a slot's faces read off its
  bits in id order; the rasterize walk compacts them to the faces whose
  own bbox overlaps the tile (lists of the soft mask's enlarged bboxes
  hold more) and keeps a strict ``z > best_z``; the soft-mask walk takes
  the first ``knum`` enlarged-bbox hits of each uncovered pixel, and a
  tile with no uncovered pixel stages nothing.

The walks must give the plain versions' outputs bit for bit. The scenes:
a small sphere, the large-faces scene at 64x64, faces whose bboxes end on
tile edges, slab rows, duplicate faces and +-0 depths, faces off screen.
The card's own kernels are held against the plain versions in
``tests/test_torch_cuda.py``.
"""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import kaolin_tpu as kal
import kaolin_tpu_torch as kt
from kaolin_tpu_torch.kernels import rasterize as kr
from kaolin_tpu_torch.kernels import soft_mask as ks
from kaolin_tpu_torch.render.mesh.dibr import _scaled_inputs
from kaolin_tpu_torch.render.mesh.rasterization import _kernel_inputs

TILE, CHUNK = 16, 1024                     # csrc/tile_lists.cuh
RKW = dict(multiplier=1000., eps=1e-8)
SM = dict(sigmainv=7000., multiplier=1000.)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """The walks are many small tensor ops: one intra-op thread keeps them
    from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ binning

def _tile_span(v0, v1, rs, n, first, n_tiles, dt):
    """``tile_span``: the tiles whose pixels (of a line of n, less
    ``first``) can have centres in [v0, v1), padded by one pixel and one
    tile, clipped; in the bbox's float type."""
    a = (v0 * rs + dt(n - 1)) * dt(0.5)
    b = (v1 * rs + dt(n - 1)) * dt(0.5)
    edge = dt(n_tiles * TILE)
    lo = np.floor(np.fmin(a, b)) - dt(1) - dt(first)
    hi = np.ceil(np.fmax(a, b)) + dt(1) - dt(first)
    lo = np.fmin(np.fmax(lo, dt(-TILE)), edge)
    hi = np.fmin(np.fmax(hi, dt(-TILE)), edge)
    return (max(int(np.floor(lo / dt(TILE))) - 1, 0),
            min(int(np.floor(hi / dt(TILE))) + 1, n_tiles - 1))


def _rect(tx, ty, H, W, row_start, total, sx, sy, dt):
    """Tile (tx, ty)'s pixel-centre rectangle (x_lo, x_hi, y_lo, y_hi)."""
    c0, c1 = tx * TILE, min(tx * TILE + TILE, W) - 1
    r0, r1 = ty * TILE, min(ty * TILE + TILE, H) - 1
    return (sx * dt(2 * c0 + 1 - W), sx * dt(2 * c1 + 1 - W),
            sy * dt(total - 2 * (row_start + r1) - 1),
            sy * dt(total - 2 * (row_start + r0) - 1))


def _card_bins(bboxes, row_start, H, W, total, multiplier, chunk=CHUNK):
    """The binning pass: (the lists, tiles the trim dropped). The lists: n
    slots of chunk / 32 words; slot ((b * tile rows + ty) * tile columns +
    tx) * chunks + f // chunk holds the faces of tile (ty, tx) whose ids lie
    in that chunk, face f as bit f % 32 of word f % chunk // 32."""
    bb = bboxes.numpy()
    dt = bb.dtype.type
    B, F = bb.shape[:2]
    sx, sy = dt(multiplier / W), dt(multiplier / total)
    ny, nx, chunks = -(-H // TILE), -(-W // TILE), -(-F // chunk)
    n, nw = B * ny * nx * chunks, chunk // 32
    words = np.zeros(n * nw, np.int64)
    trimmed = 0

    def xok(v, t):
        x_lo, x_hi = _rect(t, 0, H, W, row_start, total, sx, sy, dt)[:2]
        return bool(v[0] <= x_hi and v[2] > x_lo)

    def yok(v, t):
        y_lo, y_hi = _rect(0, t, H, W, row_start, total, sx, sy, dt)[2:]
        return bool(v[1] <= y_hi and v[3] > y_lo)
    with np.errstate(invalid='ignore', over='ignore'):
        for b in range(B):
            for f in range(F):
                v = bb[b, f]
                x0, x1 = _tile_span(v[0], v[2], dt(1) / sx, W, 0, nx, dt)
                y0, y1 = _tile_span(-v[3], -v[1], dt(1) / sy, total,
                                    row_start, ny, dt)
                n0 = max(x1 - x0 + 1, 0) * max(y1 - y0 + 1, 0)
                while x0 <= x1 and not xok(v, x0):
                    x0 += 1
                while x1 >= x0 and not xok(v, x1):
                    x1 -= 1
                while y0 <= y1 and not yok(v, y0):
                    y0 += 1
                while y1 >= y0 and not yok(v, y1):
                    y1 -= 1
                trimmed += n0 - max(x1 - x0 + 1, 0) * max(y1 - y0 + 1, 0)
                for ty in range(y0, y1 + 1):
                    for tx in range(x0, x1 + 1):
                        slot = ((b * ny + ty) * nx + tx) * chunks + f // chunk
                        words[slot * nw + f % chunk // 32] |= 1 << (f % 32)
    return torch.tensor(words.astype(np.uint32).view(np.int32)), trimmed


def _tile_lists(bins, B, F, H, W, chunk=CHUNK, batches=False):
    """Each tile's list (b, ty, tx, [ids]): its slots in turn, a slot's
    faces read off its words in id order, as warp 0 lists them. With
    ``batches``, each slot's faces padded with -1 to a multiple of 32: the
    walks take 32 staged faces at a time, a slot's 256 at a time."""
    ny, nx, chunks = -(-H // TILE), -(-W // TILE), -(-F // chunk)
    n, nw = B * ny * nx * chunks, chunk // 32
    words = bins.numpy().view(np.uint32).reshape(n, nw)
    out = []
    for b in range(B):
        for ty in range(ny):
            for tx in range(nx):
                t = ((b * ny + ty) * nx + tx) * chunks
                lst = []
                for c in range(chunks):
                    bits = np.unpackbits(words[t + c].view(np.uint8),
                                         bitorder='little')
                    ids = (np.flatnonzero(bits) + c * chunk).tolist()
                    lst += ids + ([-1] * (-len(ids) % 32) if batches else [])
                out.append((b, ty, tx, lst))
    return out


# -------------------------------------------------------------------- walks

def _tile_pixels(tiles, H, W, row_start, total, multiplier, dt):
    """Per tile, its 256 pixels: (b, rows, cols, active, px, py)."""
    tdt = torch.float64 if dt == np.float64 else torch.float32
    x0, y0 = kr._pixel_coords(H, W, multiplier, tdt, row_start, total)
    j = torch.arange(TILE * TILE)
    rows = torch.tensor([ty * TILE for _, ty, _, _ in tiles])[:, None] + \
        j // TILE
    cols = torch.tensor([tx * TILE for _, _, tx, _ in tiles])[:, None] + \
        j % TILE
    active = (rows < H) & (cols < W)
    px = x0[cols.clamp(max=W - 1)]
    py = y0[rows.clamp(max=H - 1)]
    b = torch.tensor([t[0] for t in tiles])
    return b, rows, cols, active, px, py


def _padded(tiles):
    """(tiles, longest list) face ids, -1 past a list's end."""
    K = max([len(t[3]) for t in tiles] + [0])
    return torch.tensor([t[3] + [-1] * (K - len(t[3])) for t in tiles],
                        dtype=torch.int64).reshape(len(tiles), K)


def _tile_masks(bbox, tiles, tb, faces, height, width, row_start, total,
                multiplier):
    """Each listed face's tile_mask, as bools: (T, K, 16) the columns whose
    centre lies in [bb[0], bb[2]), (T, K, 16) the rows whose centre lies in
    [bb[1], bb[3]), the tile's centres past the image's edge included; -1
    entries have none."""
    dt = bbox.dtype
    j = torch.arange(TILE)
    tx = torch.tensor([t[2] for t in tiles])[:, None] * TILE + j
    ty = row_start + torch.tensor([t[1] for t in tiles])[:, None] * TILE + j
    xs = torch.tensor(multiplier / width, dtype=dt) * (
        2 * tx + 1 - width).to(dt)
    ys = torch.tensor(multiplier / total, dtype=dt) * (
        total - 2 * ty - 1).to(dt)
    bb = bbox[tb[:, None], faces.clamp(min=0)][..., None]
    valid = (faces >= 0)[..., None]
    cols = (xs[:, None] >= bb[..., 0, :]) & (xs[:, None] < bb[..., 2, :])
    rows = (ys[:, None] >= bb[..., 1, :]) & (ys[:, None] < bb[..., 3, :])
    return cols & valid, rows & valid


def _pixel_faces(cols, rows):
    """(T, K, 256) whether pixel j (row j // 16, column j % 16) is in face
    k's bbox: its column bit and its row bit. A warp (rows 2w, 2w + 1)
    takes only the faces over some pixel of its rows, which holds every
    such pair."""
    j = torch.arange(TILE * TILE)
    hit = cols[..., j % TILE] & rows[..., j // TILE]
    warp_rows = rows.reshape(*rows.shape[:2], TILE // 2, 2).any(-1)
    over = warp_rows & cols.any(-1, keepdim=True)          # (T, K, 8)
    assert bool((~hit | over[..., j // 32]).all())
    return hit


def _rasterize_card(fz, img, bbox, feat, bins, row_start=0, *, height, width,
                    total_height, multiplier, eps):
    """Both modes of the rasterize walk over ``bins``: each pixel takes the
    faces whose tile_mask holds it in id order, a strict z > best_z.
    Returns (features, face_idx, weights, zbuf)."""
    B, F, _ = fz.shape
    D = feat.shape[-1] // 3
    dt = bbox.numpy().dtype.type
    tiles = _tile_lists(bins, B, F, height, width, batches=True)
    tb, rows, cols, active, px, py = _tile_pixels(
        tiles, height, width, row_start, total_height, multiplier, dt)
    lists = _padded(tiles)
    hits = _pixel_faces(*_tile_masks(bbox, tiles, tb, lists, height, width,
                                     row_start, total_height, multiplier))
    T = len(tiles)
    best_z = torch.full((T, TILE * TILE), -torch.inf, dtype=fz.dtype)
    best = torch.full((T, TILE * TILE), -1, dtype=torch.int64)
    bw = torch.zeros((T, TILE * TILE, 3), dtype=fz.dtype)
    for k in range(lists.shape[1]):
        f = lists[:, k]
        fc = f.clamp(min=0)
        hit = hits[:, k] & active
        w0, w1, w2 = kr._barycentric(px, py, img[tb, fc][:, None], eps)
        z3 = fz[tb, fc][:, None]
        z = w0 * z3[..., 0] + w1 * z3[..., 1] + w2 * z3[..., 2]
        ok = hit & (w0 >= 0.) & (w1 >= 0.) & (w2 >= 0.)
        take = ok & (z > best_z)
        best_z = torch.where(take, z, best_z)
        best = torch.where(take, f[:, None], best)
        bw = torch.where(take[..., None], torch.stack([w0, w1, w2], -1), bw)
    out_feat = fz.new_zeros((T, TILE * TILE, D))
    if F:
        fv = feat[tb[:, None], best.clamp(min=0)].reshape(T, TILE * TILE, 3,
                                                          D)
        out_feat = (bw[..., 0, None] * fv[..., 0, :] + bw[..., 1, None]
                    * fv[..., 1, :] + bw[..., 2, None] * fv[..., 2, :])
        out_feat = torch.where((best >= 0)[..., None], out_feat, 0.)
    a = active
    bidx = tb[:, None].expand_as(rows)
    idx = torch.full((B, height, width), -2, dtype=torch.int32)
    idx[bidx[a], rows[a], cols[a]] = best[a].to(torch.int32)
    weights = fz.new_zeros((B, height, width, 3))
    weights[bidx[a], rows[a], cols[a]] = bw[a]
    features = fz.new_zeros((B, height, width, D))
    features[bidx[a], rows[a], cols[a]] = out_feat[a]
    zbuf = fz.new_zeros((B, height, width))
    zbuf[bidx[a], rows[a], cols[a]] = best_z[a]
    assert int((idx == -2).sum()) == 0, 'a pixel no tile wrote'
    return features, idx, weights, zbuf


def _soft_mask_card(img, bbox, face_idx, bins, row_start=0, *, height, width,
                    total_height, knum, sigmainv, multiplier, chunk=CHUNK):
    """The soft-mask walk over ``bins``, 32 staged faces at a time: each
    pixel's faces of the batch (its column's and its row's ballots), cut to
    the first ``knum - recorded``, their factors multiplied in in id order.
    Returns (mask, cut, tiles that staged faces: an uncovered pixel and a
    nonempty list)."""
    B, F, _ = img.shape
    dt = bbox.numpy().dtype.type
    tiles = _tile_lists(bins, B, F, height, width, chunk, batches=True)
    tb, rows, cols, active, px, py = _tile_pixels(
        tiles, height, width, row_start, total_height, multiplier, dt)
    T = len(tiles)
    uncovered = active & (face_idx[tb[:, None], rows.clamp(max=height - 1),
                                   cols.clamp(max=width - 1)] < 0)
    walks = uncovered.any(1) & torch.tensor([max(t[3] + [-1]) >= 0
                                             for t in tiles])
    lists = _padded([t if w else t[:3] + ([],)
                     for t, w in zip(tiles, walks.tolist())])
    hits = _pixel_faces(*_tile_masks(bbox, tiles, tb, lists, height, width,
                                     row_start, total_height, multiplier))
    m = img.new_tensor(multiplier)
    recorded = torch.zeros((T, TILE * TILE), dtype=torch.int64)
    prod = torch.ones((T, TILE * TILE), dtype=img.dtype)
    cut = torch.full((T, TILE * TILE), F, dtype=torch.int64)
    for k0 in range(0, lists.shape[1], 32):
        open_ = uncovered & (recorded < knum)
        if not bool(open_.any()):      # every block has stopped
            break
        batch = lists[:, k0:k0 + 32]
        mask = hits[:, k0:k0 + 32].transpose(1, 2) & open_[..., None]
        keep = mask & (mask.long().cumsum(-1)
                       <= (knum - recorded)[..., None])
        cnt = keep.sum(-1)
        recorded = recorded + cnt
        last = keep.shape[-1] - 1 - keep.flip(-1).long().argmax(-1)
        cut = torch.where((cnt > 0) & (recorded == knum),
                          batch.gather(1, last), cut)
        for i in range(batch.shape[1]):
            if not bool(keep[..., i].any()):
                continue
            fc = batch[:, i].clamp(min=0)
            d2, _ = ks._min6(px, py, img[tb, fc][:, None], multiplier)
            prob = torch.exp(-(sigmainv * d2 / m / m))
            prod = torch.where(keep[..., i], prod * (1. - prob), prod)
    a = active
    bidx = tb[:, None].expand_as(rows)
    mask = img.new_full((B, height, width), -1.)
    mask[bidx[a], rows[a], cols[a]] = torch.where(uncovered, 1. - prod,
                                                  1.)[a].to(img.dtype)
    cut_img = torch.full((B, height, width), -2, dtype=torch.int32)
    cut_img[bidx[a], rows[a], cols[a]] = torch.where(
        uncovered & (knum > 0), cut, -1)[a].to(torch.int32)
    assert int((cut_img == -2).sum()) == 0, 'a pixel no tile wrote'
    return mask, cut_img, int(walks.sum())


# ------------------------------------------------------------------- scenes

def _render_inputs(fvz, fvi, ff, valid, H, W, row_start, total, boxlen):
    """The kernels' inputs: rasterize's (z, scaled verts, tight bboxes with
    culled faces empty, flat features) and the soft mask's (scaled verts,
    enlarged bboxes)."""
    fz, img, bbox = _kernel_inputs(fvz, fvi, valid, 1000.)
    B, F = fvi.shape[:2]
    sm_img, sm_bbox = _scaled_inputs(fvi, boxlen, 1000.)
    return (fz, img, bbox, ff.reshape(B, F, -1)), (sm_img, sm_bbox)


def _case(name, dtype=torch.float32):
    """(fvz, fvi, features, valid, H, W, row_start, total_height) of a
    scene."""
    H = W = 64
    row_start, total = 0, 64
    valid = None
    if name in ('sphere', 'large'):
        subdiv, scale = (2, 1.) if name == 'sphere' else (1, 1.35)
        verts, faces, rot, trans, proj = kt.utils.interop.scene(
            2, subdiv, dtype=dtype, device='cpu')
        fvc, fvi, fn = kt.render.mesh.prepare_vertices(
            verts * scale, faces, proj, camera_rot=rot, camera_trans=trans)
        ff = torch.cat([fvc, torch.ones(fvc.shape[:3] + (1,), dtype=dtype)],
                       -1)
        return fvc[..., 2], fvi, ff, fn[..., 2] >= 0., H, W, row_start, total
    rng = np.random.default_rng(len(name))
    fvi = rng.uniform(-0.9, 0.9, (2, 40, 1, 2)) + rng.uniform(
        -0.2, 0.2, (2, 40, 3, 2))
    fvz = -1. - rng.random((2, 40, 3))
    if name == 'edges':
        # vertices on pixel centres (exact at 64 columns: 15.625 * odd),
        # bboxes ending on the centres of tile edges' columns and rows
        cols = rng.choice([14, 15, 16, 17, 31, 32, 33, 47, 48], (2, 40, 3))
        rows = rng.choice([14, 15, 16, 17, 31, 32, 47, 48, 49], (2, 40, 3))
        fvi = np.stack([(2 * cols + 1 - W) / W, (H - 2 * rows - 1) / H], -1)
    elif name == 'slab':
        H, row_start, total = 24, 20, 72
    elif name == 'ties':
        # every face twice (the second copy wins nothing), and depths +-0
        fvz[:, :20:3] = 0.
        fvz[:, 1:20:6] = -0.
        fvi[:, 20:] = fvi[:, :20]
        fvz[:, 20:] = fvz[:, :20]
        valid = torch.tensor(rng.random((2, 40)) < 0.8)
        valid[:, 20:] = valid[:, :20]
    elif name == 'offscreen':
        fvi[:, :15] += 3.          # right of and above the image
        fvi[:, 15:20] -= 3.
    fvi, fvz = torch.tensor(fvi, dtype=dtype), torch.tensor(fvz, dtype=dtype)
    ff = torch.tensor(rng.random((2, 40, 3, 3)), dtype=dtype)
    return fvz, fvi, ff, valid, H, W, row_start, total


CASES = ['sphere', 'large', 'edges', 'slab', 'ties', 'offscreen']


def _tile_holds(bbox, H, W, row_start, total, bins):
    """Every face whose bbox holds a pixel centre of a tile is in the
    tile's list."""
    B, F = bbox.shape[:2]
    x0, y0 = kr._pixel_coords(H, W, 1000., bbox.dtype, row_start, total)
    hold = ((x0 >= bbox[..., 0, None]) & (x0 < bbox[..., 2, None]))
    hold_y = ((y0 >= bbox[..., 1, None]) & (y0 < bbox[..., 3, None]))
    found = 0
    for b, ty, tx, lst in _tile_lists(bins, B, F, H, W):
        xs = hold[b, :, tx * TILE:(tx + 1) * TILE].any(-1)
        ys = hold_y[b, :, ty * TILE:(ty + 1) * TILE].any(-1)
        need = set(torch.nonzero(xs & ys).flatten().tolist())
        assert need <= set(lst), (b, ty, tx)
        found += len(need)
    return found


@pytest.mark.parametrize('case', CASES)
def test_bins(case):
    """The binning holds every face with a pixel centre of a tile in the
    tile's list, and exactly the faces the float test keeps: the plain
    binning's lists, bit for bit."""
    fvz, fvi, ff, valid, H, W, row_start, total = _case(case)
    (fz, img, bbox, feat), (sm_img, sm_bbox) = _render_inputs(
        fvz, fvi, ff, valid, H, W, row_start, total, 0.02)
    for bb in (bbox, sm_bbox):
        bins, trimmed = _card_bins(bb, row_start, H, W, total, 1000.)
        plain = kr.tile_bins(bb, row_start, height=H, width=W,
                             total_height=total, multiplier=1000.)
        assert torch.equal(bins, plain)
        assert trimmed > 0             # the padding gave tiles to trim
        assert _tile_holds(bb, H, W, row_start, total, bins) > 0
    lists = [t[3] for t in _tile_lists(plain, *sm_bbox.shape[:2], H, W)]
    if case == 'offscreen':
        # faces 0-19 lie off the image: in no list
        assert min(min(lst, default=99) for lst in lists) >= 20
    if case == 'large':
        # faces of 64x64 pixels and more: most lists hold several
        assert max(map(len, lists)) >= 4


@pytest.mark.parametrize('case', CASES)
def test_rasterize_walk(case):
    """The walk gives both modes' plain outputs bit for bit, over the
    rasterizer's own lists and over the soft mask's enlarged ones
    (dibr_rasterization's shared binning)."""
    fvz, fvi, ff, valid, H, W, row_start, total = _case(case)
    (fz, img, bbox, feat), (_, sm_bbox) = _render_inputs(
        fvz, fvi, ff, valid, H, W, row_start, total, 0.02)
    kw = dict(height=H, width=W, total_height=total, **RKW)
    ref_f, ref_i, ref_w = kr.rasterize_interp_plain(fz, img, bbox, feat,
                                                    row_start, **kw)
    ref_z, ref_si = kr.rasterize_select_plain(fz, img, bbox, row_start, **kw)
    assert torch.equal(ref_si, ref_i)
    for bb in (bbox, sm_bbox):
        bins, _ = _card_bins(bb, row_start, H, W, total, 1000.)
        f, i, w, z = _rasterize_card(fz, img, bbox, feat, bins, row_start,
                                     **kw)
        assert torch.equal(i, ref_i)
        assert torch.equal(f, ref_f) and torch.equal(w, ref_w)
        assert torch.equal(z, ref_z)
    assert bool((ref_i >= 0).any()) and bool((ref_i < 0).any())
    if case == 'ties':
        # the copies (ids 20..39) tie their originals and lose
        assert not bool((ref_i >= 20).any())


@pytest.mark.parametrize('case', CASES)
@pytest.mark.parametrize('knum', [1, 2, 30, 'F'])
def test_soft_mask_walk(case, knum):
    """The walk gives the plain mask and cut bit for bit, with the card's
    slots of 1,024 ids and with slots of 32 (many slots a tile, so that
    their order counts)."""
    fvz, fvi, ff, valid, H, W, row_start, total = _case(case)
    (fz, img, bbox, feat), (sm_img, sm_bbox) = _render_inputs(
        fvz, fvi, ff, valid, H, W, row_start, total, 0.02)
    _, idx, _ = kr.rasterize_interp_plain(fz, img, bbox, feat, row_start,
                                          height=H, width=W,
                                          total_height=total, **RKW)
    knum = sm_img.shape[1] if knum == 'F' else knum
    kw = dict(height=H, width=W, total_height=total, knum=knum, **SM)
    ref_m, ref_c = ks.soft_mask_forward_plain(sm_img, sm_bbox, idx, row_start,
                                              return_cut=True, **kw)
    for chunk in (CHUNK, 32):
        bins = _card_bins(sm_bbox, row_start, H, W, total, 1000., chunk)[0]
        m, c, walked = _soft_mask_card(sm_img, sm_bbox, idx, bins, row_start,
                                       chunk=chunk, **kw)
        assert torch.equal(m, ref_m) and torch.equal(c, ref_c)
    assert 0 < walked <= len(_tile_lists(bins, *sm_bbox.shape[:2], H, W,
                                         chunk))
    if knum <= 2:
        assert bool((ref_c[idx < 0] < sm_img.shape[1]).any()), \
            'knum binds on no pixel'


def test_dibr_against_kaolin_tpu():
    """``dibr_rasterization``'s outputs from the walks over one shared
    binning (the enlarged bboxes) against ``kaolin_tpu``'s XLA path, at
    float64 on slab rows of the sphere."""
    H, row_start, total, W = 40, 12, 64, 64
    verts, faces, rot, trans, proj = kt.utils.interop.scene(
        2, 2, dtype=torch.float64, device='cpu')
    fvc, fvi, fn = kt.render.mesh.prepare_vertices(
        verts, faces, proj, camera_rot=rot, camera_trans=trans)
    ff = torch.cat([fvc, torch.ones(fvc.shape[:3] + (1,),
                                    dtype=torch.float64)], -1)
    ref_f, ref_m, ref_i = kal.render.mesh.dibr_rasterization(
        H, W, jnp.asarray(fvc[..., 2].numpy()), jnp.asarray(fvi.numpy()),
        jnp.asarray(ff.numpy()), jnp.asarray(fn[..., 2].numpy()),
        row_start=row_start, total_height=total, rast_backend='xla',
        mask_backend='xla')
    (fz, img, bbox, feat), (sm_img, sm_bbox) = _render_inputs(
        fvc[..., 2], fvi, ff, fn[..., 2] >= 0., H, W, row_start, total, 0.02)
    bins = _card_bins(sm_bbox, row_start, H, W, total, 1000.)[0]
    f, i, _, _ = _rasterize_card(fz, img, bbox, feat, bins, row_start,
                                 height=H, width=W, total_height=total, **RKW)
    m, _, _ = _soft_mask_card(sm_img, sm_bbox, i, bins, row_start, height=H,
                              width=W, total_height=total, knum=30, **SM)
    assert np.array_equal(np.asarray(ref_i), i.numpy())
    np.testing.assert_allclose(np.asarray(ref_f), f.numpy(), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(ref_m), m.numpy(), rtol=0,
                               atol=1e-10)
    assert bool((i >= 0).any()) and 0 < float(m.mean()) < 1


def test_constants_match_sources():
    """The layout the walks above are written with is the CUDA sources'
    own, and the wrapper's."""
    csrc = Path(kr.__file__).resolve().parent.parent / 'csrc'

    def consts(name):
        text = (csrc / name).read_text() if '.' in name else (
            csrc / f'{name}.cu').read_text()
        out = {}
        for key, expr in re.findall(r'constexpr int (\w+) = ([^;]+);', text):
            out[key] = eval(expr, {}, dict(out))
        return out
    lists = consts('tile_lists.cuh')
    assert (lists['TILE'], lists['CHUNK'], lists['WORDS']) == (
        TILE, CHUNK, CHUNK // 32) and (kr.TILE, kr.CHUNK) == (TILE, CHUNK)
    for name in ('rasterize', 'soft_mask'):
        assert '#include "tile_lists.cuh"' in (csrc / f'{name}.cu').read_text()


def test_no_faces():
    """With no faces the lists are empty and the walks write the empty
    render, as the plain versions."""
    bbox = torch.zeros(2, 0, 4)
    bins = kr.tile_bins(bbox, height=20, width=20, multiplier=1000.)
    assert bins.numel() == 0
    f, i, w, z = _rasterize_card(torch.zeros(2, 0, 3), torch.zeros(2, 0, 6),
                                 bbox, torch.zeros(2, 0, 6), bins,
                                 height=20, width=20, total_height=20, **RKW)
    assert bool((i == -1).all()) and not f.any() and not w.any()
    assert bool(torch.isneginf(z).all())
    m, c, walked = _soft_mask_card(torch.zeros(2, 0, 6), bbox, i, bins,
                                   height=20, width=20, total_height=20,
                                   knum=3, **SM)
    assert not m.any() and bool((c == 0).all()) and walked == 0
