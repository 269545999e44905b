"""The redesigned ``grid_sample_backward`` and SPC traversal, written out in
PyTorch on the CPU and held against ``kaolin_tpu``.

Both run as CUDA kernels only on a card (``csrc/grid_sample.cu``,
``csrc/spc_traverse.cu``). What they do on the host side, and the order in
which they sum, are written out here:

- the backward's binning (``tile_lists_plain``): each point whose
  cotangent is nonzero in some channel is listed, once, in the list of
  every 32 x 32 texel tile its taps touch, in the kernels' order (by step
  of 32 points, then the tile's rank among the point's tiles, then lane);
  held against a loop over the points;
- its fixed-order sum (``texture_grad_tiled_plain``, the card's bits):
  chunks of a tile's list, SUM_WARPS (8) warp copies of the tile, the
  lanes of one texel summed in lane order (all 32 by an xor butterfly),
  partial tiles added in chunk order; held against ``kaolin_tpu``'s XLA
  gather path (``jax.vjp`` through ``_gather_pixels``) at textures of
  1 x 1, 5 x 7 and 64 x 64, and against its ``_grid_sample_bwd_pallas``
  in interpret mode at 64 x 64 (one compile a mode, the costly part of
  this file), in both modes, also on a case where every point samples
  texel 0, with chunks of 32 entries (many partial tiles) and of the
  card's 4,096. The sums run in other orders, so each entry is held to
  1e-4 * (|ref| + the median nonzero |ref|) + 1e-6 * the sum of its
  terms' magnitudes (``chip_smoke.py``'s tolerance for the card);
- the traversal's capacities (``capacities``), never below the per-level
  totals of ``kaolin_tpu``'s ``unbatched_raytrace_fixed`` at levels 1-5,
  and its host logic (``_traverse_scheduled``) over a plain model of the
  level kernel (``_level_plain``, all levels by ``_levels_plain``): with
  a budget below the totals the trace is sized exactly and run again
  (``traverse.resized``), and gives ``traverse_plain``'s outputs bit for
  bit;
- the constants that these models restate, against the CUDA sources.

The card's kernels are held against these models in
``tests/test_torch_cuda.py``.
"""

import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import kaolin_tpu as kal
from kaolin_tpu.kernels import texture as jtex
from kaolin_tpu.render.mesh.utils import _gather_pixels
from kaolin_tpu.render.spc import raytrace as jr
import kaolin_tpu_torch as kt
from kaolin_tpu_torch.kernels import spc_traverse as kst
from kaolin_tpu_torch.kernels import texture as ktex

TILE = 32                       # csrc/grid_sample.cu
GRAD_TOL, TOL_MASS = 1e-4, 1e-6


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """The models are many small tensor ops: one intra-op thread keeps
    them from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------ grid_sample_backward

def _case(C, H, W, B, P, kind, seed=0):
    """(maps, ix, iy, cot) float32 numpy: random coordinates with a third
    of the cotangents zero ('random'), every point at texel 0 ('hot'), or
    points straddling the tile edges ('edges')."""
    rng = np.random.default_rng(seed)
    maps = rng.random((B, C, H, W))
    ix = rng.random((B, P)) * (W - 1)
    iy = rng.random((B, P)) * (H - 1)
    cot = rng.standard_normal((B, P, C))
    if kind == 'hot':
        ix[:], iy[:] = 0., 0.
    elif kind == 'edges':
        ix = np.clip(rng.integers(1, W // TILE + 1, (B, P)) * TILE - 1.
                     + rng.random((B, P)), 0, W - 1)
        iy = np.clip(rng.integers(1, H // TILE + 1, (B, P)) * TILE - 1.
                     + rng.random((B, P)), 0, H - 1)
    else:
        cot[:, ::3] = 0.
    return [a.astype(np.float32) for a in (maps, ix, iy, cot)]


def _taps(x, y, H, W, mode):
    if mode == 'nearest':
        return [(min(max(int(np.rint(y)), 0), H - 1),
                 min(max(int(np.rint(x)), 0), W - 1))]
    x0 = min(max(int(np.floor(x)), 0), W - 1)
    y0 = min(max(int(np.floor(y)), 0), H - 1)
    x1, y1 = min(x0 + 1, W - 1), min(y0 + 1, H - 1)
    return [(y0, x0), (y0, x1), (y1, x0), (y1, x1)]


def _brute_lists(ix, iy, cot, H, W, mode):
    """The lists by a loop: step by step (32 points), then by the tile's
    rank among the point's tiles, then lane by lane."""
    B, P = ix.shape
    tiles_x = -(-W // TILE)
    ntiles = tiles_x * -(-H // TILE)
    lists = [[] for _ in range(B * ntiles)]
    for b in range(B):
        for p0 in range(0, P, 32):
            tiles = {}
            for p in range(p0, min(p0 + 32, P)):
                if cot[b, p].any():
                    tiles[p] = sorted({
                        (yy // TILE) * tiles_x + xx // TILE
                        for yy, xx in _taps(ix[b, p], iy[b, p], H, W, mode)})
            for rank in range(4):
                for p, ts in tiles.items():
                    if rank < len(ts):
                        lists[b * ntiles + ts[rank]].append(b * P + p)
    return lists


# one (B, P, C) for every texture, so that the JAX references compile once
# a texture size and mode
CASES = [(3, 1, 1, 2, 128, 'random'), (3, 5, 7, 2, 128, 'random'),
         (3, 64, 64, 2, 128, 'random'), (3, 64, 64, 2, 128, 'hot'),
         (2, 70, 45, 2, 200, 'edges')]


@pytest.mark.parametrize('case', CASES)
@pytest.mark.parametrize('mode', ['bilinear', 'nearest'])
def test_tile_lists_match_a_loop_over_the_points(case, mode):
    maps, ix, iy, cot = _case(*case)
    H, W = maps.shape[2:]
    lists, starts, counts = ktex.tile_lists_plain(
        torch.tensor(ix), torch.tensor(iy), torch.tensor(cot), H, W, mode)
    want = _brute_lists(ix, iy, cot, H, W, mode)
    assert counts.tolist() == [len(w) for w in want]
    for s, n, w in zip(starts.tolist(), counts.tolist(), want):
        assert lists[s:s + n].tolist() == w


def _xla_dtex(maps, ix, iy, cot, mode):
    """``kaolin_tpu``'s XLA gather path (``grid_sample_2d``'s body on
    sampler coordinates): the gradient to the maps by ``jax.vjp``."""
    H, W = maps.shape[2:]

    def sample(m):
        if mode == 'nearest':
            return _gather_pixels(m, jnp.round(iy).astype(jnp.int32),
                                  jnp.round(ix).astype(jnp.int32))
        x0, y0 = jnp.floor(ix), jnp.floor(iy)
        wx, wy = (ix - x0)[:, None], (iy - y0)[:, None]
        x0, y0 = x0.astype(jnp.int32), y0.astype(jnp.int32)
        x1, y1 = jnp.clip(x0 + 1, 0, W - 1), jnp.clip(y0 + 1, 0, H - 1)
        return (_gather_pixels(m, y0, x0) * (1 - wy) * (1 - wx)
                + _gather_pixels(m, y0, x1) * (1 - wy) * wx
                + _gather_pixels(m, y1, x0) * wy * (1 - wx)
                + _gather_pixels(m, y1, x1) * wy * wx)

    _, vjp = jax.vjp(sample, jnp.asarray(maps))
    return np.asarray(vjp(jnp.asarray(np.moveaxis(cot, -1, 1)))[0])


def _hold(out, ref, maps, ix, iy, cot, mode, what):
    """Every entry within GRAD_TOL * (|ref| + median nonzero |ref|) +
    TOL_MASS * the sum of its terms' magnitudes (float64)."""
    t = [torch.tensor(a, dtype=torch.float64) for a in (maps, ix, iy, cot)]
    mass = ktex.grid_sample_backward_plain(*t[:3], t[3].abs(), mode)[0]
    ref = torch.tensor(np.array(ref), dtype=torch.float64)
    r = ref.abs()
    med = float(r[r != 0].median())
    tol = GRAD_TOL * (r + med) + TOL_MASS * mass
    d = (out.double() - ref).abs()
    assert bool((d <= tol).all()), (what, float((d / tol).max()))


@pytest.mark.parametrize('case', [c for c in CASES if c[-1] != 'edges'])
@pytest.mark.parametrize('mode', ['bilinear', 'nearest'])
def test_tiled_sum_matches_kaolin_tpu(case, mode):
    maps, ix, iy, cot = _case(*case)
    H, W = maps.shape[2:]
    tix, tiy, tcot = (torch.tensor(a) for a in (ix, iy, cot))
    refs = [(_xla_dtex(maps, ix, iy, cot, mode), 'xla')]
    if (H, W) == (64, 64):
        refs.append((jtex._grid_sample_bwd_pallas(
            jnp.asarray(maps), jnp.asarray(ix), jnp.asarray(iy),
            jnp.asarray(cot), mode, interpret=True)[0], 'pallas interpret'))
    for chunk in (32, ktex.LIST_CHUNK):
        out = ktex.texture_grad_tiled_plain(tix, tiy, tcot, H, W, mode,
                                            list_chunk=chunk)
        assert out.dtype == torch.float32
        for ref, name in refs:
            _hold(out, ref, maps, ix, iy, cot, mode, (name, chunk))


def test_tiled_sum_of_a_hot_tile_in_chunks():
    """Every point on texel 0 of a 64 x 64 texture: 416 entries in tile 0,
    in 13 chunks of 32 (full steps: xor butterflies) whose partial tiles
    add in chunk order."""
    maps, ix, iy, cot = _case(3, 64, 64, 1, 416, 'hot', seed=4)
    tix, tiy, tcot = (torch.tensor(a) for a in (ix, iy, cot))
    lists, starts, counts = ktex.tile_lists_plain(tix, tiy, tcot, 64, 64)
    assert counts.tolist()[0] == 416 and counts.sum() == 416
    slots = ktex.partial_slots(1, 416, 64, 64, list_chunk=32)
    assert ktex._chunks(0, 416, 416, slots, 32) == (13, 0)
    out = ktex.texture_grad_tiled_plain(tix, tiy, tcot, 64, 64,
                                        list_chunk=32)
    ref = ktex.grid_sample_backward_plain(*(torch.tensor(a).double() for a
                                            in (maps, ix, iy, cot)))[0]
    assert bool((out[:, :, 1:, :] == 0).all() and (out[:, :, :, 1:] == 0)
                .all())
    _hold(out, ref, maps, ix, iy, cot, 'bilinear', 'float64 plain')


# ------------------------------------------------------------- traversal

LEVEL = 5


def _spc_and_rays():
    """Config 5's sphere shell (radius 0.7), 20,000 points at level 5,
    from ``kaolin_tpu``, and 600 rays from an off-axis eye; the same
    arrays in the port's types."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(20000, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    q = kal.ops.spc.quantize_points(jnp.asarray(d * 0.7, jnp.float32), LEVEL)
    octree = kal.ops.spc.unbatched_points_to_octree(q, LEVEL)
    _, pyr, exsum = kal.ops.spc.scan_octrees(octree,
                                             np.array([octree.shape[0]]))
    ph = kal.ops.spc.generate_points(octree, pyr, exsum)
    o = np.tile(np.array([[0.4, 0.3, 2.5]]), (600, 1))
    tgt = rng.uniform(-0.8, 0.8, (600, 3))
    tgt[:, 2] = 0.
    dirs = tgt - o
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    o, dirs = o.astype(np.float32), dirs.astype(np.float32)
    spc_t = kt.utils.interop.spc_from_numpy(octree, ph, pyr[0], exsum,
                                            device='cpu')
    return (octree, ph, exsum, o, dirs), (spc_t, torch.tensor(o),
                                          torch.tensor(dirs))


@pytest.fixture(scope='module')
def scene():
    return _spc_and_rays()


def test_capacities_cover_kaolin_tpu_counts(scene, monkeypatch):
    """The shape bound min(8 C_{l-1}, R (3 * 2^l - 2)), and the default
    budget, never below the totals of ``kaolin_tpu``'s trace at levels
    1-5."""
    (octree, ph, exsum, o, d), _ = scene
    R = o.shape[0]
    *_, counts = jr.unbatched_raytrace_fixed(
        jnp.asarray(octree), jnp.asarray(ph), jnp.asarray(exsum),
        jnp.asarray(o), jnp.asarray(d), LEVEL, 64 * R,
        return_level_counts=True, backend='xla')
    counts = np.asarray(counts).tolist()
    assert len(counts) == LEVEL and min(counts) > 0
    for level in range(1, LEVEL + 1):
        for budget in (2 ** 40, None):
            with monkeypatch.context() as m:
                if budget is not None:
                    m.setattr(kst, 'BUDGET_MIN', budget)
                caps = kst.capacities(R, level)
            assert len(caps) == level + 1 and caps[0] == R
            assert all(c >= n for c, n in zip(caps[1:], counts[:level]))
    assert kst.capacities(R, 0) == [R, R]
    assert kst.capacities(R, 3, cap=7)[-1] == 7
    monkeypatch.setattr(kst, 'BUDGET_PER_RAY', 0)
    monkeypatch.setattr(kst, 'BUDGET_MIN', 100)
    assert kst.capacities(R, 8)[2:] == [100] * 7


@pytest.mark.parametrize('level', [0, 1, 3, 5])
@pytest.mark.parametrize('cap', [None, 40, 30000])
def test_scheduled_trace_and_exact_rerun_match_plain(scene, level, cap,
                                                      monkeypatch):
    """The host logic over the plain model of the level kernel: with the
    default budget one pass; with a budget of 32 nuggets the trace is
    sized exactly and run again; both give ``traverse_plain``'s outputs."""
    _, ((octree, ph, _, exsum), o, d) = scene
    for with_exit in (False, True):
        ref = kst.traverse_plain(octree, exsum, ph, o, d, level, with_exit,
                                 cap)
        fn = kst._level_plain(octree, exsum, ph, o, d, with_exit,
                              level == 0)
        for budget in (None, 32):
            n = kst.traverse.resized
            with monkeypatch.context() as m:
                if budget is not None:
                    m.setattr(kst, 'BUDGET_PER_RAY', 0)
                    m.setattr(kst, 'BUDGET_MIN', budget)
                out = kst._traverse_scheduled(kst._levels_plain(fn), fn, o,
                                              level, with_exit, cap)
            over = budget is not None and (
                any(c > budget for c in ref[4][:-1])
                or (cap is None and ref[4][-1] > budget))
            assert kst.traverse.resized == n + int(over)
            for a, b in zip(out[:3], ref[:3]):
                assert torch.equal(a, b)
            assert out[3:] == ref[3:]


def test_constants_match_sources():
    """The constants that the models above and the wrappers restate are the
    CUDA sources' own: the texel tiles, list chunks, warp copies and
    slots of partial tiles of ``grid_sample.cu``, and the look-back tile of
    ``spc_traverse.cu`` (which sizes the state words of ``_state_ints``)."""
    csrc = Path(ktex.__file__).resolve().parent.parent / 'csrc'

    def consts(name):
        out = {}
        for key, expr in re.findall(r'constexpr int (\w+) = ([^;]+);',
                                    (csrc / name).read_text()):
            out[key] = eval(expr, {}, dict(out))
        return out
    gs = consts('grid_sample.cu')
    assert (gs['TILE'], gs['LIST_CHUNK'], gs['SUM_WARPS']) == (
        ktex.TILE, ktex.LIST_CHUNK, ktex.SUM_WARPS) == (TILE, 4096, 8)
    assert (gs['SLOTS_PER_TILE'], gs['SLOTS_EXTRA'], gs['SLOTS_MAX']) == (
        ktex.SLOTS_PER_TILE, ktex.SLOTS_EXTRA, ktex.SLOTS_MAX)
    text = (csrc / 'spc_traverse.cu').read_text()
    assert consts('spc_traverse.cu')['TILE'] == kst.TILE
    assert 'return 2 + 2 * (size_t)((cap_in + TILE - 1) / TILE);' in text
    assert kst._state_ints(1) == 4 and kst._state_ints(kst.TILE + 1) == 6
