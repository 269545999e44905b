"""The brute-force nearest-neighbour selection on the CPU: NaN, inf, ties
and chunk edges against ``kaolin_tpu``, and the card's design written out
in PyTorch.

``nearest_idx_plain`` (the CPU route of ``nearest_idx`` and
``nearest_idx_pruned``), ``sided_distance``, ``chamfer_distance`` and
``f_score`` are held against ``kaolin_tpu``'s XLA scan (``_nearest_idx``
and its metrics) and ``nearest_idx_pallas(interpret=True)``, indices
exactly, at float64 and float32. The XLA scan reads the references in
chunks of 1024 and passes over a chunk whose minimum is NaN: a NaN
coordinate anywhere in a chunk keeps every reference of it from being
taken. The scenes put NaN references in the first, a middle and the last
(partial) chunk, +inf and -inf references, NaN and inf queries, exact ties
across the 1024 and 2048 boundaries, and N2 of 1, 1023, 1024, 1025 and
2049.

``csrc/nn_distance.cu``'s brute force runs only on a CUDA card. What it
does is written out here (:func:`_brute_card`): the host's plan of slices
(``brute_plan``), a block's chunks staged and skipped on a NaN flag, the
fold of 16 references a group with ``fminf``, the lookup in the last
group that lowered a best, the NaN partials of slices below a chunk, and
the merge by least (distance, index) with the chunks that hold a NaN
partial left out. It must give the plain version's indices bit for bit on
every scene and plan. The card's kernels are held against the plain
version in ``tests/test_torch_cuda.py``.
"""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import kaolin_tpu as kal
import kaolin_tpu_torch as kt
from kaolin_tpu.kernels.nn_distance import nearest_idx_pallas
from kaolin_tpu.metrics.pointcloud import _nearest_idx
from kaolin_tpu_torch.kernels import nn_distance as kn

G = 16                                  # csrc/nn_distance.cu: a fold's group
CSRC = Path(kn.__file__).resolve().parent.parent / 'csrc' / 'nn_distance.cu'
TOL = {np.float64: 1e-10, np.float32: 1e-5}


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """The written-out kernel is many small tensor ops: one intra-op
    thread keeps them from contending with the other test workers'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(*arrays):
    return kt.utils.interop.pointclouds_from_numpy(*arrays, device='cpu')


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _grid(rng, shape, step=1. / 64):
    """Points on a lattice of ``step``: every difference and square exact,
    so equal distances are equal bits at both widths."""
    return rng.integers(0, 64, shape) * step


def _scene(name):
    """(queries (1, N1, 3), references (1, N2, 3)) float64, lattice
    points, of one scene."""
    rng = np.random.default_rng(21)
    if name.startswith('n2='):
        n2 = int(name[3:])
        return _grid(rng, (2, 70, 3)), _grid(rng, (2, n2, 3))
    p1, p2 = _grid(rng, (1, 50, 3)), _grid(rng, (1, 3000, 3))
    if name == 'probe':
        # 50 queries, 3,000 references, a NaN coordinate at reference 1,500:
        # the second chunk is passed over
        p2[0, 1500, 1] = np.nan
    elif name == 'nan_first':
        p2[0, 5, 0] = np.nan
    elif name == 'nan_last_partial':
        p2[0, 2999, 2] = np.nan
    elif name == 'nan_every_chunk':
        p2[0, [7, 1100, 2500], 0] = np.nan
    elif name == 'inf_refs':
        p2[0, 10:20, 0] = np.inf
        p2[0, 1030:1040, 1] = -np.inf
        p2[0, 2100, :] = np.inf
        p1[0, :5] = p2[0, 10:15]           # inf queries on inf references
    elif name == 'nonfinite_queries':
        p1[0, 0, 0] = np.nan
        p1[0, 1, 1] = np.inf
        p1[0, 2, 2] = -np.inf
        p1[0, 3] = np.inf
        p2[0, 40, 1] = np.nan
    elif name == 'ties_across_chunks':
        # the same point at 1023, 1024, 2047 and 2048, and queries on it and
        # a step off it: the first copy wins
        for j in (1024, 2047, 2048):
            p2[0, j] = p2[0, 1023]
        p2[0, 2049] = p2[0, 2047]
        p1[0, :10] = p2[0, 1023]
        p1[0, 10:20] = p2[0, 1023] + np.array([1. / 64, 0., 0.])
        p1[0, 20:30] = p2[0, 1023] - np.array([0., 0., 1. / 64])
    return p1, p2


SCENES = ['probe', 'nan_first', 'nan_last_partial', 'nan_every_chunk',
          'inf_refs', 'nonfinite_queries', 'ties_across_chunks', 'n2=1',
          'n2=1023', 'n2=1024', 'n2=1025', 'n2=2049']


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
@pytest.mark.parametrize('name', SCENES)
def test_nearest_idx_plain_matches_xla_and_pallas(name, dtype):
    """Indices exactly equal to the XLA scan and, at float32, the Pallas
    kernel in interpret mode; the CPU wrappers run the plain version."""
    p1, p2 = (a.astype(dtype) for a in _scene(name))
    out = kn.nearest_idx_plain(*_t(p1, p2))
    ref = np.asarray(_nearest_idx(*_j(p1, p2)))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert torch.equal(kn.nearest_idx(*_t(p1, p2)), out)
    assert torch.equal(kn.nearest_idx_pruned(*_t(p1, p2)), out)
    if dtype == np.float32:
        pal = nearest_idx_pallas(*_j(p1, p2), interpret=True)
        np.testing.assert_array_equal(out.numpy(), np.asarray(pal))
    if name == 'probe':
        # the second chunk is passed over: no query takes one of its points,
        # and the finite points there would have won for some
        d = kn._sq_dist(torch.tensor(p1)[0, :, None], torch.tensor(p2)[0, None])
        assert not bool(((out >= 1024) & (out < 2048)).any())
        first = torch.where(d.isnan(), float('inf'), d).argmin(dim=1)
        assert bool(((first >= 1024) & (first < 2048)).any())
    if name == 'ties_across_chunks':
        assert bool((out[0, :10] == 1023).all())


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
@pytest.mark.parametrize('name', ['probe', 'nan_last_partial', 'inf_refs',
                                  'nonfinite_queries',
                                  'ties_across_chunks', 'n2=1025'])
def test_metrics_match_xla(name, dtype):
    """``sided_distance`` (both ways), ``chamfer_distance`` and ``f_score``
    against ``kaolin_tpu``'s, NaN and inf outputs where they have them."""
    p1, p2 = (a.astype(dtype) for a in _scene(name))
    t1, t2 = _t(p1, p2)
    j1, j2 = _j(p1, p2)
    for a, b, ja, jb in ((t1, t2, j1, j2), (t2, t1, j2, j1)):
        dist, idx = kt.metrics.pointcloud.sided_distance(a, b)
        rd, ri = kal.metrics.pointcloud.sided_distance(ja, jb, backend='xla')
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
        np.testing.assert_allclose(dist.numpy(), np.asarray(rd),
                                   rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(
        kt.metrics.pointcloud.chamfer_distance(t1, t2).numpy(),
        np.asarray(kal.metrics.pointcloud.chamfer_distance(j1, j2)),
        rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(
        kt.metrics.pointcloud.f_score(t1, t2, radius=0.05).numpy(),
        np.asarray(kal.metrics.pointcloud.f_score(j1, j2, radius=0.05)),
        rtol=TOL[dtype], atol=TOL[dtype])


# ------------------------------------------- the card's design, written out

def _brute_card(p1, p2, S, L):
    """``nn_brute_kernel`` and ``nn_merge_kernel`` on S slices of L
    references, written out: (B, N1) int32."""
    B, N1, _ = p1.shape
    N2 = p2.shape[1]
    K = min(L, kn.CHUNK)
    inf = torch.tensor(float('inf'), dtype=p1.dtype)
    dist = torch.empty((B, N1, S), dtype=p1.dtype)
    index = torch.empty((B, N1, S), dtype=torch.int64)
    for s in range(S):
        s0, s1 = s * L, min((s + 1) * L, N2)
        best = torch.full((B, N1), float('inf'), dtype=p1.dtype)
        bi = torch.zeros((B, N1), dtype=torch.int64)
        flagged = torch.zeros(B, dtype=torch.bool)
        for base in range(s0, s1, K):
            refs = p2[:, base:min(base + K, s1)]
            n = refs.shape[1]
            # the block's flag over what it staged (per batch entry)
            nan = refs.isnan().any(dim=2).any(dim=1)
            flagged |= nan
            groups = -(-n // G)
            pad = inf.expand(B, groups * G - n, 3)
            d = kn._sq_dist(p1[:, :, None], torch.cat([refs, pad], 1)[:, None])
            d = d.reshape(B, N1, groups, G)
            m = kn._nan_amin(d, 3)             # the fminf fold
            grp = torch.full((B, N1), -1, dtype=torch.int64)
            live = ~nan[:, None]
            for k in range(groups):
                take = live & (m[..., k] < best)
                best = torch.where(take, m[..., k], best)
                grp = torch.where(take, k, grp)
            # the first reference of the last group that lowered a best
            moved = grp >= 0
            dg = torch.gather(d, 2, grp.clamp(min=0)[..., None, None]
                              .expand(B, N1, 1, G))[:, :, 0]
            g = (dg == best[..., None]).int().argmax(dim=-1)
            bi = torch.where(moved, base + grp * G + g, bi)
        marked = (flagged & (L < kn.CHUNK))[:, None]
        dist[..., s] = torch.where(marked, float('nan'), best)
        index[..., s] = torch.where(marked, 0, bi)
    if S == 1:
        return index[..., 0].to(torch.int32)
    # the merge: a chunk's GS slices are left out together if one is NaN,
    # then the least (distance, index)
    gs = kn.CHUNK // L if L < kn.CHUNK else 1
    groups = -(-S // gs)
    pad = groups * gs - S
    dpad = torch.cat([dist, inf.expand(B, N1, pad)], 2)
    ipad = torch.cat([index, torch.zeros((B, N1, pad), dtype=torch.int64)],
                     2)
    nan = dpad.isnan().reshape(B, N1, groups, gs).any(dim=3)
    nan = nan.repeat_interleave(gs, dim=2)
    dpad = torch.where(nan, inf, dpad)
    dmin = dpad.amin(dim=2, keepdim=True)
    return torch.where(dpad == dmin, ipad, torch.iinfo(torch.int64).max
                       ).amin(dim=2).to(torch.int32)


def _plans(B, N1, N2):
    """brute_plan's for 132 SMs, and every kind of slice forced."""
    plans = {kn.brute_plan(B, N1, N2, 132), (1, -(-N2 // 1024) * 1024)}
    for L in (32, 64, 256, 1024, 2048):
        if L < N2:
            plans.add((-(-N2 // L), L))
    return sorted(plans)


@pytest.mark.parametrize('name', SCENES)
def test_card_design_matches_plain(name):
    """The written-out kernel and merge give the plain version's indices
    bit for bit, with the host's plan and with every kind of slice."""
    p1, p2 = _t(*(a.astype(np.float32) for a in _scene(name)))
    ref = kn.nearest_idx_plain(p1, p2)
    for S, L in _plans(p1.shape[0], p1.shape[1], p2.shape[1]):
        assert torch.equal(_brute_card(p1, p2, S, L), ref), (S, L)


def test_card_design_random_clouds():
    """Random float32 clouds (no exact ties), B = 2, sizes no tile, slice
    or chunk divides."""
    rng = np.random.default_rng(22)
    p1, p2 = _t(rng.random((2, 600, 3)).astype(np.float32),
                rng.random((2, 2900, 3)).astype(np.float32))
    p2[1, 2000, 0] = float('nan')              # one entry's third chunk
    ref = kn.nearest_idx_plain(p1, p2)
    for S, L in _plans(2, 600, 2900):
        assert torch.equal(_brute_card(p1, p2, S, L), ref), (S, L)


@pytest.mark.parametrize('sms', [132, 114, 7])
def test_brute_plan_invariants(sms):
    """The slices cover the references exactly, each 1024-chunk lies in one
    slice or is whole slices, at most 64 slices, and one slice when the
    query tiles alone give every SM the same number of blocks, two or
    more."""
    rng = np.random.default_rng(23)
    shapes = [(1, 10_000, 10_000), (1, 2048, 2048), (1, 100_000, 100_000),
              (2, 3000, 20_000), (1, 1, 1), (8, 1, 5000), (1, 512, 1),
              (1, 10_000, 1_000_000)]
    shapes += [tuple(int(v) for v in rng.integers(1, 50_000, 3)) for _ in
               range(40)]
    shapes += [(1, kn.QB * sms * k, int(n2)) for k in (2, 3)
               for n2 in rng.integers(1, 300_000, 5)]
    for B, N1, N2 in shapes:
        S, L = kn.brute_plan(B, N1, N2, sms)
        assert 1 <= S <= 64 and S == -(-N2 // L)
        assert (S - 1) * L < N2 <= S * L          # cover [0, N2) exactly
        if L >= kn.CHUNK:
            assert L % kn.CHUNK == 0              # whole chunks a slice
        else:
            assert S > 1 and L >= 32 and kn.CHUNK % L == 0
        tiles = B * -(-N1 // kn.QB)
        if tiles % sms == 0 and tiles >= 2 * sms:
            assert S == 1, (B, N1, N2)
    # the sizes of the slice's path
    assert kn.brute_plan(1, 100_000, 100_000, 132) == (1, 100_352)
    assert kn.brute_plan(1, 10_000, 10_000, 132) == (40, 256)
    assert kn.brute_plan(1, 2048, 2048, 132) == (32, 64)
    assert kn.brute_plan(1, 5, 100_000, 132)[0] > 1


def test_constants_match_the_source():
    """The block, fold, chunk and slice sizes written out here and in the
    module are the CUDA source's."""
    src = CSRC.read_text()

    def const(name):
        return int(re.search(rf'constexpr int {name} = (\d+);', src).group(1))
    assert const('BT') * const('RQ') == kn.QB
    assert re.search(r'constexpr int QB = BT \* RQ;', src)
    assert const('G') == G
    assert const('CHUNK') == kn.CHUNK
    assert const('MIN_SLICE') == kn._MIN_SLICE
