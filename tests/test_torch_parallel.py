"""The port's ``parallel`` package on ``torch.distributed`` against
``kaolin_tpu`` on the CPU.

Worlds of CPU ranks (gloo, joined through a file in ``tmp_path``, so that
test workers never race for a port) run ``tests/torch_parallel_ranks.py``
under :func:`kaolin_tpu_torch.parallel.launch.run_ranks`, with a hard
deadline: a rank that fails or a world that outruns it ends the test with
the ranks' tracebacks, and no rank is left running. Both worlds start when
the module does, in threads, while this process builds the JAX references.
Each rank writes its blocks and gradients; the test gathers them here (CPU
copies, no gather collective).

Everything runs at float64, where the two packages agree to rounding:
``face_idx``, metric indices, ray and point ids exactly; features and
masks within rtol 1e-6, gradients within rtol 1e-5 (the sharded gradient
sums the ranks' partials in another order), metric values and their
gradients within ``tests/test_torch_metrics.py``'s 1e-10, depths within
``tests/test_torch_raytrace.py``'s. Every rank's gradient must equal the
one-process gradient, which shows that none is scaled by the world size.
"""

import concurrent.futures
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
import kaolin_tpu_torch as kt
from kaolin_tpu_torch.parallel import launch
from kaolin_tpu_torch.parallel.mesh import _layout

ROOT = Path(__file__).resolve().parents[1]
DEADLINE = 120.
TOL = 1e-10           # tests/test_torch_metrics.py at float64
DEPTH_RTOL = 1e-15    # tests/test_torch_raytrace.py at float64
RAY_FN_RTOL = 5e-15   # kaolin_tpu's ray_fn form against its array form


def _world(tmp, task, world):
    """Runs ``task`` on ``world`` ranks; returns each rank's arrays."""
    launch.run_ranks(world, [sys.executable, ranks.__file__, task,
                             str(tmp / 'init'), str(tmp)],
                     deadline=DEADLINE,
                     env={'PYTHONPATH': str(ROOT), 'OMP_NUM_THREADS': '1'})
    return [dict(np.load(tmp / f'{task}_{r}.npz')) for r in range(world)]


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One intra-op thread in this process, as in each rank: the port's
    CPU reductions then take one order, so its one-process and one-rank
    renders are the same bits whatever the other workers run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module', autouse=True)
def worlds(tmp_path_factory):
    """{world size: future of its ranks' arrays}: 4 ranks run everything,
    2 the metrics."""
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futures = {4: pool.submit(_world, tmp_path_factory.mktemp('w4'), 'all',
                              4),
               2: pool.submit(_world, tmp_path_factory.mktemp('w2'),
                              'metrics', 2)}
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope='module')
def jax_ref():
    import jax
    import jax.numpy as jnp
    import kaolin_tpu as kal
    return jax, jnp, kal


def _gather(blocks, data, pix):
    """The whole (B, H, ...) array from the ranks' blocks of a (data, pix)
    mesh of ranks 0..n-1, laid out row-major."""
    rows = [np.concatenate(blocks[d * pix:(d + 1) * pix], axis=1)
            for d in range(data)]
    return np.concatenate(rows, axis=0)


# ------------------------------------------------------------------- render

@pytest.fixture(scope='module')
def render_refs(jax_ref):
    """``kaolin_tpu``'s one-process DIB-R and rasterize (jitted: op by op
    the JAX path takes seconds)."""
    jax, jnp, kal = jax_ref
    args = [jnp.asarray(a) for a in ranks.render_inputs()]
    H, W = ranks.H, ranks.W
    dibr = jax.jit(lambda *a: kal.render.mesh.dibr_rasterization(
        H, W, *a, rast_backend='xla'))(*args)
    rast = jax.jit(lambda z, i, f, n: kal.render.mesh.rasterize(
        H, W, z, i, f, n >= 0., backend='xla'))(*args)
    return args, dibr, rast


@pytest.mark.parametrize('data,pix', ranks.MESHES)
def test_sharded_render_matches_kaolin_tpu(worlds, jax_ref, render_refs,
                                           data, pix):
    """The gathered blocks against ``kaolin_tpu``'s one-process render and
    against ``kaolin_tpu.parallel``'s sharded render on the same mesh of
    its CPU devices."""
    jax, jnp, kal = jax_ref
    (fvz, fvi, ff, fnz), ref, rref = render_refs
    outs = worlds[4].result()
    key = f'{data}x{pix}'
    H, W = ranks.H, ranks.W
    jmesh = kal.parallel.make_mesh(data=data, pix=pix,
                                   devices=jax.devices()[:data * pix])
    sharded = jax.jit(lambda *a: kal.parallel.sharded_dibr_rasterization(
        jmesh, H, W, *a, rast_backend='xla'))(fvz, fvi, ff, fnz)
    got = [_gather([o[f'{key}_{n}'] for o in outs], data, pix)
           for n in ('feat', 'mask', 'idx')]
    for r in (ref, sharded):
        np.testing.assert_array_equal(np.asarray(r[2]), got[2])
        for a, b in zip(r[:2], got[:2]):
            np.testing.assert_allclose(np.asarray(a), b, rtol=1e-6,
                                       atol=1e-9)
    assert (got[2] >= 0).mean() > 0.02

    rsh = jax.jit(lambda z, i, f, n: kal.parallel.sharded_rasterize(
        jmesh, H, W, z, i, f, n >= 0., backend='xla'))(fvz, fvi, ff, fnz)
    feat = np.concatenate([_gather([o[f'{key}_rfeat{n}'] for o in outs],
                                   data, pix) for n in ('', '2')], axis=-1)
    idx = _gather([o[f'{key}_ridx'] for o in outs], data, pix)
    for r in (rref, rsh):
        np.testing.assert_array_equal(np.asarray(r[1]), idx)
        np.testing.assert_allclose(np.asarray(r[0]), feat, rtol=1e-6,
                                   atol=1e-9)


@pytest.fixture(scope='module')
def render_grads(jax_ref):
    """``tests/test_parallel.py``'s loss and its gradients, one process."""
    jax, jnp, kal = jax_ref
    fvz, fvi, ff, fnz = (jnp.asarray(a) for a in ranks.render_inputs())
    H, W = ranks.H, ranks.W

    def loss(fvi_, ff_):
        feat, mask, _ = kal.render.mesh.dibr_rasterization(
            H, W, fvz, fvi_, ff_, fnz, rast_backend='xla')
        return jnp.sum(feat ** 2) * 1e-2 + kal.metrics.render.mask_iou(
            mask, jnp.full(mask.shape, 0.5))

    value, grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(fvi,
                                                                       ff)
    return float(value), [np.asarray(g) for g in grads]


@pytest.mark.parametrize('data,pix', ranks.MESHES)
def test_sharded_gradients_on_every_rank(worlds, render_grads, data, pix):
    value, (gvi, gff) = render_grads
    key = f'{data}x{pix}'
    assert np.abs(gvi).max() > 0 and np.abs(gff).max() > 0
    for out in worlds[4].result():
        np.testing.assert_allclose(out[f'{key}_loss'], value, rtol=1e-12)
        np.testing.assert_allclose(out[f'{key}_gvi'], gvi, rtol=1e-5,
                                   atol=1e-8)
        np.testing.assert_allclose(out[f'{key}_gff'], gff, rtol=1e-5,
                                   atol=1e-8)


def test_one_rank_mesh_is_the_plain_render():
    """A process that joined no group: ``make_mesh`` makes a group of one
    on a HashStore, and the 1x1 mesh goes through the sharded code, equal
    bit for bit to ``dibr_rasterization``, gradients too."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    try:
        mesh = kt.parallel.make_mesh()
        assert tuple(mesh.mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ('data', 'pix')
        fvz, fvi, ff, fnz = (torch.tensor(a[:1])
                             for a in ranks.render_inputs())
        outs = []
        for fn in (kt.render.mesh.dibr_rasterization,
                   lambda *a: kt.parallel.sharded_dibr_rasterization(mesh,
                                                                     *a)):
            v, f = fvi.clone().requires_grad_(), ff.clone().requires_grad_()
            feat, mask, idx = fn(ranks.H, ranks.W, fvz, v, f, fnz)
            ((feat ** 2).sum() + mask.sum()).backward()
            outs.append((feat, mask, idx, v.grad, f.grad))
        for a, b in zip(*outs):
            assert torch.equal(a, b)
        assert kt.parallel.init_distributed() == (0, 1)
        assert not kt.parallel.is_distributed()
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ metrics

@pytest.fixture(scope='module')
def metric_refs(jax_ref):
    """{metric: (values, gradients of their sum)} of ``kaolin_tpu``'s one
    process."""
    jax, jnp, kal = jax_ref
    p1, p2, fv = (jnp.asarray(a) for a in ranks.metric_inputs())
    pc, tm = kal.metrics.pointcloud, kal.metrics.trianglemesh
    fns = {'sided': (pc.sided_distance, p2),
           'chamfer': (lambda a, b: (pc.chamfer_distance(a, b),), p2),
           'p2m': (lambda a, b: tm.point_to_mesh_distance(a, b,
                                                          backend='xla'), fv)}
    refs = {}
    for name, (fn, other) in fns.items():
        def loss(a, b, fn=fn):
            out = fn(a, b)
            return out[0].sum(), out
        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p1, other)
        refs[name] = out, grads
    return refs


def _split(outs, name):
    """The (B, N) array from the ranks' slices along N."""
    return np.concatenate([o[name] for o in outs], axis=1)


@pytest.mark.parametrize('world', [2, 4])
def test_sharded_metrics_on_every_rank(worlds, metric_refs, world):
    outs = worlds[world].result()
    (d, i), gs = metric_refs['sided']
    np.testing.assert_allclose(_split(outs, 'sided_dist'), np.asarray(d),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(_split(outs, 'sided_idx'), np.asarray(i))
    (c,), gc = metric_refs['chamfer']
    (dm, im, tm), gm = metric_refs['p2m']
    np.testing.assert_allclose(_split(outs, 'p2m_dist'), np.asarray(dm),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(_split(outs, 'p2m_idx'), np.asarray(im))
    np.testing.assert_array_equal(_split(outs, 'p2m_type'), np.asarray(tm))
    for out in outs:
        np.testing.assert_allclose(out['chamfer'], np.asarray(c), rtol=TOL,
                                   atol=TOL)
        for name, ref in (('sided_g', gs), ('chamfer_g', gc)):
            for k, r in zip('12', ref):
                np.testing.assert_allclose(out[name + k], np.asarray(r),
                                           rtol=TOL, atol=TOL)
        for k, r in zip('pf', gm):
            np.testing.assert_allclose(out['p2m_g' + k], np.asarray(r),
                                       rtol=TOL, atol=TOL)


# ----------------------------------------------------------------- raytrace

@pytest.fixture(scope='module')
def shard_trace(worlds, jax_ref):
    """``kaolin_tpu``'s trace of one shard's rays (jitted once: the four
    shards have one shape), with its level counts, through the octree the
    ranks built (``tests/test_torch_spc.py`` holds the port's octree
    builds against ``kaolin_tpu``'s)."""
    jax, jnp, kal = jax_ref
    out = worlds[4].result()[0]
    spc = [jnp.asarray(out[k]) for k in ('octree', 'ph', 'exsum')]
    return jax.jit(lambda o, d: kal.render.spc.unbatched_raytrace_fixed(
        *spc, o, d, ranks.LEVEL, ranks.CAP, return_level_counts=True))


def _check_shards(outs, prefix, o, d, trace, rtol):
    """Each rank's trace against ``kaolin_tpu``'s of its slice of the rays
    (o, d); returns the level counts of each shard."""
    per = o.shape[0] // len(outs)
    counts = []
    for s, out in enumerate(outs):
        sl = slice(s * per, (s + 1) * per)
        ridx, pidx, depth, count, levels = trace(o[sl], d[sl])
        counts.append(np.asarray(levels))
        c = int(out[prefix + 'count'][0])
        assert out[prefix + 'count'].shape == (1,)
        assert c == int(count) > 0
        np.testing.assert_array_equal(out[prefix + 'ridx'][:c],
                                      np.asarray(ridx)[:c])
        np.testing.assert_array_equal(out[prefix + 'pidx'][:c],
                                      np.asarray(pidx)[:c])
        assert (out[prefix + 'ridx'][c:] == -1).all()
        np.testing.assert_allclose(out[prefix + 'depth'][:c],
                                   np.asarray(depth)[:c], rtol=rtol, atol=0)
    return counts


def test_sharded_raytrace_matches_kaolin_tpu(worlds, jax_ref, shard_trace):
    """The ray-split trace (array form) against ``kaolin_tpu``'s trace of
    each rank's slice of the same rays."""
    jax, jnp, kal = jax_ref
    outs = worlds[4].result()
    for out in outs:
        assert out['ridx'].shape == (ranks.CAP,)
    _check_shards(outs, '', jnp.asarray(outs[0]['origin']),
                  jnp.asarray(outs[0]['direction']), shard_trace, DEPTH_RTOL)


def test_sharded_raytrace_ray_fn_planned_caps(worlds, jax_ref, shard_trace):
    """``ray_fn`` offset by each rank's first ray, with
    ``plan_sharded_raytrace``'s sizes: each rank against ``kaolin_tpu``'s
    trace of its slice of the rows of its own ``primary_rays_fn``; the
    plan against the shards' level counts (``kaolin_tpu``'s rule: each
    level's largest count times 1.25, rounded up to 1024)."""
    jax, jnp, kal = jax_ref
    outs = worlds[4].result()
    cam, n = ranks.CAMERA, ranks.RAY_RES
    jfn = kal.render.spc.primary_rays_fn(
        n, n, *(jnp.asarray(v, jnp.float64) for v in cam[:3]), cam[3],
        jnp.float64)
    o, d = jfn(jnp.arange(n * n, dtype=jnp.int32))
    counts = _check_shards(outs, 'fn_', o, d, shard_trace, RAY_FN_RTOL)
    sched = tuple(-(-int(max(c) * 1.25) // 1024) * 1024
                  for c in zip(*counts))
    for out in outs:
        assert tuple(out['fn_sched']) == sched
        assert int(out['fn_cap']) == max(max(sched), n * n // 4)
        assert out['fn_ridx'].shape == (int(out['fn_cap']),)


# ------------------------------------------------------ launcher, runtime

def test_failing_rank_fails_the_world_within_the_deadline(tmp_path):
    """Rank 1 raises before a collective that rank 0 waits in: the
    launcher kills rank 0 and raises with rank 1's traceback, well within
    the deadline."""
    start = time.monotonic()
    with pytest.raises(launch.RankError) as err:
        _world(tmp_path, 'fail', 2)
    assert time.monotonic() - start < DEADLINE / 2
    text = str(err.value)
    assert 'rank 1 exited with code 1' in text
    assert 'RuntimeError: rank 1 fails before the collective' in text
    assert '--- rank 0 (killed)' in text


def test_deadline_kills_a_hanging_world(tmp_path):
    """A world that outruns its deadline is killed and reported."""
    start = time.monotonic()
    with pytest.raises(launch.RankError, match='deadline of 1 s passed'):
        launch.run_ranks(2, [sys.executable, '-c',
                             'import time; time.sleep(60)'], deadline=1.)
    assert time.monotonic() - start < 10.


def test_init_distributed_single_process_noop(monkeypatch):
    for var in ('MASTER_ADDR', 'WORLD_SIZE', 'RANK', 'LOCAL_RANK',
                'SLURM_NTASKS', 'OMPI_COMM_WORLD_SIZE'):
        monkeypatch.delenv(var, raising=False)
    assert kt.parallel.init_distributed() == (0, 1)
    assert not kt.parallel.is_distributed()
    assert kt.parallel.init_distributed() == (0, 1)
    monkeypatch.setenv('SLURM_NTASKS', '4')
    with pytest.raises(ValueError, match='MASTER_ADDR'):
        kt.parallel.init_distributed()


def test_make_mesh_multiprocess_layout():
    """``tests/test_parallel.py``'s layout on ranks: 2 hosts x 4 ranks
    give data = hosts, pix = a host's ranks; a 'pix' row never crosses a
    host; a pix that would is refused; a shuffled list lands host-major."""
    layout = _layout(None, None, range(8), 4)
    assert layout.shape == (2, 4)
    for row in layout:
        assert len({r // 4 for r in row}) == 1
    with pytest.raises(ValueError):
        _layout(1, 8, range(8), 4)
    layout = _layout(4, 2, list(range(8))[::-1], 4)
    for row in layout:
        assert len({r // 4 for r in row}) == 1
    assert _layout(None, None, range(4), 4).shape == (4, 1)
    assert _layout(None, 2, range(4), 4).shape == (2, 2)


def test_exports_match_kaolin_tpu_but_partition_spec():
    import kaolin_tpu.parallel as jp
    names = {n for n in vars(jp) if not n.startswith('_')}
    port = {n for n in vars(kt.parallel) if not n.startswith('_')}
    assert names - port == {'P'}
    assert port - names == {'launch'} or port - names == set()
