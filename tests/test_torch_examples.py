"""The port's applications (``kaolin_tpu_torch/examples/``) against the JAX
examples (``examples/``) on the CPU.

- Every public name of ``examples/*.py`` (and every function of a recipe)
  has its counterpart with the same parameters, plus ``device``, whose
  default is 'cuda'; each entry point raises without a card.
- ``nglod_train.main(level=3, steps=5, render_res=8)``: the same numpy
  data and zero features, so the loss history is held to the JAX one
  (1e-4 relative) and the depth image in its ``+inf`` pattern (equal) and
  values (1e-5 abs).
- ``dibr_train.main(steps=3, res=32, num_views=2)``: the loss history
  within 1e-4 relative; the final Chamfer samples with another generator,
  so it is only finite.
- DMTet: ``decoder_apply`` on the JAX example's weights carried over
  (1e-5), ``laplace_regularizer`` plain and masked (1e-6 relative), one
  step's loss (1e-5 relative) and gradient (1e-4 of its largest entry)
  fed the same surface samples, the global-norm clip against
  ``optax.clip_by_global_norm`` (1e-6 relative); in float64 from the JAX
  example's weights and draws, ``pre_train_sphere`` (100 steps; the loss
  1e-6 relative, the weights 1e-6 of their largest), then 10 training
  steps at grid 32 and the example's lr 1e-3 (the loss history 1e-4
  relative); and the JAX torus convergence test on the port (grid 14,
  150 iterations, 1,000 samples of 1,500 points).
- ``emulate_training_timelapse`` on an OBJ: its files are read by
  ``kaolin_tpu.io.usd``, and its meshes and grids equal the JAX
  example's.
"""

import ast
import functools
import importlib
import inspect
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kaolin_tpu as kal
from kaolin_tpu.ops.conversions.tetmesh import (
    marching_tetrahedra_fixed as jax_mt_fixed, tet_grid as jax_tet_grid)
from kaolin_tpu_torch.examples import (dibr_train, dmtet_train, fish,
                                       nglod_train, renderer, utils,
                                       visualize_main)

ROOT = Path(__file__).resolve().parents[1]
MODULES = ('utils', 'spline', 'spline_mesh', 'renderer', 'fish',
           'dibr_train', 'nglod_train', 'dmtet_train', 'visualize_main')
RECIPES = sorted(p.relative_to(ROOT / 'examples' / 'recipes')
                 for p in (ROOT / 'examples' / 'recipes').glob('*/*.py'))


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------- signatures

def _public(mod):
    names = getattr(mod, '__all__', None)
    if names is None:
        names = [n for n, o in vars(mod).items()
                 if not n.startswith('_')
                 and getattr(o, '__module__', None) == mod.__name__
                 and (inspect.isroutine(o) or isinstance(o, type))]
    return names


def _routines(obj, path):
    if isinstance(obj, type):
        for meth in ('__init__', *(m for m in vars(obj)
                                   if not m.startswith('_'))):
            fn = getattr(obj, meth)
            if inspect.isroutine(fn):
                yield f'{path}.{meth}', fn
    elif inspect.isroutine(obj):
        yield path, obj


def _check(path, port_params, ref_params, port_defaults):
    got = [p for p in port_params if p != 'device']
    assert got == ref_params, (path, port_params, ref_params)
    if 'device' in port_params:
        assert port_defaults['device'] == 'cuda', path


@pytest.mark.parametrize('name', MODULES)
def test_public_names_and_signatures(name):
    jmod = importlib.import_module(f'examples.{name}')
    tmod = importlib.import_module(f'kaolin_tpu_torch.examples.{name}')
    names = _public(jmod)
    assert names, name
    for n in names:
        assert hasattr(tmod, n), f'{name}.{n} has no counterpart'
        ports = dict(_routines(getattr(tmod, n), n))
        for path, jfn in _routines(getattr(jmod, n), n):
            sig = inspect.signature(ports[path])
            _check(f'{name}.{path}', list(sig.parameters),
                   list(inspect.signature(jfn).parameters),
                   {k: v.default for k, v in sig.parameters.items()})


def _ast_functions(path):
    """The functions a file defines, at any depth (a recipe's script-level
    helpers live in its ``main``)."""
    tree = ast.parse(Path(path).read_text())
    return {n.name: n for n in ast.walk(tree)
            if isinstance(n, ast.FunctionDef)}


def test_recipes_counterparts_and_signatures():
    assert len(RECIPES) == 16     # camera 9, spc 4, dataload 1, preprocess 2
    port_root = ROOT / 'kaolin_tpu_torch' / 'examples' / 'recipes'
    assert sorted(p.relative_to(port_root) for p in port_root.glob('*/*.py')
                  if p.name != '__init__.py') == RECIPES
    for rel in RECIPES:
        ref = _ast_functions(ROOT / 'examples' / 'recipes' / rel)
        port = _ast_functions(port_root / rel)
        assert 'main' in port, rel
        for name, node in ref.items():
            assert name in port, (rel, name)
            pnode = port[name]
            defaults = dict(zip([a.arg for a in pnode.args.args][
                len(pnode.args.args) - len(pnode.args.defaults):],
                [ast.literal_eval(d) if isinstance(d, ast.Constant)
                 else None for d in pnode.args.defaults]))
            _check(f'{rel}:{name}', [a.arg for a in pnode.args.args],
                   [a.arg for a in node.args.args], defaults)


ENTRY_POINTS = {
    'fish.fit_fish': lambda: fish.fit_fish({}, {}),
    'fish.make_body_params': lambda: fish.make_body_params(3),
    'fish.synthetic_self_fit': lambda: fish.synthetic_self_fit(),
    'fish.fish_params_from_json': lambda: fish.fish_params_from_json('x'),
    'dibr_train.main': lambda: dibr_train.main(),
    'dibr_train.make_cameras': lambda: dibr_train.make_cameras(2),
    'nglod_train.main': lambda: nglod_train.main(),
    'dmtet_train.train_dmtet': lambda: dmtet_train.train_dmtet(
        np.zeros((4, 3))),
    'dmtet_train.init_decoder': lambda: dmtet_train.init_decoder(
        torch.Generator()),
    'visualize_main.emulate_training_timelapse':
        lambda: visualize_main.emulate_training_timelapse(['x'], 'y'),
    'utils.load_synthetic_views': lambda: utils.load_synthetic_views('x'),
    'renderer.TexturedMesh.from_obj':
        lambda: renderer.TexturedMesh.from_obj('x'),
}


@pytest.mark.parametrize('name', sorted(ENTRY_POINTS))
def test_entry_points_raise_without_card(name):
    if torch.cuda.is_available():
        pytest.skip('a card is visible: the entry points run on it')
    with pytest.raises(RuntimeError, match='no CUDA card is visible'):
        ENTRY_POINTS[name]()


# ------------------------------------------------------------------ NGLOD

def test_nglod_history_and_depth_match_jax():
    from examples import nglod_train as jnglod
    jl, jd = jnglod.main(level=3, steps=5, render_res=8)
    tl, td = nglod_train.main(level=3, steps=5, render_res=8, device='cpu')
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-4)
    jd = np.asarray(jd)
    assert td.shape == jd.shape == (8, 8)
    np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
    assert np.isfinite(td).any() and not np.isfinite(td).all()
    fin = np.isfinite(jd)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=0, atol=1e-5)


# ------------------------------------------------------------------ DIB-R

def test_dibr_history_matches_jax():
    from examples import dibr_train as jdibr
    jl, jcd = jdibr.main(steps=3, res=32, num_views=2)
    tl, tcd = dibr_train.main(steps=3, res=32, num_views=2, device='cpu')
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-4)
    assert np.isfinite(tcd) and np.isfinite(jcd)


# ------------------------------------------------------------------ DMTet

def _jax_decoder(seed=0, multires=2):
    from examples import dmtet_train as jdmtet
    params = jdmtet.init_decoder(jax.random.PRNGKey(seed), multires)
    return jdmtet, params, dmtet_train.decoder_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), multires, device='cpu')


def test_decoder_apply_carried_weights():
    jdmtet, jp, tp = _jax_decoder()
    x = np.random.default_rng(0).uniform(-0.5, 0.5, (50, 3)).astype(
        np.float32)
    ref = np.asarray(jax.jit(jdmtet.decoder_apply)(jp, jnp.asarray(x)))
    with torch.no_grad():
        out = dmtet_train.decoder_apply(tp, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    assert out.shape == (50, 4)


@pytest.mark.parametrize('masked', [False, True])
def test_laplace_regularizer_matches(masked):
    from examples import dmtet_train as jdmtet
    rng = np.random.default_rng(1)
    verts = rng.standard_normal((40, 3)).astype(np.float32)
    faces = rng.integers(0, 40, (70, 3)).astype(np.int32)
    mask = rng.random(70) > 0.3 if masked else np.ones(70, bool)
    ref = float(jdmtet.laplace_regularizer(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(mask)))
    out = float(dmtet_train.laplace_regularizer(
        torch.as_tensor(verts), torch.as_tensor(faces),
        torch.as_tensor(mask)))
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    if masked:
        # a masked face counts as a dropped one
        only = float(dmtet_train.laplace_regularizer(
            torch.as_tensor(verts), torch.as_tensor(faces[mask]),
            torch.ones(int(mask.sum()), dtype=torch.bool)))
        np.testing.assert_allclose(out, only, rtol=1e-6)


def _jax_uniforms(key, num_samples, dtype, port_dtype=np.float32):
    """``kal.ops.mesh.sample_points``' three draws from ``key``, in the
    vertices' dtype as it draws them, in ``port_dtype`` for the port."""
    k_face, k_bary = jax.random.split(key)
    k1, k2 = jax.random.split(k_bary)
    return tuple(torch.tensor(np.asarray(x, port_dtype)) for x in (
        jax.random.uniform(k_face, (1, num_samples), dtype),
        jax.random.uniform(k1, (1, num_samples, 1), dtype),
        jax.random.uniform(k2, (1, num_samples, 1), dtype)))


def test_dmtet_step_loss_and_gradient_match():
    """One step of the JAX example's loss, built from its public functions,
    against ``dmtet_loss`` on the same weights and surface samples."""
    grid, n, lap_w = 8, 600, 0.1
    jdmtet, jp, tp = _jax_decoder(seed=3)
    pts = dmtet_train.torus_points(800, seed=2).astype(np.float32)
    tv_np, tets = jax_tet_grid(grid)
    tv = jnp.asarray(tv_np)
    key = jax.random.PRNGKey(5)

    def jsurface(params):
        out = jdmtet.decoder_apply(params, tv, 2)
        deformed = tv + jnp.tanh(out[:, 1:]) / grid
        return jax_mt_fixed(deformed, tets, out[:, 0])

    def jloss(params):
        verts, _, faces, fmask, _ = jsurface(params)
        areas = kal.ops.mesh.face_areas(verts[None], faces)[0]
        areas = jnp.where(fmask, areas, 0.)
        pred, _ = kal.ops.mesh.sample_points(
            verts[None], faces, n, areas=areas[None], key=key)
        return (kal.metrics.pointcloud.chamfer_distance(
            pred, jnp.asarray(pts)[None]).mean()
            + jdmtet.laplace_regularizer(verts, faces, fmask) * lap_w)

    ref, g = jax.jit(jax.value_and_grad(jloss))(jp)
    # the suite runs JAX with float64 enabled: its surface, and so its
    # draws, are float64 there
    dtype = jax.eval_shape(jsurface, jp)[0].dtype
    loss = dmtet_train.dmtet_loss(
        tp, torch.as_tensor(tv_np), tets, torch.as_tensor(pts)[None],
        _jax_uniforms(key, n, dtype), grid, 2, n, lap_w, lap_on=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    for layer, gw in zip(tp.layers, g['w']):
        gw = np.asarray(gw)
        np.testing.assert_allclose(layer.weight.grad.numpy().T, gw, rtol=0,
                                   atol=1e-4 * np.abs(gw).max())


@pytest.mark.parametrize('scale', [0.1, 10.])
def test_clip_matches_optax(scale):
    rng = np.random.default_rng(4)
    grads = [rng.standard_normal(s).astype(np.float32) * scale
             for s in ((5, 7), (7,), (3, 2, 2))]
    ref, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], None)
    params = [torch.zeros(g.shape, requires_grad=True) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.as_tensor(g.copy())
    norm = dmtet_train.clip_by_global_norm_(params, 1.0)
    np.testing.assert_allclose(float(norm), np.sqrt(sum(
        (g.astype(np.float64) ** 2).sum() for g in grads)), rtol=1e-6)
    for p, r in zip(params, ref):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)


# float64 runs of the JAX example's steps from its own weights and draws:
# at lr 1e-3 on grid 32 a step can move the surface so far that float32's
# rounding, grown by Adam's first steps (lr * g / |g|), decides within a
# few steps whether it survives, in either package; in float64 from the
# same weights the two histories keep to each other
DMTET_SEED, DMTET_PRE_STEPS = 0, 100


@pytest.fixture(scope='module')
def jax_pretrained():
    """``train_dmtet``'s keys for seed 0, the JAX example's initial decoder
    (float32 values) in float64, its ``pre_train_sphere`` draws and the
    decoder it pre-trains from them (float64)."""
    from examples import dmtet_train as jdmtet
    key, k1, k2 = jax.random.split(jax.random.PRNGKey(DMTET_SEED), 3)
    init = jax.tree_util.tree_map(lambda w: jnp.asarray(w, jnp.float64),
                                  jdmtet.init_decoder(k1))
    draws = [np.asarray(jax.random.uniform(k, (1024, 3), jnp.float32))
             for k in jax.random.split(k2, DMTET_PRE_STEPS)]
    params, loss = jdmtet.pre_train_sphere(init, k2, steps=DMTET_PRE_STEPS)
    return key, init, draws, params, loss


def test_pre_train_sphere_matches_jax(jax_pretrained, monkeypatch):
    _, init, draws, ref, ref_loss = jax_pretrained
    feed = iter(draws)

    def jax_draw(generator, shape, device, dtype=torch.float32):
        draw = next(feed)
        assert draw.shape == tuple(shape)
        return torch.tensor(draw, device=device)

    monkeypatch.setattr(utils, 'uniform', jax_draw)
    dec = dmtet_train.decoder_from_numpy(
        jax.tree_util.tree_map(np.asarray, init), device='cpu')
    assert dec.layers[0].weight.dtype == torch.float64
    dec, loss = dmtet_train.pre_train_sphere(dec, torch.Generator(),
                                             steps=DMTET_PRE_STEPS)
    assert next(feed, None) is None
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-6)
    for layer, w in zip(dec.layers, ref['w']):
        w = np.asarray(w)
        np.testing.assert_allclose(layer.weight.detach().numpy().T, w,
                                   rtol=0, atol=1e-6 * np.abs(w).max())


def test_dmtet_history_matches_jax_at_lr_1e3(jax_pretrained):
    """``train_dmtet``'s loop on both sides at grid 32 and the example's
    default lr 1e-3: the JAX step as ``examples/dmtet_train.py`` builds it
    (the example's public functions, its clip and Adam schedule), the
    port's ``dmtet_step``; the same pre-trained weights and surface draws
    (1,000 samples against 2,000 torus points), the laplacian on after
    the half-way point. Both keep the surface through a spike (0.022 ->
    0.17 -> 0.013); the histories agree to 2e-7 here (1e-4 held)."""
    from examples import dmtet_train as jdmtet
    key, _, _, params, _ = jax_pretrained
    grid, n, lr, iterations = 32, 1000, 1e-3, 10
    pts = dmtet_train.torus_points(2000)
    pts = ((pts - (pts.max(0) + pts.min(0)) / 2)
           / (pts.max(0) - pts.min(0)).max() * 0.9)
    tv_np, tets = jax_tet_grid(grid)
    tv, target = jnp.asarray(tv_np, jnp.float64), jnp.asarray(pts)[None]

    def jloss(params, k, lap_on):
        out = jdmtet.decoder_apply(params, tv, 2)
        deformed = tv + jnp.tanh(out[:, 1:]) / grid
        verts, _, faces, fmask, _ = jax_mt_fixed(deformed, tets, out[:, 0])
        areas = jnp.where(fmask, kal.ops.mesh.face_areas(
            verts[None], faces)[0], 0.)
        pred, _ = kal.ops.mesh.sample_points(
            verts[None], faces, n, areas=areas[None], key=k)
        loss = kal.metrics.pointcloud.chamfer_distance(pred, target).mean()
        if lap_on:
            loss += jdmtet.laplace_regularizer(verts, faces, fmask) * 0.1
        return loss

    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adam(lambda it: lr * 10. ** (-it * 2e-4)))

    @functools.partial(jax.jit, static_argnames=('lap_on',))
    def jstep(params, state, k, lap_on):
        loss, g = jax.value_and_grad(jloss)(params, k, lap_on)
        upd, state = opt.update(g, state)
        return optax.apply_updates(params, upd), state, loss

    dec = dmtet_train.decoder_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device='cpu')
    topt, sched = dmtet_train.dmtet_optimizer(dec, lr)
    topo = dmtet_train.tet_topology(tets, 'cpu')
    ttv, ttarget = torch.as_tensor(tv_np, dtype=torch.float64), \
        torch.as_tensor(pts)[None]
    state, ref, got = opt.init(params), [], []
    for it, k in enumerate(jax.random.split(key, iterations)):
        lap_on = it > iterations // 2
        params, state, loss = jstep(params, state, k, lap_on=lap_on)
        ref.append(float(loss))
        got.append(float(dmtet_train.dmtet_step(
            dec, topt, sched, ttv, topo, ttarget,
            _jax_uniforms(k, n, jnp.float64, np.float64), grid, 2, n,
            lap_on=lap_on)))
    assert max(ref) > 5 * ref[0] and ref[-1] < ref[0], ref
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_train_dmtet_torus_converges():
    """``tests/test_dmtet_example.py``'s convergence test, on the port,
    with 1,000 samples of 1,500 points (there: 3,000 of 4,000)."""
    rng = np.random.default_rng(0)
    u, v = rng.uniform(0, 2 * np.pi, (2, 1500))
    pts = np.stack([(0.35 + 0.15 * np.cos(v)) * np.cos(u),
                    (0.35 + 0.15 * np.cos(v)) * np.sin(u),
                    0.15 * np.sin(v)], -1)
    params, hist = dmtet_train.train_dmtet(
        pts, grid_res=14, iterations=150, num_samples=1000, seed=1,
        lr=3e-4, device='cpu')
    assert np.isfinite(hist).all()
    start = np.mean(hist[:5])
    end = np.mean(hist[-5:])
    assert end < start * 0.1, f'{start} -> {end}'
    tv, tets = jax_tet_grid(14)
    with torch.no_grad():
        out = dmtet_train.decoder_apply(params, torch.as_tensor(tv))
    _, _, _, fmask, _ = dmtet_train.marching_tetrahedra_fixed(
        torch.as_tensor(tv), tets, out[:, 0])
    assert int(fmask.sum()) > 100


# -------------------------------------------------------------- Timelapse

@pytest.fixture
def tetra_obj(tmp_path):
    obj = tmp_path / 'tetra.obj'
    obj.write_text('v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n'
                   'f 1 2 3\nf 1 2 4\nf 1 3 4\nf 2 3 4\n')
    return str(obj)


def test_emulate_training_timelapse_read_by_kaolin_tpu(tetra_obj, tmp_path):
    from examples import visualize_main as jvis
    usd = kal.io.usd
    logs = {}
    for side in ('port', 'jax'):
        out = tmp_path / side
        out.mkdir()
        if side == 'port':
            visualize_main.emulate_training_timelapse(
                [tetra_obj], str(out), iterations=21,
                checkpoint_interval=10, voxel_res=8, device='cpu')
        else:
            jvis.emulate_training_timelapse([tetra_obj], str(out),
                                            iterations=21,
                                            checkpoint_interval=10,
                                            voxel_res=8)
        logs[side] = out
    names = sorted(os.listdir(logs['port']))
    assert names == sorted(os.listdir(logs['jax'])) == [
        'ground_truth', 'input', 'output']
    for t in (0, 10, 20):
        meshes = {s: usd.import_mesh(str(logs[s] / 'output' / 'mesh_0.usda'),
                                     time=t) for s in logs}
        np.testing.assert_allclose(np.asarray(meshes['port'].vertices),
                                   np.asarray(meshes['jax'].vertices),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(meshes['port'].faces),
                                      np.asarray(meshes['jax'].faces))
        grids = {s: np.asarray(usd.import_voxelgrid(
            str(logs[s] / 'output' / 'voxelgrid_0.usda'), time=t))
            for s in logs}
        np.testing.assert_array_equal(grids['port'], grids['jax'])
        assert grids['port'].any()
        clouds = {s: np.asarray(usd.import_pointcloud(
            str(logs[s] / 'output' / 'pointcloud_0.usda'), time=t)[0])
            for s in logs}
        assert clouds['port'].shape == clouds['jax'].shape
        assert np.isfinite(clouds['port']).all()
    gt = usd.import_mesh(str(logs['port'] / 'ground_truth' / 'mesh_0.usda'))
    last = usd.import_mesh(str(logs['port'] / 'output' / 'mesh_0.usda'),
                           time=20)
    # the emulated outputs converge onto the ground truth at the end
    np.testing.assert_allclose(np.asarray(last.vertices),
                               np.asarray(gt.vertices), atol=1e-6)
