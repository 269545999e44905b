"""The port's fish photo fit (``kaolin_tpu_torch.examples.fish``) against
the JAX example (``examples/fish.py``) on the CPU.

The same parameters, made by the JAX example's constructors and moved
over as numpy arrays (``fish.params_from_numpy``), go through both sides:
the card topology is equal; the body and fin vertices, ``position_by_uv``,
the spline losses and ``_project_points`` agree within 1e-5 abs,
``_render_soft_mask`` within 2e-5 (``tests/test_torch_dibr.py``'s float32
tolerance for the soft mask); a short ``fit_fish`` (lod 12 x 6, 32², texture 16; 3 / 2
/ 2 epochs) on the same data gives a loss history within 1e-3 relative of
the JAX one; and the JSON files are read across both ways. The JAX side
runs under this suite's float64 setting (its float32 parameters meet
float64 knots), so parity holds to float32's rounding, not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples import fish as jfish
from kaolin_tpu_torch.examples import fish as tfish

LOD_X, LOD_Y, RES = 12, 6, 32
META = {'cam_elev': 90., 'cam_azim': 0., 'cam_radius': 3.,
        'cam_look_at_height': 0., 'cam_fovyangle': 50., 'sigmainv': 7000}
TOL = 1e-5            # abs, geometry, losses and projections
# abs, the float32 soft mask on the same vertices: the tolerance
# tests/test_torch_dibr.py holds dibr_rasterization's to (XLA fuses the
# products of the distance into multiply-adds; sigmainv 7000 magnifies
# the difference)
MASK_TOL = 2e-5
HIST_RTOL = 1e-3      # relative, each step of the short fit's history


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return tfish.params_from_numpy(_np(tree), device='cpu')


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=tol)


def _random_body(rng, key_size=4):
    body = jfish.make_body_params(key_size, init_height=0.4)
    body['origin_xy'] = jnp.asarray(rng.uniform(-1, -0.5, 2), jnp.float32)
    body['length_x'] = jnp.asarray(rng.uniform(1.2, 1.8), jnp.float32)
    for name in ('top_spline', 'bottom_spline'):
        body[name] = {
            'key_ys': jnp.asarray(rng.uniform(0.2, 0.6, key_size),
                                  jnp.float32),
            'key_ts': jnp.asarray(rng.uniform(-0.5, 0.5, key_size),
                                  jnp.float32)}
    return body


def _random_fin(rng, key_size=4):
    fin = jfish.make_fin_params(key_size, start_uv=(0.2, 1.),
                                end_uv=(0.8, 1.), init_height=0.3)
    fin['start_uv'] = jnp.asarray(rng.uniform(0.1, 0.4, 2), jnp.float32)
    fin['end_uv'] = jnp.asarray(rng.uniform(0.6, 0.9, 2), jnp.float32)
    fin['start_dir'] = jnp.asarray(rng.uniform(-0.3, 0.3, 1), jnp.float32)
    fin['end_dir'] = jnp.asarray(rng.uniform(-0.3, 0.3, 1), jnp.float32)
    fin['sil_spline']['key_ys'] = jnp.asarray(rng.uniform(0.1, 0.4, key_size),
                                              jnp.float32)
    fin['sil_spline']['key_ts'] = jnp.asarray(
        rng.uniform(-0.3, 0.3, key_size), jnp.float32)
    return fin


# the JAX functions compiled whole (op by op, each primitive compiles)
_jbody_verts = jax.jit(lambda p: jfish.fish_body_vertices(p, LOD_X, LOD_Y))
_jpos = jax.jit(lambda v, uv: jfish.position_by_uv(v, LOD_X, LOD_Y, uv))
_jfin_verts = jax.jit(lambda p, bv, z: jfish.fish_fin_vertices(
    p, bv, (LOD_X, LOD_Y), LOD_X, LOD_Y, z))


@pytest.mark.parametrize('lod', [(3, 2), (5, 4), (12, 6), (40, 10)])
def test_card_topology_equal(lod):
    for port, ref in zip(tfish.card_topology(*lod), jfish.card_topology(*lod)):
        np.testing.assert_array_equal(port, ref)
        assert port.dtype == ref.dtype


@pytest.mark.parametrize('seed', [0, 1])
def test_body_fin_vertices_and_uv_positions(seed):
    rng = np.random.default_rng(seed)
    jbody, jfin = _random_body(rng), _random_fin(rng)
    tbody, tfin = _t(jbody), _t(jfin)
    jbv = _jbody_verts(jbody)
    tbv = tfish.fish_body_vertices(tbody, LOD_X, LOD_Y)
    _close(tbv, jbv)
    uvs = rng.uniform(0, 1, (9, 2)).astype(np.float32)
    _close(tfish.position_by_uv(tbv, LOD_X, LOD_Y, torch.as_tensor(uvs)),
           _jpos(jbv, jnp.asarray(uvs)))
    for z_scale in (0., 0.5):
        _close(tfish.fish_fin_vertices(tfin, tbv, (LOD_X, LOD_Y), LOD_X,
                                       LOD_Y, z_scale),
               _jfin_verts(jfin, jbv, z_scale))


def test_spline_and_uv_losses():
    rng = np.random.default_rng(3)
    jfin = _random_fin(rng)
    jfin['start_uv'] = jnp.asarray([1.5, -0.2], jnp.float32)
    jfin['end_uv'] = jnp.asarray([0.3, 1.25], jnp.float32)
    tfin = _t(jfin)
    _close(tfish.uv_bound_loss(tfin), jax.jit(jfish.uv_bound_loss)(jfin))
    for lod in (4, 8, 13):
        _close(tfish.negative_ys_loss(tfin['sil_spline'], lod),
               jax.jit(jfish.negative_ys_loss, static_argnums=1)(
                   jfin['sil_spline'], lod))
    xs = rng.uniform(0, 1, 17).astype(np.float32)
    _close(tfish.spline_ys(tfin['sil_spline'], torch.as_tensor(xs)),
           jax.jit(jfish.spline_ys)(jfin['sil_spline'], jnp.asarray(xs)))
    assert tfish.uv_grid_boxes(5) == jfish.uv_grid_boxes(5)


def test_project_points_and_soft_mask():
    rng = np.random.default_rng(4)
    jbody = _random_body(rng)
    tbody = _t(jbody)
    pts = rng.uniform(-1, 1, (6, 3)).astype(np.float32)
    _close(tfish._project_points(torch.as_tensor(pts), META),
           jax.jit(lambda p: jfish._project_points(p, META))(
               jnp.asarray(pts)))
    # the same float32 vertices into both renders (the soft mask's
    # sigmainv of 7000 magnifies the vertices' last bits)
    _close(tfish.fish_body_vertices(tbody, LOD_X, LOD_Y),
           _jbody_verts(jbody))
    verts = np.asarray(_jbody_verts(jbody), np.float32)
    faces, _, _ = jfish.card_topology(LOD_X, LOD_Y)
    jsoft, jidx = jax.jit(lambda v, f: jfish._render_soft_mask(
        v, f, META, RES, RES))(jnp.asarray(verts), jnp.asarray(faces))
    tsoft, tidx = tfish._render_soft_mask(torch.as_tensor(verts), faces,
                                          META, RES, RES)
    _close(tsoft, jsoft, MASK_TOL)
    assert float(tsoft.max()) > 0.5
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


def test_fin_gradient_finite_on_degenerate_root():
    """start_uv == end_uv: every tangent is zero, and the safe normalise
    keeps the gradient finite."""
    body = tfish.make_body_params(3, init_height=0.5, device='cpu')
    bv = tfish.fish_body_vertices(body, LOD_X, LOD_Y)
    fin = tfish.make_fin_params(3, device='cpu')
    for x in tfish._leaves(fin):
        x.requires_grad_(True)
    tfish.fish_fin_vertices(fin, bv, (LOD_X, LOD_Y), LOD_X, LOD_Y,
                            0.3).sum().backward()
    for x in tfish._leaves(fin):
        assert torch.isfinite(x.grad).all()


def _self_fit_data():
    """The JAX example's synthetic ground truth, moved off the centre
    and rendered by the port (both fits get the same numpy data; the
    render is held against JAX above). The example's own body (origin
    -0.7, length 1.4) is symmetric about x = 0, as the initial body is,
    so the gradient to origin_x is zero but for rounding (JAX -1e-13, the
    port 3e-5), and Adam's first step, lr * g / |g|, turns that rounding
    into a step of +lr on one side and -lr on the other."""
    return tfish.synthetic_data(RES, LOD_X, LOD_Y, 3, origin_xy=(-0.55, 0.1),
                                fin_uv=((0.25, 1.), (0.7, 1.)),
                                device='cpu')[0]


def test_fit_fish_history_matches_jax():
    data = _self_fit_data()
    hyper = {'lod_x': LOD_X, 'lod_y': LOD_Y, 'key_size': 3,
             'init_height': 0.3, 'fin_list': ['dorsal_fin'],
             'alpha_weight': 200., 'negative_ys_weight': 0.9,
             'root_pos_weight': 100., 'fin_uv_bound_weight': 100.,
             'image_weight': 1., 'texture_res': 16,
             'body_epochs': 3, 'fin_epochs': 2, 'texture_epochs': 2,
             'body_lr': 2e-2, 'fin_lr': 2e-2, 'texture_lr': 0.1,
             'scheduler_step_size': 2, 'scheduler_gamma': 0.5}
    jbody, jfins, jtex, jhist = jfish.fit_fish(data, hyper)
    tbody, tfins, ttex, thist = tfish.fit_fish(data, hyper, device='cpu')
    assert [s for s, _ in thist] == [s for s, _ in jhist]
    assert [s for s, _ in thist] == ['body'] * 3 + ['dorsal_fin'] * 2 \
        + ['texture'] * 2
    np.testing.assert_allclose([l for _, l in thist], [l for _, l in jhist],
                               rtol=HIST_RTOL)
    _close(tbody['origin_xy'], jbody['origin_xy'], 1e-4)


def _pairs(port, ref, path=''):
    """(path, port array, JAX array) at every leaf of the port's dict; a
    JAX leaf may be a list of scalars (its JSON reader maps each float)."""
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref), path
        for k in port:
            yield from _pairs(port[k], ref[k], f'{path}/{k}')
    else:
        yield path, port.numpy(), np.asarray(ref, np.float32)


def test_params_json_read_across(tmp_path):
    rng = np.random.default_rng(5)
    jbody = _random_body(rng)
    jfins = {'dorsal_fin': _random_fin(rng), 'tail_fin': _random_fin(rng)}
    hyper = {'lod_x': 8, 'fin_list': ['dorsal_fin', 'tail_fin']}
    # JAX writes, the port reads
    jpath = str(tmp_path / 'jax.json')
    jfish.fish_params_to_json(jpath, jbody, jfins, hyper)
    tbody, tfins, thyper = tfish.fish_params_from_json(jpath, device='cpu')
    assert thyper == hyper
    for port, ref in ((tbody, jbody), (tfins, jfins)):
        for path, a, b in _pairs(port, ref):
            np.testing.assert_array_equal(a, b, err_msg=path)
            assert a.dtype == np.float32 and a.shape == b.shape, path
    # the port writes, JAX reads; the files are the same text
    tpath = str(tmp_path / 'port.json')
    tfish.fish_params_to_json(tpath, tbody, tfins, hyper)
    jb2, jf2, jh2 = jfish.fish_params_from_json(tpath)
    assert jh2 == hyper
    for port, ref in ((tbody, jb2), (tfins, jf2)):
        for path, a, b in _pairs(port, ref):
            np.testing.assert_array_equal(a, b, err_msg=path)
    with open(tpath) as f, open(jpath) as g:
        assert f.read() == g.read()


def test_renderer_on_carried_texture():
    """``Renderer`` over a ``FishMesh`` in an atlas box, with a texture
    carried over (``texture_from_numpy``), against the JAX example's."""
    from examples.renderer import Renderer as JRenderer
    from kaolin_tpu_torch.examples.renderer import Renderer as TRenderer
    rng = np.random.default_rng(6)
    verts = np.asarray(_jbody_verts(_random_body(rng)), np.float32)
    faces, uvs, fuv = jfish.card_topology(LOD_X, LOD_Y)
    tex = rng.uniform(0, 1, (1, 3, 16, 16)).astype(np.float32)
    box = jfish.uv_grid_boxes(2)[1]
    view = (90., 0., 3., 0., 50.)
    jmesh = jfish.FishMesh(jnp.asarray(verts), faces, jnp.asarray(uvs), fuv,
                           box)
    ref = jax.jit(lambda t: JRenderer(1, (RES, RES))
                  .render_image_and_mask_with_camera_params(
                      *view, jmesh, 7000, t))(jnp.asarray(tex))
    tmesh = tfish.FishMesh(torch.as_tensor(verts), faces, uvs, fuv, box)
    out = TRenderer(1, (RES, RES)).render_image_and_mask_with_camera_params(
        *view, tmesh, 7000, tfish.texture_from_numpy(tex, device='cpu'))
    for o, r in zip(out, ref):
        _close(o, r, MASK_TOL)
    assert float(out[1].sum()) > 10
