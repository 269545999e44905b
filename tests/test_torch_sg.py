"""The port's spherical-gaussian lighting against ``kaolin_tpu`` on the CPU.

The same seeded numpy inputs go to both packages: every public function
of ``render/lighting/sg.py``, at float64 and float32, and the gradients
of the reduced inner product (to all six inputs), the specular term and
both diffuse terms against ``jax.grad``. Tolerances, relative to the
largest entry: values 1e-12 (float64) and 2e-6 (float32; the sums of
light terms run in other orders and XLA fuses multiply-adds), gradients
1e-10 and 2e-5. The reduced product is also run with a chunk smaller
than the light count, so the padded lights (amplitude 0, direction and
sharpness 1) take part. Antipodal lobes of equal sharpness give 0 / 0:
the tests hold the two packages NaN for NaN there and keep the other
inputs away from it.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import kaolin_tpu as kal
import kaolin_tpu_torch as kt

js, ts = kal.render.lighting, kt.render.lighting
TOL = {np.float64: 1e-12, np.float32: 2e-6}
GRAD_TOL = {np.float64: 1e-10, np.float32: 2e-5}
DTYPES = (np.float64, np.float32)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them from
    contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(ref, out, tol):
    ref = np.asarray(ref, np.float64)
    out = out.detach().numpy().astype(np.float64)
    assert ref.shape == out.shape
    scale = max(1., float(np.nanmax(np.abs(ref))))
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(out))
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * scale)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _lobes(n, seed, dtype):
    """(amplitude, direction, sharpness) as bench_sg.py draws them."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 1.5, (n, 3)).astype(dtype),
            _unit(rng, n).astype(dtype),
            rng.uniform(1., 8., (n,)).astype(dtype))


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.tensor(a) for a in arrays])


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('num_lights,chunk', [(7, 512), (37, 8), (64, 64)])
def test_reduced_inner_product(dtype, num_lights, chunk):
    lj, lt = _both(*_lobes(50, 0, dtype), *_lobes(num_lights, 1, dtype))
    ref, ref_pair = jax.jit(lambda *a: (
        js.unbatched_reduced_sg_inner_product(*a, chunk=chunk),
        js.unbatched_sg_inner_product(*a)))(*lj)
    out = ts.unbatched_reduced_sg_inner_product(*lt, chunk=chunk)
    assert out.dtype == lt[0].dtype
    _close(ref, out, TOL[dtype])
    # the chunked sum equals the pairwise products' sum
    pair = ts.unbatched_sg_inner_product(*lt)
    assert pair.shape == (50, num_lights, 3)
    _close(ref_pair, pair, TOL[dtype])
    _close(pair.sum(1).numpy(), out, 10 * TOL[dtype])


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('chunk', [512, 16])
def test_reduced_inner_product_grads(dtype, chunk):
    arrays = (*_lobes(40, 2, dtype), *_lobes(45, 3, dtype))
    cot = np.random.default_rng(4).normal(size=(40, 3)).astype(dtype)
    ref = jax.jit(jax.grad(lambda *a: jnp.sum(
        js.unbatched_reduced_sg_inner_product(*a, chunk=chunk) * cot),
        argnums=tuple(range(6))))(*[jnp.asarray(a) for a in arrays])
    lt = [torch.tensor(a, requires_grad=True) for a in arrays]
    (ts.unbatched_reduced_sg_inner_product(*lt, chunk=chunk)
     * torch.tensor(cot)).sum().backward()
    for r, t in zip(ref, lt):
        _close(r, t.grad, GRAD_TOL[dtype])


def test_antipodal_lobes_nan_for_nan():
    """Opposite directions of equal sharpness: dm = 0 and the product is
    0 / 0 in both packages."""
    a = np.ones((2, 3))
    d = np.array([[0., 0., 1.], [1., 0., 0.]])
    s = np.array([2., 2.])
    od = np.array([[0., 0., -1.], [0., 1., 0.]])
    lj, lt = _both(a, d, s, a, od, s)
    ref = np.asarray(js.unbatched_sg_inner_product(*lj))
    out = ts.unbatched_sg_inner_product(*lt)
    assert np.isnan(ref[0, 0]).all() and torch.isnan(out[0, 0]).all()
    _close(ref, out, TOL[np.float64])


def _shading(n, seed, dtype):
    rng = np.random.default_rng(seed)
    normal = _unit(rng, n)
    view = _unit(rng, n)
    view = np.where((normal * view).sum(-1, keepdims=True) < 0, -view, view)
    return (normal.astype(dtype), view.astype(dtype),
            rng.uniform(0.2, 0.9, (n,)).astype(dtype),
            rng.uniform(0.1, 0.9, (n, 3)).astype(dtype))


@pytest.mark.parametrize('dtype', DTYPES)
def test_shading_terms(dtype):
    amp, dirn, sharp = _lobes(24, 5, dtype)
    normal, view, rough, albedo = _shading(30, 6, dtype)
    lj, lt = _both(amp, dirn, sharp, normal, view, rough, albedo)

    def terms(pkg, a, d, s, n, v, r, al):
        return (*pkg.sg_distribution_term(n, r),
                *pkg.sg_warp_distribution(*pkg.sg_distribution_term(n, r), v),
                pkg.fresnel(r[:, None], al),
                pkg.sg_warp_specular_term(a, d, s, n, r, v, al),
                *pkg.cosine_lobe_sg(n),
                pkg.approximate_sg_integral(a, s),
                pkg.sg_irradiance_fitted(a, d, s, n),
                pkg.sg_diffuse_fitted(a, d, s, n, al),
                pkg.sg_irradiance_inner_product(a, d, s, n),
                pkg.sg_diffuse_inner_product(a, d, s, n, al))

    refs = jax.jit(lambda *x: terms(js, *x))(*lj)
    outs = terms(ts, *lt)
    assert len(refs) == len(outs) == 16
    for ref, out in zip(refs, outs):
        _close(ref, out, TOL[dtype])


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('term', ['specular', 'diffuse_fitted',
                                  'diffuse_inner'])
def test_shading_grads(dtype, term):
    amp, dirn, sharp = _lobes(12, 7, dtype)
    normal, view, rough, albedo = _shading(16, 8, dtype)

    def call(pkg, a, d, s, n, v, r, al):
        if term == 'specular':
            return pkg.sg_warp_specular_term(a, d, s, n, r, v, al)
        if term == 'diffuse_fitted':
            return pkg.sg_diffuse_fitted(a, d, s, n, al)
        return pkg.sg_diffuse_inner_product(a, d, s, n, al)

    arrays = (amp, dirn, sharp, normal, view, rough, albedo)
    ref = jax.jit(jax.grad(lambda *x: jnp.sum(call(js, *x)),
                           argnums=tuple(range(7))))(
        *[jnp.asarray(a) for a in arrays])
    lt = [torch.tensor(a, requires_grad=True) for a in arrays]
    call(ts, *lt).sum().backward()
    for r, t in zip(ref, lt):
        if t.grad is None:      # an input the term does not read
            assert not np.asarray(r).any()
            continue
        _close(r, t.grad, GRAD_TOL[dtype])


def test_cosine_lobe_integral():
    """The clamped-cosine lobe's SG integral, 2 pi 1.17 / 2.133, as the
    JAX package's doctest has it."""
    amp, _, sharp = ts.cosine_lobe_sg(torch.tensor([[0., 0., 1.]]))
    integ = ts.approximate_sg_integral(amp, sharp)
    assert torch.allclose(integ, torch.full((1, 3), 2 * math.pi * 1.17
                                            / 2.133), rtol=1e-6)
