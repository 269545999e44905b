"""The port's sparse octree convolutions against ``kaolin_tpu`` on the CPU.

One octree, built by the port from seeded points (so this file adds no
caller of ``kaolin_tpu``'s native loader), goes to both packages as numpy
arrays. ``conv3d`` and ``conv_transpose3d`` at jump 0 and 1, with kernels
of 1, 8 and 27 offsets (the 27 from -1 to 1: negative offsets, which the
transpose divides with floor semantics), with and without bias, at
float64 and float32; their gradients to the input, the weight and the
bias against ``jax.grad``; the transpose also against a numpy loop over
the offsets; and the ``Conv3d`` / ``ConvTranspose3d`` modules with the
JAX layers' weights carried across (``utils.interop.load_params``).
Tolerances, relative to the largest entry: 1e-12 at float64, 2e-6 at
float32 (the matrix products add in other orders), gradients 1e-11 and
1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import kaolin_tpu as kal
import kaolin_tpu_torch as kt

jc, tc = kal.ops.spc.convolution, kt.ops.spc.convolution
TOL = {np.float64: 1e-12, np.float32: 2e-6}
GRAD_TOL = {np.float64: 1e-11, np.float32: 1e-5}
DTYPES = (np.float64, np.float32)
LEVEL = 3


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them from
    contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _kernel(lo, hi):
    r = np.arange(lo, hi + 1)
    return np.stack(np.meshgrid(r, r, r, indexing='ij'),
                    -1).reshape(-1, 3).astype(np.int16)


KERNELS = {'k1': np.zeros((1, 3), np.int16), 'k8': _kernel(0, 1),
           'k27': _kernel(-1, 1)}


@pytest.fixture(scope='module')
def spc():
    """A level-3 octree of 60 seeded points: (port tensors, JAX arrays)."""
    rng = np.random.default_rng(7)
    pts = np.unique(rng.integers(0, 2 ** LEVEL, (60, 3)), axis=0)
    octree = kt.ops.spc.unbatched_points_to_octree(
        torch.tensor(pts.astype(np.int16)), LEVEL)
    _, pyramids, exsum = kt.ops.spc.scan_octrees(octree, [octree.shape[0]])
    ph = kt.ops.spc.generate_points(octree, pyramids, exsum)
    port = (octree, ph, pyramids, exsum)
    ref = (jnp.asarray(octree.numpy()), jnp.asarray(ph.numpy()), pyramids,
           jnp.asarray(exsum.numpy()))
    return port, ref


def _n(pyramids, level):
    return int(pyramids[0, 0, level])


def _close(ref, out, tol):
    ref = np.asarray(ref, np.float64)
    out = out.detach().numpy().astype(np.float64)
    assert ref.shape == out.shape
    scale = max(1., float(np.abs(ref).max(initial=0.)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * scale)


def _case(spc, transpose, kernel, jump, bias, dtype, seed=0):
    """Runs one convolution in both packages, values and gradients."""
    (octree, ph, pyramids, exsum), (jo, jph, jpyr, jex) = spc
    kv = KERNELS[kernel]
    level = LEVEL - jump if transpose else LEVEL
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(_n(pyramids, level), 5)).astype(dtype)
    w = rng.normal(size=(kv.shape[0], 5, 4)).astype(dtype)
    b = rng.normal(size=(4,)).astype(dtype) if bias else None
    jfn = jc.conv_transpose3d if transpose else jc.conv3d
    tfn = tc.conv_transpose3d if transpose else tc.conv3d
    out_level = level + jump if transpose else level - jump
    cot = rng.normal(size=(_n(pyramids, out_level), 4)).astype(dtype)

    def jloss(x, w, *b):
        y, _ = jfn(jo, jph, level, jpyr, jex, x, w, kv, jump,
                   b[0] if b else None)
        return jnp.sum(y * cot), y

    args = [jnp.asarray(x), jnp.asarray(w)] + ([jnp.asarray(b)] if bias
                                               else [])
    grads, ref = jax.jit(jax.grad(jloss, argnums=tuple(range(len(args))),
                                  has_aux=True))(*args)
    targs = [torch.tensor(a, requires_grad=True) for a in
             ([x, w] + ([b] if bias else []))]
    out, lvl = tfn(octree, ph, level, pyramids, exsum, targs[0], targs[1],
                   kv, jump, targs[2] if bias else None)
    assert lvl == out_level and out.dtype == targs[0].dtype
    _close(ref, out, TOL[dtype])
    (out * torch.tensor(cot)).sum().backward()
    for g, t in zip(grads, targs):
        _close(g, t.grad, GRAD_TOL[dtype])
    return out


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('kernel,jump,bias', [
    ('k27', 0, True), ('k8', 1, False), ('k27', 1, True), ('k1', 0, True),
    ('k1', 1, False)])
def test_conv3d(spc, kernel, jump, bias, dtype):
    _case(spc, False, kernel, jump, bias, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('kernel,jump,bias', [
    ('k27', 1, True), ('k8', 1, False), ('k27', 0, False), ('k1', 0, True)])
def test_conv_transpose3d(spc, kernel, jump, bias, dtype):
    _case(spc, True, kernel, jump, bias, dtype)


def test_conv_transpose3d_negative_offsets_oracle(spc):
    """The transpose with offsets from -1 to 1 at jump 1 against a loop:
    output point p takes input (p - k) / 2 where p - k is nonnegative and
    even."""
    (octree, ph, pyramids, exsum), _ = spc
    kv = KERNELS['k27']
    pyr = pyramids[0]
    coarse = ph[pyr[1, LEVEL - 1]:pyr[1, LEVEL]].numpy().astype(np.int64)
    fine = ph[pyr[1, LEVEL]:pyr[1, LEVEL + 1]].numpy().astype(np.int64)
    table = {tuple(p): i for i, p in enumerate(coarse)}
    rng = np.random.default_rng(3)
    x = rng.normal(size=(coarse.shape[0], 3))
    w = rng.normal(size=(kv.shape[0], 3, 2))
    ref = np.zeros((fine.shape[0], 2))
    for i, p in enumerate(fine):
        for k, off in enumerate(kv):
            s = p - off
            if (s >= 0).all() and not (s % 2).any() and tuple(s // 2) in table:
                ref[i] += x[table[tuple(s // 2)]] @ w[k]
    out, _ = tc.conv_transpose3d(octree, ph, LEVEL - 1, pyramids, exsum,
                                 torch.tensor(x), torch.tensor(w), kv, 1)
    _close(ref, out, 1e-12)


def test_rejects_batched_pyramids(spc):
    (octree, ph, pyramids, exsum), _ = spc
    x = torch.zeros((_n(pyramids, LEVEL), 2), dtype=torch.float64)
    w = torch.zeros((8, 2, 2), dtype=torch.float64)
    for fn in (tc.conv3d, tc.conv_transpose3d):
        with pytest.raises(ValueError):
            fn(octree, ph, LEVEL, np.concatenate([pyramids, pyramids]),
               exsum, x, w, KERNELS['k8'], 1)


@pytest.mark.parametrize('transpose', [False, True])
def test_layers_with_jax_weights(spc, transpose):
    """``Conv3d`` / ``ConvTranspose3d`` with the JAX layers' ``init``
    weights compute what the JAX layers compute."""
    (octree, ph, pyramids, exsum), (jo, jph, jpyr, jex) = spc
    kv = KERNELS['k27']
    jcls = jc.ConvTranspose3d if transpose else jc.Conv3d
    tcls = tc.ConvTranspose3d if transpose else tc.Conv3d
    jlayer = jcls(6, 3, kv, jump=1)
    params = jlayer.init(jax.random.PRNGKey(0))
    layer = kt.utils.interop.load_params(
        tcls(6, 3, kv, jump=1, device='cpu'),
        {k: np.asarray(v) for k, v in params.items()})
    level = LEVEL - 1 if transpose else LEVEL
    x = np.random.default_rng(5).normal(
        size=(_n(pyramids, level), 6)).astype(np.float32)
    ref, ref_level = jlayer(params, jo, jph, level, jpyr, jex,
                            jnp.asarray(x))
    out, out_level = layer(octree, ph, level, pyramids, exsum,
                           torch.tensor(x))
    assert out_level == ref_level
    _close(ref, out, TOL[np.float32])


def test_layer_init():
    """The weights are uniform in +-1/sqrt(in * K) from the generator, the
    bias 0; the same seed gives the same weights; no bias when asked."""
    kv = KERNELS['k27']
    make = [lambda: tc.Conv3d(4, 5, kv, generator=torch.Generator()
                              .manual_seed(1), device='cpu')
            for _ in range(2)]
    a, b = make[0](), make[1]()
    assert a.weight.shape == (27, 4, 5) and a.bias.shape == (5,)
    assert torch.equal(a.weight, b.weight) and not a.bias.any()
    assert a.weight.abs().max() <= 1. / np.sqrt(4 * 27)
    assert a.weight.std() > 0.5 / np.sqrt(3 * 4 * 27)
    c = tc.ConvTranspose3d(4, 5, kv, bias=False, device='cpu')
    assert c.bias is None and [n for n, _ in c.named_parameters()] == [
        'weight']
    with pytest.raises(ValueError):
        kt.utils.interop.load_params(c, {'weight': np.zeros((27, 4, 5)),
                                         'bias': np.zeros(5)})
