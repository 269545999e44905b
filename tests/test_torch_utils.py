"""The port's ``utils.testing`` and ``utils.checkpoint`` against
``kaolin_tpu``'s.

``utils.testing``: ``tests/test_random_testing.py``'s cases on torch
tensors, each checker's answer equal to ``kaolin_tpu``'s on the same
numpy inputs. ``utils.checkpoint``: round trips, retention and resume of
a ``torch.optim.Adam`` run (the resumed run equals the uninterrupted one
bit for bit), and the checkpoints of both packages read by the other
through ``like=``, bit-equal.
"""

import numpy as np
import pytest
import torch

import kaolin_tpu.utils.testing as jt
from kaolin_tpu_torch.ops import random as krandom
from kaolin_tpu_torch.utils import testing as tt
from kaolin_tpu_torch.utils.checkpoint import (CheckpointManager,
                                               load_pytree, save_pytree)


# ------------------------------------------------------------------ testing

def test_with_seed_and_dtypes():
    @tt.with_seed(99)
    def draw():
        return krandom.random_tensor(0., 1., (3,), device='cpu')

    assert torch.equal(draw(), draw())
    assert tt.FLOAT_DTYPES == [torch.float32, torch.float64]
    assert tt.INT_DTYPES == [torch.int32, torch.int64, torch.uint8]
    assert tt.ALL_DTYPES == tt.FLOAT_DTYPES + tt.INT_DTYPES


CHECK_TENSOR_CASES = [
    dict(shape=(2, 3), dtype='float32'), dict(shape=(2, None)),
    dict(shape=(3, 3)), dict(shape=(2, 3, 1)), dict(dtype='int32'),
]


@pytest.mark.parametrize('case', range(len(CHECK_TENSOR_CASES)))
def test_check_tensor_matches_kaolin_tpu(case):
    import jax.numpy as jnp
    kw = dict(CHECK_TENSOR_CASES[case])
    dtype = kw.pop('dtype', None)
    t = torch.zeros((2, 3))
    ref = jt.check_tensor(jnp.zeros((2, 3), jnp.float32), throw=False,
                          dtype=dtype and getattr(jnp, dtype), **kw)
    assert tt.check_tensor(t, throw=False,
                           dtype=dtype and getattr(torch, dtype), **kw) == ref
    if not ref:
        with pytest.raises(ValueError if 'shape' in kw else TypeError):
            tt.check_tensor(t, dtype=dtype and getattr(torch, dtype), **kw)
    assert tt.check_packed_tensor(torch.zeros((10, 4)), total_numel=10,
                                  last_dim=4)
    assert not tt.check_packed_tensor(torch.zeros((10, 4)), total_numel=9,
                                      throw=False)


def test_check_padded_tensor_padding_values():
    spt = np.array([[2], [3]])
    padded = np.zeros((2, 4, 3), np.float32)
    padded[0, :2] = 1.
    padded[1, :3] = 2.
    bad = padded.copy()
    bad[0, 3, 0] = 5.
    for arr, want in ((padded, True), (bad, False)):
        kw = dict(padding_value=0., shape_per_tensor=spt, batch_size=2,
                  last_dim=3, throw=False)
        assert jt.check_padded_tensor(arr, **kw) is want
        assert tt.check_padded_tensor(torch.tensor(arr), **kw) is want
    with pytest.raises(ValueError):
        tt.check_padded_tensor(torch.tensor(bad), padding_value=0.,
                               shape_per_tensor=spt)


OCTREE_CASES = [
    ([0x03, 0x01], [2], {}),                       # 2 children, 1 byte
    ([0x01, 0x01], [3], {}),                       # lengths' sum
    ([0x01, 0x01], [2], dict(batch_size=2)),
    ([0x01, 0x01], [2], dict(level=3)),
    ([0x01, 0x01], [2], dict(level=2)),
    ([0x01, 0x01, 0x80, 0x01, 0x01], [2, 3], dict(batch_size=2)),
    ([0x01, 0x01, 0x80, 0x01, 0x01], [2, 3], dict(level=2)),
]


@pytest.mark.parametrize('case', range(len(OCTREE_CASES)))
def test_check_spc_octrees_matches_kaolin_tpu(case):
    octree, lengths, kw = OCTREE_CASES[case]
    octree = np.asarray(octree, np.uint8)
    ref = jt.check_spc_octrees(octree, np.asarray(lengths), throw=False,
                               **kw)
    out = tt.check_spc_octrees(torch.tensor(octree), torch.tensor(lengths),
                               throw=False, **kw)
    assert out is ref
    if not ref:
        with pytest.raises(ValueError):
            tt.check_spc_octrees(torch.tensor(octree), torch.tensor(lengths),
                                 **kw)


def test_random_spc_octrees_are_valid():
    krandom.manual_seed(3)
    octrees, lengths = krandom.random_spc_octrees(3, 4, device='cpu')
    assert tt.check_spc_octrees(octrees, lengths, batch_size=3, level=4)


def test_tensor_info_and_contained_helpers():
    t = torch.tensor([[1., 2.], [3., 4.]])
    s = tt.tensor_info(t, name='x', print_stats=True)
    assert s == ('x: shape=(2, 2) dtype=torch.float32 min=1 max=4 mean=2.5 '
                 'std=1.118')
    assert 'mean' not in tt.tensor_info(torch.tensor([1, 2, 3]), 'i',
                                        print_stats=True)
    a = {'a': t, 'b': [torch.arange(3)]}
    b = {'a': t + 0., 'b': [torch.arange(3)]}
    c = {'a': t + 1e-7, 'b': [torch.arange(3)]}
    assert tt.contained_allclose(a, b) and tt.contained_torch_equal(a, b)
    assert tt.contained_allclose(a, c) and not tt.contained_torch_equal(a, c)
    assert not tt.contained_allclose(a, {'a': t})
    assert not tt.contained_allclose(a, {'a': t, 'b': [torch.arange(4)]})


# --------------------------------------------------------------- checkpoint

def test_pytree_roundtrip(tmp_path):
    tree = {'a': torch.arange(5.), 'b': (torch.ones((2, 3)), 7, None),
            'c': {'z': torch.tensor([True, False]), 'y': np.arange(2),
                  'lr': 0.5, 'name': 'adam'}}
    save_pytree(str(tmp_path / 'ck'), tree)
    back = load_pytree(str(tmp_path / 'ck'), device='cpu')
    assert list(back) == ['a', 'b', 'c'] and list(back['c']) == [
        'lr', 'name', 'y', 'z']
    assert torch.equal(back['a'], tree['a'])
    assert torch.equal(back['b'][0], tree['b'][0])
    assert back['b'][1:] == (7, None) and type(back['b'][1]) is int
    assert torch.equal(back['c']['z'], tree['c']['z'])
    assert isinstance(back['c']['y'], np.ndarray)
    assert back['c']['lr'] == 0.5 and back['c']['name'] == 'adam'


def _adam_run(steps, params=None, opt_state=None):
    p = params if params is not None else torch.tensor([1., 2., 3.])
    p = p.clone().requires_grad_(True)
    opt = torch.optim.Adam([p], lr=0.1)
    if opt_state is not None:
        opt.load_state_dict(opt_state)
    for _ in range(steps):
        opt.zero_grad()
        (p ** 2).sum().backward()
        opt.step()
    return p.detach(), opt


def test_manager_retention_and_resume(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    p, opt = torch.tensor([1., 2., 3.]), None
    for i in range(5):
        p, opt = _adam_run(1, p, opt and opt.state_dict())
        mgr.save(i, {'params': p, 'opt': opt.state_dict(), 'step': i})
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    restored = mgr.restore(mgr.latest_step(), device='cpu')
    assert restored['step'] == 4 and torch.equal(restored['params'], p)
    resumed, _ = _adam_run(3, restored['params'], restored['opt'])
    straight, _ = _adam_run(8)
    assert torch.equal(resumed, straight)
    like = {'params': torch.zeros(3), 'opt': opt.state_dict(), 'step': 0}
    again = mgr.restore(4, like=like)
    assert torch.equal(again['opt']['state'][0]['exp_avg'],
                       opt.state_dict()['state'][0]['exp_avg'])
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path / 'none')).restore(None)


def _jax_tree(rng):
    import jax.numpy as jnp
    return {'params': {'w': jnp.asarray(rng.normal(size=(3, 4)),
                                        jnp.float32),
                       'b': jnp.asarray(rng.normal(size=4), jnp.float32)},
            'opt': (jnp.asarray(rng.random(4), jnp.float32),
                    jnp.asarray(rng.random(4), jnp.float64)),
            'step': 3}


def test_reads_a_kaolin_tpu_checkpoint_bit_equal(tmp_path):
    """``kaolin_tpu`` writes; the port reads through ``like`` (written in
    another key order than JAX's sorted one), bit-equal; without ``like``
    it refuses the JAX treedef. And the other way round."""
    from kaolin_tpu.utils import checkpoint as jck
    tree = _jax_tree(np.random.default_rng(0))
    jck.save_pytree(str(tmp_path / 'jax'), tree)
    like = {'step': 0, 'opt': (torch.zeros(4), torch.zeros(4,
                                                         dtype=torch.float64)),
            'params': {'w': torch.zeros(3, 4), 'b': torch.zeros(4)}}
    back = load_pytree(str(tmp_path / 'jax'), like=like)
    assert list(back) == ['opt', 'params', 'step']
    for ref, out in ((tree['params']['w'], back['params']['w']),
                     (tree['params']['b'], back['params']['b']),
                     (tree['opt'][0], back['opt'][0]),
                     (tree['opt'][1], back['opt'][1])):
        assert np.asarray(ref).tobytes() == out.numpy().tobytes()
        assert np.asarray(ref).dtype == out.numpy().dtype
    assert back['step'] == 3 and type(back['step']) is int
    with pytest.raises(ValueError, match='like='):
        load_pytree(str(tmp_path / 'jax'), device='cpu')
    with pytest.raises(ValueError, match='leaves'):
        load_pytree(str(tmp_path / 'jax'), like={'w': torch.zeros(1)})

    save_pytree(str(tmp_path / 'port'), back)
    jback = jck.load_pytree(str(tmp_path / 'port'), like=tree)
    for ref, out in ((tree['params']['w'], jback['params']['w']),
                     (tree['opt'][1], jback['opt'][1])):
        assert np.asarray(ref).tobytes() == np.asarray(out).tobytes()
