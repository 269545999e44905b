"""Training-state checkpoint / resume for optimization loops.

Port of ``kaolin_tpu/utils/checkpoint.py``, in its layout:
``<root>/step_<N>/{arrays.npz, structure.pkl}``, the leaves as
``leaf_<i>`` in JAX's leaf order (dict keys sorted, ``None`` no leaf).
``kaolin_tpu`` pickles a JAX treedef into ``structure.pkl``; the port
writes a plain skeleton there instead (tuples, lists, strings and numbers,
no JAX or torch class) and unpickles only such a skeleton. So the port
reads its own checkpoints whole, and a checkpoint that ``kaolin_tpu``
wrote through ``like=``: the leaves come from the ``.npz`` and ``like``
is flattened in JAX's order. That carries a JAX run's parameters and
optimizer state into the port.

Usage::

    mgr = CheckpointManager('/path/ckpts', max_to_keep=3)
    mgr.save(step, {'params': params, 'opt': opt.state_dict()})
    state = mgr.restore(mgr.latest_step())
"""

import builtins
import os
import pickle
import shutil

import numpy as np
import torch

__all__ = ['CheckpointManager', 'save_pytree', 'load_pytree']

_STRUCT = 'structure.pkl'
_ARRAYS = 'arrays.npz'
_SCALARS = (bool, int, float, complex, str)


def _flatten(tree):
    """(leaves, skeleton) of ``tree`` in JAX's leaf order: dict keys sorted,
    lists and tuples (namedtuples too, rebuilt as tuples) in order,
    ``None`` no leaf. The skeleton is made of plain values only."""
    leaves = []

    def walk(node):
        if node is None:
            return ('none',)
        if isinstance(node, dict):
            keys = sorted(node)
            return ('dict', keys, [walk(node[k]) for k in keys])
        if isinstance(node, (list, tuple)):
            return ('list' if isinstance(node, list) else 'tuple',
                    [walk(v) for v in node])
        leaves.append(node)
        if torch.is_tensor(node):
            return ('leaf', 'tensor')
        if isinstance(node, _SCALARS):
            return ('leaf', type(node).__name__)
        return ('leaf', 'ndarray')

    return leaves, walk(tree)


def _unflatten(skeleton, make_leaf):
    """The tree of :func:`_flatten`'s ``skeleton``, its leaves in order
    from ``make_leaf(leaf kind)``."""
    def build(node):
        kind = node[0]
        if kind == 'none':
            return None
        if kind == 'leaf':
            return make_leaf(node[1])
        if kind == 'dict':
            return {k: build(c) for k, c in zip(node[1], node[2])}
        children = [build(c) for c in node[1]]
        return tuple(children) if kind == 'tuple' else children

    return build(skeleton)


def _leaf_array(leaf):
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path, tree):
    """Writes a pytree of tensors, arrays and scalars to ``path`` (a
    directory): the leaves in one ``.npz``, the skeleton in a pickle.
    Atomic: writes to ``path + '.tmp'``, then renames."""
    tmp = path + '.tmp'
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    leaves, skeleton = _flatten(tree)
    np.savez(os.path.join(tmp, _ARRAYS),
             **{f'leaf_{i}': _leaf_array(leaf)
                for i, leaf in enumerate(leaves)})
    with open(os.path.join(tmp, _STRUCT), 'wb') as f:
        pickle.dump({'skeleton': skeleton, 'num_leaves': len(leaves)}, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


class _PlainUnpickler(pickle.Unpickler):
    """Unpickles plain data only (a skeleton): a reference to any class or
    function, such as a JAX treedef's, raises."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(f'{module}.{name}')


def _restore_leaf(array, kind, device):
    if kind == 'tensor':
        return torch.from_numpy(array).to(device)
    if kind == 'ndarray':
        return array
    return getattr(builtins, kind)(array.item())


def _like_leaf(array, like):
    """``array`` as ``like``'s type: a tensor of its dtype on its device, a
    numpy array of its dtype, or a Python scalar of its type."""
    if torch.is_tensor(like):
        return torch.from_numpy(np.ascontiguousarray(array)).to(
            dtype=like.dtype, device=like.device)
    if isinstance(like, _SCALARS):
        return type(like)(array.item())
    return np.asarray(array, dtype=np.asarray(like).dtype)


def load_pytree(path, like=None, device='cuda'):
    """Loads a pytree written by :func:`save_pytree`, or with ``like`` by
    ``kaolin_tpu``'s.

    Args:
        path: checkpoint directory.
        like: optional example pytree: the stored leaves are rebuilt into
            its structure, flattened in JAX's leaf order, each as the
            example leaf's type (a tensor keeps its dtype and device). A
            checkpoint that ``kaolin_tpu`` wrote needs it: its
            ``structure.pkl`` holds a JAX treedef, which is not read.
        device: where the tensor leaves land without ``like``.
    """
    with np.load(os.path.join(path, _ARRAYS)) as data:
        leaves = [data[f'leaf_{i}'] for i in range(len(data.files))]
    if like is not None:
        like_leaves, skeleton = _flatten(like)
        if len(like_leaves) != len(leaves):
            raise ValueError(
                f'checkpoint has {len(leaves)} leaves, example has '
                f'{len(like_leaves)}')
        pairs = zip(leaves, like_leaves)
        return _unflatten(skeleton, lambda kind: _like_leaf(*next(pairs)))
    with open(os.path.join(path, _STRUCT), 'rb') as f:
        try:
            meta = _PlainUnpickler(f).load()
        except pickle.UnpicklingError as exc:
            raise ValueError(
                f'{path}: {_STRUCT} holds no plain skeleton (a checkpoint '
                f'of kaolin_tpu?); pass like= to restore it') from exc
    arrays = iter(leaves)
    return _unflatten(meta['skeleton'], lambda kind: _restore_leaf(
        next(arrays), kind, device))


class CheckpointManager:
    """Step-indexed checkpoints with retention, orbax-style.

    Directory layout: ``<root>/step_<N>/{arrays.npz, structure.pkl}``.
    """

    def __init__(self, root, max_to_keep=None):
        self.root = root
        self.max_to_keep = max_to_keep
        os.makedirs(root, exist_ok=True)

    def _step_dir(self, step):
        return os.path.join(self.root, f'step_{step}')

    def all_steps(self):
        steps = []
        for name in os.listdir(self.root):
            if name.startswith('step_') and not name.endswith('.tmp'):
                try:
                    steps.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step, tree):
        save_pytree(self._step_dir(step), tree)
        if self.max_to_keep is not None:
            steps = self.all_steps()
            for old in steps[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old))

    def restore(self, step, like=None, device='cuda'):
        """The tree of ``step`` (see :func:`load_pytree`)."""
        if step is None:
            raise ValueError('no checkpoint to restore')
        return load_pytree(self._step_dir(step), like=like, device=device)
