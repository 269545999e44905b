"""Random test-data generators. Port of ``kaolin_tpu/ops/random.py``
(reference ``kaolin/ops/random.py:23-204``).

A ``torch.Generator`` takes the place of the JAX package's PRNG key. The
module keeps one generator (on the CPU) and one numpy generator, as the
JAX package keeps a key and a numpy generator: :func:`manual_seed` seeds
both, :func:`get_key` hands out a fresh generator seeded from the module's.
Draws are made on the generator's device and land on ``device``.
"""

import numpy as np
import torch

__all__ = [
    'manual_seed',
    'get_key',
    'get_state',
    'set_state',
    'random_shape_per_tensor',
    'random_tensor',
    'sample_spherical_coords',
    'random_spc_octrees',
]

_GENERATOR = torch.Generator().manual_seed(0)
_NP_RNG = [np.random.default_rng(0)]


def manual_seed(seed):
    """Sets the module-level seeds (reference: ``kaolin/ops/random.py:23``)."""
    _GENERATOR.manual_seed(seed)
    _NP_RNG[0] = np.random.default_rng(seed)


def get_key():
    """A fresh ``torch.Generator`` (CPU), seeded from the module-level
    generator, which advances."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=_GENERATOR))
    return torch.Generator().manual_seed(seed)


def random_shape_per_tensor(batch_size, min_shape=None, max_shape=None):
    """Generates random ``shape_per_tensor`` (host numpy, static metadata).

    Reference: ``kaolin/ops/random.py:80``.
    """
    if max_shape is None:
        raise ValueError("max_shape must be provided")
    max_shape = np.asarray(max_shape)
    if min_shape is None:
        min_shape = np.ones_like(max_shape)
    min_shape = np.asarray(min_shape)
    return _NP_RNG[0].integers(min_shape, max_shape + 1,
                               size=(batch_size, len(max_shape))).astype(np.int64)


def random_tensor(low, high, shape, dtype=torch.float32, key=None,
                  device='cuda'):
    """A random tensor in [low, high] (reference: ``random.py:107``):
    integers uniform in [low, high], bools fair, floats uniform in
    [low, high)."""
    gen = _GENERATOR if key is None else key
    if dtype == torch.bool:
        out = torch.rand(shape, generator=gen, device=gen.device) < 0.5
    elif dtype.is_floating_point:
        out = low + (high - low) * torch.rand(shape, generator=gen,
                                              dtype=dtype, device=gen.device)
    else:
        out = torch.randint(int(low), int(high) + 1, shape, generator=gen,
                            dtype=dtype, device=gen.device)
    return out.to(device)


def sample_spherical_coords(shape, azimuth_low=0., azimuth_high=2. * np.pi,
                            elevation_low=0., elevation_high=np.pi / 2.,
                            key=None, device='cuda'):
    """Samples azimuth / elevation angles uniformly over the sphere patch.

    Reference: ``kaolin/ops/random.py:175``: elevation is sampled with a
    sin-uniform distribution so points are uniform on the sphere surface.
    """
    gen = _GENERATOR if key is None else key
    azimuth = azimuth_low + (azimuth_high - azimuth_low) * torch.rand(
        shape, generator=gen, device=gen.device)
    sin_lo = np.sin(elevation_low)
    sin_hi = np.sin(elevation_high)
    elevation = torch.arcsin(sin_lo + (sin_hi - sin_lo) * torch.rand(
        shape, generator=gen, device=gen.device))
    return azimuth.to(device), elevation.to(device)


def random_spc_octrees(batch_size, max_level, key=None, device='cuda'):
    """Generates random structured-point-cloud octrees.

    Reference: ``kaolin/ops/random.py:139``. Returns (octrees, lengths):
    ``octrees`` is a flat uint8 tensor of breadth-first child-occupancy
    bytes for the whole batch, on ``device``; ``lengths`` the per-octree
    byte counts (host numpy int64). The bytes are drawn with numpy: from
    the module's numpy generator, or from one seeded by ``key``.
    """
    if key is None:
        rng = _NP_RNG[0]
    else:
        rng = np.random.default_rng(int(torch.randint(
            0, 2 ** 31 - 1, (), generator=key, device=key.device)))
    out_bytes = []
    lengths = []
    for _ in range(batch_size):
        octree = []
        cur_num_nodes = 1
        for _level in range(max_level):
            cur_bytes = rng.integers(1, 256, size=(cur_num_nodes,)).astype(np.uint8)
            octree.append(cur_bytes)
            cur_num_nodes = int(np.unpackbits(cur_bytes).sum())
        octree = np.concatenate(octree)
        out_bytes.append(octree)
        lengths.append(octree.shape[0])
    return (torch.as_tensor(np.concatenate(out_bytes), device=device),
            np.asarray(lengths, dtype=np.int64))


def get_state():
    """The module-level generators' states (reference
    ``kaolin/ops/random.py:58``): a (torch generator state, numpy bit
    generator state) pair."""
    return (_GENERATOR.get_state(), _NP_RNG[0].bit_generator.state)


def set_state(state):
    """Restores states captured by :func:`get_state`
    (reference ``kaolin/ops/random.py:39``)."""
    torch_state, np_state = state
    _GENERATOR.set_state(torch_state)
    _NP_RNG[0].bit_generator.state = np_state
