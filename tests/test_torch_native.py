"""The port's native host library (``kaolin_tpu_torch/csrc/core.cpp``)
against its numpy plain versions on the CPU.

Held: the Morton codes and the octree bytes against the port's numpy
versions and ``kaolin_tpu``'s ``_morton_np``; the voxelization, as sets,
against the port's ``_voxelize_triangles_np`` and ``kaolin_tpu``'s (which
the JAX package runs when its library is missing); the capacity loops'
re-run; the port's octree builds against ``_octree_bytes``; OBJ parsing
of a written file with known answers; a failed build raising with the
compiler's log; and four processes building into one empty build
directory at once, each loading a whole library. Nothing here calls
``kaolin_tpu.native``.
"""

import ctypes
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from kaolin_tpu.ops.conversions.mesh import _voxelize_triangles_np as \
    jax_voxelize_np
from kaolin_tpu.ops.spc.points import _morton_np as jax_morton_np
import kaolin_tpu_torch as kt
from kaolin_tpu_torch import native
from kaolin_tpu_torch.kernels import _build
from kaolin_tpu_torch.ops.conversions.mesh import _voxelize_triangles_np
from kaolin_tpu_torch.ops.spc.points import _morton_np, _octree_bytes

ROOT = Path(__file__).resolve().parent.parent


def _rows(a):
    return {tuple(r) for r in np.asarray(a).tolist()}


def test_morton_roundtrip():
    rng = np.random.default_rng(0)
    pts = rng.integers(0, 1024, (500, 3)).astype(np.int16)
    m = native.points_to_morton_fast(pts)
    assert m.dtype == np.int64
    np.testing.assert_array_equal(m, _morton_np(pts))
    np.testing.assert_array_equal(m, jax_morton_np(pts))
    np.testing.assert_array_equal(native.morton_to_points_fast(m), pts)
    with pytest.raises(ValueError):
        native.points_to_morton_fast(pts[:, :2])


@pytest.mark.parametrize('level,n', [(1, 5), (6, 800), (10, 3000)])
def test_octree_matches_numpy(level, n):
    rng = np.random.default_rng(level)
    pts = rng.integers(0, 2 ** level, (n, 3)).astype(np.int16)
    fast = native.points_to_octree_fast(pts, level)
    assert fast.dtype == np.uint8
    np.testing.assert_array_equal(
        fast, _octree_bytes(np.unique(_morton_np(pts)), level))
    # the port's builds route through the library
    out = kt.ops.spc.unbatched_points_to_octree(torch.tensor(pts), level)
    np.testing.assert_array_equal(out.numpy(), fast)


def test_feature_grids_octree_bytes():
    grid = np.zeros((2, 1, 5, 6, 7))
    rng = np.random.default_rng(1)
    grid[rng.random(grid.shape) < 0.3] = 1.
    octrees, lengths, _ = kt.ops.spc.feature_grids_to_spc(torch.tensor(grid))
    start = 0
    for b, n in enumerate(lengths):
        idx = np.argwhere(grid[b, 0] != 0)
        np.testing.assert_array_equal(
            octrees[start:start + n].numpy(),
            _octree_bytes(np.sort(_morton_np(idx)), 3))
        start += n


def _mesh(seed, num_faces, level):
    """Random triangles in grid coords, some degenerate (a point, a
    segment, a repeated vertex)."""
    rng = np.random.default_rng(seed)
    res = 2 ** level
    v = rng.uniform(0.3, res - 0.3, (num_faces * 3, 3)).astype(np.float32)
    f = np.arange(num_faces * 3).reshape(-1, 3)
    v[f[0]] = v[f[0, 0]]                       # a point
    v[f[1, 2]] = 0.5 * (v[f[1, 0]] + v[f[1, 1]])   # a segment
    f[2, 2] = f[2, 0]                           # a repeated vertex
    return v, f


@pytest.mark.parametrize('level,num_faces', [(3, 20), (5, 40), (7, 12)])
def test_voxelize_matches_numpy(level, num_faces):
    v, f = _mesh(level, num_faces, level)
    fast = native.voxelize_triangles_fast(v, f, level)
    assert fast.dtype == np.int16 and fast.shape[1] == 3
    m = _morton_np(fast)
    assert (np.diff(m) > 0).all()               # unique, in Morton order
    assert _rows(fast) == _rows(_voxelize_triangles_np(v, f, level))
    assert _rows(fast) == _rows(jax_voxelize_np(v, f, level))
    assert _rows(fast) == _rows(kt.ops.conversions.voxelize_triangles(
        torch.tensor(v), torch.tensor(f), level))


def test_voxelize_capacity_rerun():
    """One triangle across a level-8 grid covers more voxels than the
    first capacity (1,024): the loop re-runs with a larger one."""
    res = 256
    v = np.array([[0.5, 0.5, 3.], [res - 0.5, 0.5, 3.], [0.5, res - 0.5, 3.]],
                 np.float32)
    f = np.array([[0, 1, 2]])
    lib = native.get_lib()
    out = np.empty((1024, 3), np.int16)
    assert lib.voxelize_triangles(v.ctypes.data, 3, f.ctypes.data, 1, 8,
                                  out.ctypes.data, 1024) == -1
    fast = native.voxelize_triangles_fast(v, f, 8)
    assert fast.shape[0] > 1024
    assert _rows(fast) == _rows(_voxelize_triangles_np(v, f, 8))
    pts = np.random.default_rng(2).integers(0, 64, (100, 3)).astype(np.int16)
    small = np.empty(8, np.uint8)
    assert lib.points_to_octree(pts.ctypes.data, 100, 6, small.ctypes.data,
                                8) == -1


def test_obj_parse(tmp_path):
    p = tmp_path / 'a.obj'
    p.write_text("# c\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1.5\n"
                 "vt 0 0\nf 1/1 2/2 3/3\nf 1 3 4\nf -4 -3 -2 -1\n")
    v, f, homo = native.obj_parse_fast(str(p))
    assert v.dtype == np.float32 and f.dtype == np.int64
    np.testing.assert_array_equal(v, [[0, 0, 0], [1, 0, 0], [0, 1, 0],
                                      [0, 0, 1.5]])
    np.testing.assert_array_equal(f, [[0, 1, 2], [0, 2, 3], [0, 1, 2],
                                      [0, 2, 3]])
    assert homo == -1           # a triangle and a quad
    q = tmp_path / 'b.obj'
    q.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    assert native.obj_parse_fast(q)[2] == 3
    assert native.obj_parse_fast(str(tmp_path / 'missing.obj')) is None


def test_failed_build_raises_with_log(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, '_BUILD_DIR', tmp_path)
    monkeypatch.setattr(_build, '_loaded', {})
    monkeypatch.setattr(_build, 'HOST_FLAGS',
                        _build.HOST_FLAGS + ('-no-such-flag',))
    with pytest.raises(RuntimeError, match='g\\+\\+ failed on csrc/core.cpp'
                       '(.|\\n)*no-such-flag'):
        native.get_lib()
    assert not list(tmp_path.iterdir())


_CHILD = textwrap.dedent('''
    import sys, time
    from pathlib import Path
    from kaolin_tpu_torch.kernels import _build
    from kaolin_tpu_torch import native
    build = Path(sys.argv[1])
    _build._BUILD_DIR = build
    (build.parent / f'ready-{sys.argv[2]}').touch()
    t0 = time.time()
    while not (build.parent / 'go').exists():
        if time.time() - t0 > 60:
            sys.exit('no go')
        time.sleep(0.001)
    print(native.points_to_octree_fast([[1, 2, 3], [7, 0, 5]], 3).tolist())
''')


def test_concurrent_builds_all_load(tmp_path):
    """Four processes build the library into one empty directory at once:
    each writes its own file and renames it into place, so each loads a
    whole library."""
    build = tmp_path / 'build'
    procs = [subprocess.Popen([sys.executable, '-c', _CHILD, str(build),
                               str(i)], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(4)]
    try:
        t0 = time.time()
        while len(list(tmp_path.glob('ready-*'))) < 4:
            assert time.time() - t0 < 120, 'children did not start'
            assert all(p.poll() is None for p in procs)
            time.sleep(0.01)
        assert not build.exists()
        (tmp_path / 'go').touch()
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    ref = native.points_to_octree_fast([[1, 2, 3], [7, 0, 5]], 3).tolist()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == str(ref)
    assert [q.suffix for q in build.iterdir()] == ['.so']
    ctypes.CDLL(str(next(build.iterdir())))
