"""The port's USD I/O (``kaolin_tpu_torch.io.usd`` and ``io.usdc``) against
``kaolin_tpu.io`` on the CPU.

- Bytes: for every case, in ``.usda`` and in ``.usdc``, the file the port
  writes from tensors (the vertices require grad) equals, byte for byte,
  the file ``kaolin_tpu`` writes from the same numpy arrays.
- Cross reads: the port reads ``kaolin_tpu``'s files and ``kaolin_tpu``
  reads the port's, at every authored time, to exactly equal values; the
  port's tensors are float32 (points, uvs, normals, colors), int64 (faces,
  indices) and bool (voxel grids), as ``kaolin_tpu``'s arrays are under
  64-bit mode.
- The crate's pieces: LZ4 blocks (literal runs of every length class,
  matches that overlap their own output, a block above 64 KiB), USD's
  integer delta coding (negative and mixed-width deltas), the scalar
  attribute types, large and empty arrays.
- Scene paths, heterogeneous meshes, materials (with textures, and with
  values only while PIL cannot be imported).
- The reference's pxr-written fixtures, where ``tests/test_usdc.py`` reads
  them (skipped where they are absent, as its cases are).

Inputs are made by numpy from a seed; loaders land on ``device='cpu'``.
The card's round trip (CUDA tensors in, read back onto the card) is
``tests/test_torch_cuda.py``'s ``test_usd_cuda_round_trip``, in a file
that does not import JAX.
"""

import os
import sys

import numpy as np
import pytest
import torch

import kaolin_tpu.io.usd as jusd
import kaolin_tpu.io.usdc as jusdc
import kaolin_tpu.io.materials as jmat
import kaolin_tpu.io.utils as jutils
from kaolin_tpu_torch.io import usd, usdc, utils as io_utils
from kaolin_tpu_torch.io.materials import MaterialManager, PBRMaterial
from test_usdc import FIX


RNG = np.random.default_rng(14)
V = RNG.standard_normal((40, 3)).astype(np.float32)
F = RNG.integers(0, 40, (70, 3))
V2 = RNG.standard_normal((25, 3)).astype(np.float32)
F2 = RNG.integers(0, 25, (31, 3))
UV = RNG.random((210, 2)).astype(np.float32)
FUV = RNG.permutation(210).reshape(70, 3)
FN = RNG.standard_normal((70, 3, 3)).astype(np.float32)
P = RNG.standard_normal((60, 3)).astype(np.float32)
C = RNG.random((60, 3)).astype(np.float32)
N = RNG.standard_normal((60, 3)).astype(np.float32)
VG = RNG.random((9, 9, 9)) > 0.6
VG2 = RNG.random((6, 6, 6)) > 0.3


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """Many small host ops: one intra-op thread keeps them from contending
    with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(a):
    return a


def _t(a):
    """The port's input: a tensor; float arrays require grad."""
    t = torch.tensor(a)
    return t.requires_grad_(True) if t.is_floating_point() else t


def _mesh_full(m, path, conv):
    m.export_mesh(path, scene_path='/World/Meshes/m', vertices=conv(V),
                  faces=conv(F), uvs=conv(UV), face_uvs_idx=conv(FUV),
                  face_normals=conv(FN))


def _mesh_times(m, path, conv):
    for i, time in enumerate((0, 10, 20)):
        m.export_mesh(path, vertices=conv(V + np.float32(i)), faces=conv(F),
                      time=time)


def _pointcloud(m, path, conv):
    stage = m.create_stage(path)
    m.add_pointcloud(stage, '/World/PointClouds/pc', conv(P), colors=conv(C),
                     normals=conv(N))
    for time in (3, 7):
        m.add_pointcloud(stage, '/World/PointClouds/pc_t', conv(P * time),
                         colors=conv(C), time=time)
    stage.save()


def _voxelgrid(m, path, conv):
    m.export_voxelgrid(path, conv(VG))
    m.export_voxelgrid(path, conv(VG2), scene_path='/World/VoxelGrids/vt',
                       time=5)


def _plural(m, path, conv):
    m.export_meshes(path, vertices=[conv(V), conv(V2)],
                    faces=[conv(F), conv(F2)])
    m.export_pointclouds(path, [conv(P), conv(P[:7])],
                         colors=[conv(C), None])
    m.export_voxelgrids(path, [conv(VG), conv(VG2)])


def _overwrite(m, path, conv):
    m.export_mesh(path, vertices=conv(V), faces=conv(F))
    m.export_mesh(path, vertices=conv(V2), faces=conv(F2))
    m.export_pointcloud(path, conv(P), colors=conv(C))
    m.export_pointcloud(path, conv(P[:9]))


def _empty(m, path, conv):
    m.export_mesh(path, vertices=conv(np.zeros((0, 3), np.float32)),
                  faces=conv(np.zeros((0, 3), np.int64)))
    m.export_pointcloud(path, conv(np.zeros((0, 3), np.float32)))
    m.export_voxelgrid(path, conv(np.zeros((4, 4, 4), bool)))


CASES = {'mesh': _mesh_full, 'mesh_times': _mesh_times,
         'pointcloud': _pointcloud, 'voxelgrid': _voxelgrid,
         'plural': _plural, 'overwrite': _overwrite, 'empty': _empty}


def _write_both(tmp_path, case, ext):
    jpath, tpath = str(tmp_path / f'j.{ext}'), str(tmp_path / f't.{ext}')
    CASES[case](jusd, jpath, _np)
    CASES[case](usd, tpath, _t)
    return jpath, tpath


def _contents(m, path, host):
    """Every mesh, cloud and grid of the file at each authored time (and
    at none): {(scene path, time, field): host array}."""
    times = [None] + m.get_authored_time_samples(path)
    out = {}
    for sp in m.get_scene_paths(path, prim_types='Mesh'):
        for t in times:
            mesh = m.import_mesh(path, sp, with_normals=True, time=t,
                                 **host)
            for k in ('vertices', 'faces', 'uvs', 'face_uvs_idx',
                      'face_normals'):
                out[sp, t, k] = getattr(mesh, k)
    for sp in m.get_pointcloud_scene_paths(path):
        for t in times:
            for k, v in m.import_pointcloud(path, sp, t, **host)._asdict(
                    ).items():
                out[sp, t, k] = v
    clouds = m.get_pointcloud_scene_paths(path)
    for sp in m.get_scene_paths(path, prim_types='PointInstancer'):
        if sp not in clouds:
            for t in times:
                out[sp, t, 'grid'] = m.import_voxelgrid(path, sp, t, **host)
    return out


PORT_DTYPES = {np.dtype(np.float32): torch.float32,
               np.dtype(np.int64): torch.int64, np.dtype(bool): torch.bool}


def _same_contents(jout, tout):
    assert jout.keys() == tout.keys()
    assert jout
    for key, ref in jout.items():
        got = tout[key]
        if ref is None:
            assert got is None, key
            continue
        ref = np.asarray(ref)
        assert got.device.type == 'cpu', key
        assert got.dtype == PORT_DTYPES[ref.dtype], (key, got.dtype,
                                                     ref.dtype)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=str(key))


@pytest.mark.parametrize('ext', ['usda', 'usdc'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_files_equal_kaolin_tpu(tmp_path, case, ext):
    jpath, tpath = _write_both(tmp_path, case, ext)
    with open(jpath, 'rb') as a, open(tpath, 'rb') as b:
        ref, got = a.read(), b.read()
    assert got == ref
    assert (ext == 'usdc') == usdc.is_usdc(tpath)


@pytest.mark.parametrize('ext', ['usda', 'usdc'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_cross_reads(tmp_path, case, ext):
    """The port reads kaolin_tpu's file and kaolin_tpu the port's, to the
    values both read from their own file."""
    jpath, tpath = _write_both(tmp_path, case, ext)
    cpu = {'device': 'cpu'}
    ref = _contents(jusd, jpath, {})
    _same_contents(ref, _contents(usd, jpath, cpu))
    theirs = _contents(jusd, tpath, {})
    assert theirs.keys() == ref.keys()
    for key, val in ref.items():
        if val is None:
            assert theirs[key] is None, key
        else:
            assert theirs[key].dtype == val.dtype, key
            np.testing.assert_array_equal(theirs[key], val, err_msg=str(key))
    _same_contents(theirs, _contents(usd, tpath, cpu))


def test_written_values_read_back_exactly(tmp_path):
    """What the port reads back is what it was given, bit for bit."""
    for ext in ('usda', 'usdc'):
        path = str(tmp_path / f'm.{ext}')
        _mesh_full(usd, path, _t)
        mesh = usd.import_mesh(path, with_normals=True, device='cpu')
        for got, ref in ((mesh.vertices, V), (mesh.faces, F),
                         (mesh.uvs, UV), (mesh.face_uvs_idx, FUV),
                         (mesh.face_normals, FN)):
            np.testing.assert_array_equal(got.numpy(), ref)
        path = str(tmp_path / f'v.{ext}')
        _voxelgrid(usd, path, _t)
        np.testing.assert_array_equal(
            usd.import_voxelgrid(path, device='cpu').numpy(), VG)
        np.testing.assert_array_equal(usd.import_voxelgrid(
            path, '/World/VoxelGrids/vt', time=5, device='cpu').numpy(), VG2)


def test_large_mesh_usdc(tmp_path):
    """A 20,000-vertex mesh (as tests/test_usd_extended.py writes one):
    arrays of hundreds of KB, the same bytes, read back exactly."""
    rng = np.random.default_rng(5)
    v = rng.normal(size=(20_000, 3)).astype(np.float32)
    f = rng.integers(0, 20_000, size=(40_000, 3)).astype(np.int32)
    jpath, tpath = str(tmp_path / 'j.usdc'), str(tmp_path / 't.usdc')
    jusd.export_mesh(jpath, vertices=v, faces=f)
    usd.export_mesh(tpath, vertices=torch.tensor(v), faces=torch.tensor(f))
    with open(jpath, 'rb') as a, open(tpath, 'rb') as b:
        assert a.read() == b.read()
    assert os.path.getsize(tpath) > 200_000
    mesh = usd.import_mesh(jpath, device='cpu')
    np.testing.assert_array_equal(mesh.vertices.numpy(), v)
    np.testing.assert_array_equal(mesh.faces.numpy(), f)
    assert mesh.faces.dtype == torch.int64


@pytest.mark.parametrize('size', [0, 1, 14, 15, 16, 269, 270, 271,
                                  70_000, 200_000])
def test_lz4_literal_blocks(size):
    """The literal-only encoder at every length class of its run (the
    extension bytes start at 15, and grow by one every 255), up to blocks
    above 64 KiB: the same bytes as kaolin_tpu's, decoded back."""
    data = np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    enc = usdc._compress(data)
    assert enc == jusdc._compress(data)
    assert usdc._decompress(enc) == data == jusdc._decompress(enc)


def test_lz4_matches():
    """Blocks with matches, as pxr's LZ4 writes them: a match that copies
    its own output (offset 1 and 4), long match and literal lengths, and
    framed chunks."""
    def seq(lit, off, mlen):
        ext = b''
        tl = min(len(lit), 15)
        if len(lit) >= 15:
            rem = len(lit) - 15
            ext += b'\xff' * (rem // 255) + bytes([rem % 255])
        tm = min(mlen - 4, 15)
        mext = b''
        if mlen - 4 >= 15:
            rem = mlen - 4 - 15
            mext = b'\xff' * (rem // 255) + bytes([rem % 255])
        return (bytes([tl << 4 | tm]) + ext + lit
                + off.to_bytes(2, 'little') + mext)

    block = (seq(b'abcd', 4, 8) + seq(b'x', 1, 600)
             + seq(bytes(range(40)), 45, 20) + b'\x30end')
    want = (b'abcd' * 3 + b'x' * 601 + bytes(range(40))
            + (b'x' * 5 + bytes(range(15))) + b'end')
    assert usdc._lz4_block(block) == want == jusdc._lz4_block(block)
    framed = (b'\x02' + len(block).to_bytes(4, 'little') + block
              + (5).to_bytes(4, 'little') + b'\x40tail')
    assert usdc._decompress(framed) == want + b'tail' \
        == jusdc._decompress(framed)


@pytest.mark.parametrize('vals', [
    [],
    [7],
    [0, -1, -2, -3, 5, -129, 128, -40_000, 40_000, 2**30, -2**30, 0],
    list(range(-300, 300, 7)) + [5] * 20 + [-70_000, 3, 3, 3],
    [-1] * 9 + [0xFFFF, -0xFFFF, 127, -128, 32767, -32768],
])
def test_integer_delta_coding(vals):
    """USD's integer coding (common delta, 2-bit codes, 8/16/32-bit
    deltas) on negative and mixed-width deltas: kaolin_tpu's bytes, and
    the values back."""
    enc = usdc._encode_ints(vals)
    assert enc == jusdc._encode_ints(vals)
    np.testing.assert_array_equal(usdc._decode_ints(enc, len(vals)),
                                  np.asarray(vals, np.int64))
    np.testing.assert_array_equal(jusdc._decode_ints(enc, len(vals)),
                                  np.asarray(vals, np.int64))


@pytest.mark.parametrize('ext', ['usda', 'usdc'])
def test_scalar_attribute_types(tmp_path, ext):
    """Every scalar attribute type of tests/test_usdc_writer.py: the same
    bytes, and the values read back by both packages."""
    def write(m, path):
        stage = m.Stage(path)
        prim = stage.define_prim('/World/shader', 'Shader')
        prim.attrs['info:id'] = ('string', 'UsdPreviewSurface')
        prim.attrs['metallic_value'] = ('float', 0.25)
        prim.attrs['ior_value'] = ('double', 1.5)
        prim.attrs['grid_size'] = ('int', -7)
        prim.attrs['flag'] = ('bool', True)
        prim.attrs['weights'] = ('float[]', np.asarray([1., 2., 3.]))
        prim.attrs['tag'] = ('token', 'kaolin')
        stage.save()

    jpath, tpath = str(tmp_path / f'j.{ext}'), str(tmp_path / f't.{ext}')
    write(jusd, jpath)
    write(usd, tpath)
    with open(jpath, 'rb') as a, open(tpath, 'rb') as b:
        assert a.read() == b.read()
    ref = jusd.Stage.load(jpath).get_prim('/World/shader')
    back = usd.Stage.load(jpath).get_prim('/World/shader')
    assert back.type_name == ref.type_name == 'Shader'
    assert back.attrs.keys() == ref.attrs.keys()
    for name, (typ, val) in ref.attrs.items():
        assert back.attrs[name][0] == typ
        np.testing.assert_array_equal(back.attrs[name][1], val)
        assert type(back.attrs[name][1]) is type(val)
    assert back.attrs['grid_size'][1] == -7
    assert back.attrs['flag'][1] is True


def test_scene_paths(tmp_path):
    """get_scene_paths with a regex and with prim types, and the other
    stage-level helpers, as kaolin_tpu answers them."""
    paths = {}
    for name, m, conv in (('j', jusd, _np), ('t', usd, _t)):
        path = str(tmp_path / f'{name}.usda')
        stage = m.create_stage(path)
        m.add_mesh(stage, '/World/objA', vertices=conv(V), faces=conv(F))
        m.add_mesh(stage, '/World/objB', vertices=conv(V), faces=conv(F),
                   time=4)
        m.add_pointcloud(stage, '/World/cloud0', conv(P), time=2)
        m.add_voxelgrid(stage, '/World/grid0', conv(VG), time=9)
        stage.save()
        paths[name] = path
    j, t = paths['j'], paths['t']
    for kwargs in ({}, {'scene_path_regex': '.*objA.*'},
                   {'scene_path_regex': '/World/obj'},
                   {'prim_types': ['Mesh']}, {'prim_types': 'Points'},
                   {'prim_types': ['Mesh', 'PointInstancer']},
                   {'scene_path_regex': '.*B', 'prim_types': ['Mesh']}):
        assert usd.get_scene_paths(t, **kwargs) \
            == jusd.get_scene_paths(j, **kwargs), kwargs
    assert len(usd.get_scene_paths(t, scene_path_regex='.*objA.*')) == 1
    assert usd.get_scene_paths(t, prim_types=['Mesh']) == [
        '/World/objA', '/World/objB']
    assert usd.get_pointcloud_scene_paths(t) \
        == jusd.get_pointcloud_scene_paths(j) == ['/World/cloud0']
    assert usd.get_authored_time_samples(t) \
        == jusd.get_authored_time_samples(j) == [2., 4., 9.]
    assert usd.get_root(t) == jusd.get_root(j) == '/'
    assert usd.get_pointcloud_bracketing_time_samples(t, '/World/cloud0', 5) \
        == jusd.get_pointcloud_bracketing_time_samples(j, '/World/cloud0', 5)


def _mixed_mesh(m, path):
    """A tri and a quad, with uvs through explicit indices."""
    stage = m.Stage(path)
    prim = stage.define_prim('/World/mixed', 'Mesh')
    prim.attrs['points'] = ('point3f[]', V[:5])
    prim.attrs['faceVertexCounts'] = ('int[]', np.array([3, 4]))
    prim.attrs['faceVertexIndices'] = ('int[]', np.array([0, 1, 2,
                                                          1, 2, 3, 4]))
    prim.attrs['primvars:st'] = ('texCoord2f[]', UV[:7])
    prim.attrs['primvars:st:indices'] = ('int[]', np.arange(7)[::-1].copy())
    stage.save()


@pytest.mark.parametrize('ext', ['usda', 'usdc'])
def test_heterogeneous_meshes(tmp_path, ext):
    path = str(tmp_path / f'mixed.{ext}')
    _mixed_mesh(jusd, path)
    with pytest.raises(io_utils.NonHomogeneousMeshError):
        usd.import_mesh(path, device='cpu')
    ref = jusd.import_mesh(
        path, heterogeneous_mesh_handler=(
            jutils.heterogeneous_mesh_handler_naive_homogenize))
    got = usd.import_mesh(
        path, heterogeneous_mesh_handler=(
            io_utils.heterogeneous_mesh_handler_naive_homogenize),
        device='cpu')
    for k in ('vertices', 'faces', 'uvs', 'face_uvs_idx'):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k)))
    assert got.faces.dtype == torch.int64 and got.faces.shape == (3, 3)
    assert usd.import_meshes(path, heterogeneous_mesh_handler=(
        io_utils.heterogeneous_mesh_handler_skip), device='cpu') == []


def _textured(mod, torch_side):
    rng = np.random.default_rng(3)
    tex = {'diffuse_texture': rng.random((3, 8, 8)).astype(np.float32),
           'roughness_texture': rng.random((1, 8, 8)).astype(np.float32),
           'normals_texture': rng.uniform(-1, 1, (3, 8, 8)).astype(
               np.float32)}
    if torch_side:
        tex = {k: torch.tensor(v) for k, v in tex.items()}
    return mod.PBRMaterial(name='mat', diffuse_color=(0.2, 0.4, 0.6),
                           roughness_value=0.3, is_specular_workflow=True,
                           diffuse_colorspace='sRGB', **tex)


@pytest.mark.parametrize('ext', ['usda', 'usdc'])
def test_material_with_textures(tmp_path, ext):
    """A PBRMaterial with three textures: the USD file and the PNGs equal
    kaolin_tpu's, and both read them back to the same material. (Neither
    crate writer can write the ``rel`` of a binding, so the usdc file
    binds no mesh.)"""
    root = {}
    for name, mod, torch_side in (('j', jmat, False),
                                  ('t', sys.modules[PBRMaterial.__module__],
                                   True)):
        root[name] = tmp_path / name
        root[name].mkdir()
        path = str(root[name] / f'scene.{ext}')
        mat = _textured(mod, torch_side)
        mat.write_to_usd(path, '/World/Looks/mat', texture_dir='tex',
                         bound_prims=(['/World/Meshes/m'] if ext == 'usda'
                                      else None))
    files = sorted(p.relative_to(root['j'])
                   for p in root['j'].rglob('*') if p.is_file())
    assert len(files) == 4
    assert files == sorted(p.relative_to(root['t'])
                           for p in root['t'].rglob('*') if p.is_file())
    for rel in files:
        assert (root['j'] / rel).read_bytes() == (root['t'] / rel).read_bytes()
    jpath = str(root['j'] / f'scene.{ext}')
    ref = jmat.PBRMaterial.read_from_usd(jpath, '/World/Looks/mat')
    got = PBRMaterial.read_from_usd(jpath, '/World/Looks/mat', device='cpu')
    via_stage = MaterialManager.read_usd_material(
        usd.Stage.load(jpath), '/World/Looks/mat', device='cpu')
    for out in (got, via_stage):
        assert out.to_dict().keys() == ref.to_dict().keys()
        for k, v in ref.to_dict().items():
            if k.endswith('_texture') and v is not None:
                assert getattr(out, k).dtype == torch.float32
                np.testing.assert_array_equal(getattr(out, k).numpy(),
                                              np.asarray(v))
            else:
                assert out.to_dict()[k] == v, k
    assert got.diffuse_texture is not None and got.diffuse_colorspace == 'sRGB'


@pytest.mark.parametrize('ext', ['usda', 'usdc'])
def test_value_material_without_pil(tmp_path, monkeypatch, ext):
    """A material with values only is written and read while PIL cannot
    be imported, to kaolin_tpu's bytes (written while it could), and read
    back as kaolin_tpu reads it (usdc keeps float32 values)."""
    kwargs = dict(name='plain', diffuse_color=(0.1, 0.2, 0.3),
                  metallic_value=0.7, opacity_value=0.5)
    jpath, tpath = str(tmp_path / f'j.{ext}'), str(tmp_path / f't.{ext}')
    jmat.PBRMaterial(**kwargs).write_to_usd(jpath, '/World/Looks/plain')
    monkeypatch.setitem(sys.modules, 'PIL', None)
    monkeypatch.setitem(sys.modules, 'PIL.Image', None)
    with pytest.raises(ImportError):
        from PIL import Image  # noqa: F401
    PBRMaterial(**kwargs).write_to_usd(tpath, '/World/Looks/plain')
    with open(jpath, 'rb') as a, open(tpath, 'rb') as b:
        assert a.read() == b.read()
    back = PBRMaterial.read_from_usd(tpath, '/World/Looks/plain',
                                     device='cpu')
    ref = jmat.PBRMaterial.read_from_usd(jpath, '/World/Looks/plain')
    assert back.to_dict() == ref.to_dict()
    assert back.material_name == 'plain'
    if ext == 'usda':
        assert back.to_dict() == PBRMaterial(**kwargs).to_dict()


def test_inputs_requiring_grad_are_left_alone(tmp_path):
    """Tensors that require grad (and non-contiguous views) are written as
    their values; the inputs keep their grad and values."""
    v = torch.tensor(V, requires_grad=True)
    w = v * 2.
    faces = torch.tensor(F).t().contiguous().t()
    assert not faces.is_contiguous()
    path = str(tmp_path / 'g.usda')
    usd.export_mesh(path, vertices=w, faces=faces)
    w.sum().backward()
    assert torch.equal(v.grad, torch.full_like(v, 2.))
    mesh = usd.import_mesh(path, device='cpu')
    assert torch.equal(mesh.vertices, w.detach())
    assert torch.equal(mesh.faces, torch.tensor(F))
    assert not mesh.vertices.requires_grad


# The reference's pxr-written fixtures, read as tests/test_usdc.py reads
# them, by both packages.
needs_fixtures = pytest.mark.skipif(not os.path.isdir(FIX),
                                    reason='reference fixtures unavailable')


@needs_fixtures
def test_fixture_magic_detection():
    assert usdc.is_usdc(os.path.join(FIX, 'ground_truth', 'mesh_0.usd'))


@needs_fixtures
def test_fixture_mesh_final_iterate():
    out = usd.import_mesh(os.path.join(FIX, 'output', 'mesh_0.usd'),
                          time=100, device='cpu')
    gt = usd.import_mesh(os.path.join(FIX, 'ground_truth', 'mesh_0.usd'),
                         time=0, device='cpu')
    ref = jusd.import_mesh(os.path.join(FIX, 'output', 'mesh_0.usd'),
                           time=100)
    np.testing.assert_allclose(out.vertices.numpy(), gt.vertices.numpy(),
                               rtol=1e-6)
    np.testing.assert_array_equal(out.faces.numpy(), gt.faces.numpy())
    np.testing.assert_array_equal(out.vertices.numpy(),
                                  np.asarray(ref.vertices))
    assert out.faces.shape[1] == 3


@needs_fixtures
def test_fixture_mesh_timesamples():
    stage = usd.Stage.load(os.path.join(FIX, 'output', 'mesh_1.usd'))
    _, samples = stage.get_prim('/mesh_1').time_attrs['points']
    assert sorted(samples) == [float(t) for t in range(0, 101, 10)]
    assert all(v.shape == (482, 3) for v in samples.values())
    assert not np.allclose(samples[0.], samples[100.])


@needs_fixtures
def test_fixture_pointclouds():
    inp = usd.import_pointcloud(os.path.join(FIX, 'input',
                                             'pointcloud_0.usd'),
                                time=0, device='cpu').points
    out0 = usd.import_pointcloud(os.path.join(FIX, 'output',
                                              'pointcloud_0.usd'),
                                 time=0, device='cpu').points
    out100 = usd.import_pointcloud(os.path.join(FIX, 'output',
                                                'pointcloud_0.usd'),
                                   time=100, device='cpu').points
    assert inp.shape == out0.shape == (1432, 3)
    assert not torch.allclose(out0, out100)


@needs_fixtures
def test_fixture_voxelgrids():
    path = os.path.join(FIX, 'output', 'voxelgrid_0.usd')
    vg0 = usd.import_voxelgrid(path, time=0, device='cpu')
    vg100 = usd.import_voxelgrid(path, time=100, device='cpu')
    assert vg0.shape == vg100.shape == (30, 30, 30)
    assert vg0.dtype == torch.bool
    assert int(vg0.sum()) == 1277 and int(vg100.sum()) == 1290


@needs_fixtures
def test_fixture_usdc_to_usda(tmp_path):
    vg = usd.import_voxelgrid(os.path.join(FIX, 'output', 'voxelgrid_1.usd'),
                              time=100, device='cpu')
    p = str(tmp_path / 'vg.usda')
    usd.export_voxelgrid(p, vg)
    assert torch.equal(usd.import_voxelgrid(p, device='cpu'), vg)
    mesh = usd.import_mesh(os.path.join(FIX, 'output', 'mesh_0.usd'),
                           time=50, device='cpu')
    p = str(tmp_path / 'm.usda')
    usd.export_mesh(p, vertices=mesh.vertices, faces=mesh.faces)
    back = usd.import_mesh(p, device='cpu')
    assert torch.equal(back.vertices, mesh.vertices)
    assert torch.equal(back.faces, mesh.faces)
