"""The port's ``io`` package (OBJ, OFF, materials, synthetic views,
datasets) against ``kaolin_tpu.io`` on the same files, written into
``tmp_path``, as ``tests/test_io.py`` writes them.

Loaders land on ``device='cpu'`` here (their default is 'cuda'). Values
must be equal: both packages parse the same text into float32 and int64.
The reference fixtures' case reads them where ``tests/test_io.py`` does,
and skips where they are absent, as its cases do. With PIL hidden, OBJ
(with a Kd-only material) and OFF files load.
"""

import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

import kaolin_tpu.io as jio
import kaolin_tpu_torch as kt
from test_io import REF_SAMPLES
from kaolin_tpu_torch.io import obj, off, utils as io_utils
from kaolin_tpu_torch.io.materials import (MaterialFileError,
                                           MaterialLoadError,
                                           MaterialManager,
                                           MaterialNotFoundError,
                                           PBRMaterial)


OBJ_TEXT = """
mtllib test.mtl
v 0 0 0
v 1 0 0
v 0 1 0
v 0 0 1.5
vt 0 0
vt 1 0
vt 0 1
vn 0 0 1
vn 0 1 0
usemtl red
f 1/1/1 2/2/1 3/3/1
usemtl blue
f 1/1/2 3/3/2 4/2/2
usemtl red
f 2/2 3/3 4/1
"""

MTL_TEXT = """
newmtl red
Kd 1.0 0.0 0.0
Ka 0.1 0.1 0.1
newmtl blue
Kd 0.0 0.0 1.0
Ks 0.5 0.5 0.5
map_Kd tex.png
"""


def _eq(ref, out):
    """A ``kaolin_tpu`` value and the port's: None, dicts, lists and
    arrays equal, tensors on the CPU."""
    if ref is None:
        assert out is None
    elif isinstance(ref, dict):
        assert list(ref) == list(out)
        for k in ref:
            _eq(ref[k], out[k])
    elif isinstance(ref, (list, tuple)):
        assert len(ref) == len(out)
        for a, b in zip(ref, out):
            _eq(a, b)
    elif not hasattr(ref, 'shape'):
        assert ref == out
    else:
        assert out.device.type == 'cpu'
        np.testing.assert_array_equal(np.asarray(ref), out.numpy())
        assert np.asarray(ref).dtype.itemsize == out.element_size()


@pytest.fixture
def obj_file(tmp_path):
    from PIL import Image
    p = tmp_path / 'test.obj'
    p.write_text(OBJ_TEXT)
    (tmp_path / 'test.mtl').write_text(MTL_TEXT)
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)).save(
        tmp_path / 'tex.png')
    return str(p)


@pytest.mark.parametrize('with_materials', [False, True])
@pytest.mark.parametrize('with_normals', [False, True])
def test_obj_matches_kaolin_tpu(obj_file, with_materials, with_normals):
    kw = dict(with_materials=with_materials, with_normals=with_normals)
    ref = jio.obj.import_mesh(obj_file, **kw)
    out = obj.import_mesh(obj_file, device='cpu', **kw)
    assert out._fields == ref._fields
    for r, o in zip(ref, out):
        _eq(r, o)
    assert out.faces.shape == (3, 3)
    if with_materials:
        assert out.materials[1]['map_Kd'].dtype == torch.uint8
        np.testing.assert_array_equal(out.materials_order.numpy(),
                                      [[0, 0], [1, 1], [0, 2]])


def test_obj_plain_geometry_fast_path(tmp_path):
    """Plain triangles go through the host library's parser."""
    rng = np.random.default_rng(1)
    v = rng.random((30, 3)).astype(np.float32)
    f = rng.integers(0, 30, (50, 3))
    p = tmp_path / 'plain.obj'
    p.write_text(''.join(f'v {a:.6f} {b:.6f} {c:.6f}\n' for a, b, c in v)
                 + ''.join(f'f {a + 1} {b + 1} {c + 1}\n' for a, b, c in f))
    ref = jio.obj.import_mesh(str(p))
    out = obj.import_mesh(str(p), device='cpu')
    for r, o in zip(ref, out):
        _eq(r, o)
    np.testing.assert_array_equal(out.faces.numpy(), f)


HETERO = ("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nv 1 1 1\nvt 0 0\nvt 1 1\n"
          "f 1/1 2/2 3/1\nf 1/2 2/1 3/2 4/1\nf 1/1 2/1 3/1 4/2 5/2\n")


@pytest.mark.parametrize('handler', [
    'heterogeneous_mesh_handler_naive_homogenize',
    'heterogeneous_mesh_handler_empty', 'heterogeneous_mesh_handler_skip'])
@pytest.mark.parametrize('with_materials', [False, True])
def test_obj_heterogeneous_handlers(tmp_path, handler, with_materials):
    p = tmp_path / 'het.obj'
    p.write_text(HETERO)
    with pytest.raises(io_utils.NonHomogeneousMeshError):
        obj.import_mesh(str(p), device='cpu')
    kw = dict(with_materials=with_materials)
    ref = jio.obj.import_mesh(
        str(p), heterogeneous_mesh_handler=getattr(jio.utils, handler), **kw)
    out = obj.import_mesh(
        str(p), heterogeneous_mesh_handler=getattr(io_utils, handler),
        device='cpu', **kw)
    if ref is None:
        assert out is None
        return
    for name, r, o in zip(ref._fields, ref, out):
        if name == 'vertices' and r.shape[0] == 0:
            assert tuple(o.shape) == (0, 3)
        else:
            _eq(r, o)


def test_obj_material_errors(tmp_path, obj_file):
    """A missing library, a missing material and an unreadable texture go
    to the error handler, as in ``kaolin_tpu``."""
    p = tmp_path / 'bad.obj'
    p.write_text('mtllib none.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\n'
                 'usemtl nothing\nf 1 2 3\n')
    for mod in (jio.obj, obj):
        with pytest.raises(jio.materials.MaterialFileError
                           if mod is jio.obj else MaterialFileError):
            mod.import_mesh(str(p), with_materials=True)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter('always')
        out = obj.import_mesh(str(p), with_materials=True, device='cpu',
                              error_handler=obj.skip_error_handler)
    assert out.materials == [{}] and len(seen) == 2
    (tmp_path / 'tex.png').write_text('not an image')
    with pytest.raises(kt.io.materials.MaterialLoadError):
        obj.import_mesh(obj_file, with_materials=True, device='cpu')
    with pytest.raises(MaterialNotFoundError):
        obj.default_error_handler(MaterialNotFoundError('x'))


OFF_CASES = {
    'header line': "OFF\n4 2 0\n0 0 0\n1 0 0\n0 1 0\n0 0 1\n"
                   "3 0 1 2 255 0 0\n3 0 2 3 0 255 0\n",
    'counts on the header': "OFF 4 2 0\n# comment\n0 0 0\n1 0 0\n0 1 0\n"
                            "0 0 1\n\n3 0 1 2 255 0 0\n3 0 2 3 0 255 0\n",
    'no header, quads': "# c\n5 2 0\n0 0 0\n1 0 0\n0 1 0\n0 0 1\n1 1 1\n"
                        "4 0 1 2 3 1 2 3\n4 1 2 3 4 4 5 6\n",
}


@pytest.mark.parametrize('case', list(OFF_CASES))
@pytest.mark.parametrize('with_face_colors', [False, True])
def test_off_matches_kaolin_tpu(tmp_path, case, with_face_colors):
    p = tmp_path / 'test.off'
    p.write_text(OFF_CASES[case])
    ref = jio.off.import_mesh(str(p), with_face_colors=with_face_colors)
    out = off.import_mesh(str(p), with_face_colors=with_face_colors,
                          device='cpu')
    for r, o in zip(ref, out):
        _eq(r, o)


def test_pbr_material_obj_roundtrip(tmp_path):
    """``write_to_obj`` then ``read_from_obj`` (values, textures through
    PNG, the normal map's [-1, 1]), against ``kaolin_tpu`` reading the
    same library; ``to_dict`` / ``from_dict``; the manager's .mtl reader;
    the USD methods' round trip, against ``kaolin_tpu`` reading the same
    USD file."""
    rng = np.random.default_rng(2)
    tex = torch.tensor(rng.random((3, 6, 5)), dtype=torch.float32)
    nrm = torch.tensor(rng.uniform(-1, 1, (3, 6, 5)), dtype=torch.float32)
    mat = PBRMaterial(name='m0', diffuse_color=(0.2, 0.3, 0.4),
                      roughness_value=0.7, metallic_value=0.9,
                      diffuse_texture=tex, normals_texture=nrm,
                      is_specular_workflow=True)
    mtl = mat.write_to_obj(str(tmp_path), texture_prefix='t_')
    out = PBRMaterial.read_from_obj(mtl, device='cpu')
    ref = jio.materials.PBRMaterial.read_from_obj(mtl)
    od, rd = out.to_dict(), ref.to_dict()
    assert list(od) == list(rd)
    for k in rd:
        if isinstance(rd[k], np.ndarray):
            np.testing.assert_array_equal(rd[k], od[k])
        else:
            assert rd[k] == od[k], k
    np.testing.assert_allclose(out.diffuse_texture.numpy(), tex.numpy(),
                               atol=1 / 255.)
    np.testing.assert_allclose(out.normals_texture.numpy(), nrm.numpy(),
                               atol=2 / 255.)
    again = PBRMaterial.from_dict(od, device='cpu')
    assert torch.equal(again.diffuse_texture, out.diffuse_texture)
    assert again.is_specular_workflow and again.roughness_value == 0.7
    default = MaterialManager._obj_reader
    MaterialManager.register_obj_reader(
        lambda path: PBRMaterial.read_from_obj(path, device='cpu'))
    try:
        via = MaterialManager.read_from_file(mtl)
    finally:
        MaterialManager.register_obj_reader(default)
    assert via.diffuse_color == out.diffuse_color
    assert torch.equal(via.diffuse_texture, out.diffuse_texture)
    usd_path = str(tmp_path / 'm.usda')
    mat.write_to_usd(usd_path, '/World/Looks/m0')
    back = PBRMaterial.read_from_usd(usd_path, '/World/Looks/m0',
                                     device='cpu')
    ref = jio.materials.PBRMaterial.read_from_usd(usd_path, '/World/Looks/m0')
    bd, rd = back.to_dict(), ref.to_dict()
    assert list(bd) == list(rd)
    for k in rd:
        if isinstance(rd[k], np.ndarray):
            np.testing.assert_array_equal(rd[k], bd[k])
        else:
            assert rd[k] == bd[k], k
    assert back.diffuse_texture is not None
    with pytest.raises(MaterialLoadError):
        MaterialManager.read_from_file(usd_path, 'World')


def _png(path, arr):
    from PIL import Image
    Image.fromarray(arr).save(path)


def test_import_synthetic_view_matches_kaolin_tpu(tmp_path):
    rng = np.random.default_rng(3)
    _png(tmp_path / '0_rgb.png', rng.integers(0, 256, (6, 8, 4), np.uint8))
    _png(tmp_path / '0_normals.png', rng.integers(0, 256, (6, 8, 3),
                                                  np.uint8))
    np.save(tmp_path / '0_depth_linear.npy', rng.random((6, 8)))
    np.save(tmp_path / '0_semantic.npy', rng.integers(0, 5, (6, 8)))
    meta = {'asset_transforms': [['a', rng.random((4, 4)).tolist()]],
            'camera_properties': {
                'tf_mat': rng.random((4, 4)).tolist(),
                'resolution': {'width': 8, 'height': 6},
                'focal_length': 24., 'horizontal_aperture': 20.955,
                'clipping_range': [0.01, 100.]},
            'bbox_2d_tight': [[1, 2, 3, 4]], 'bbox_2d_loose': [[0, 1, 4, 5]]}
    (tmp_path / '0_metadata.json').write_text(json.dumps(meta))
    kw = dict(rgb=True, depth_linear=True, semantic=True, instance=True,
              normals=True, bbox_2d_tight=True, bbox_2d_loose=True)
    ref = jio.render.import_synthetic_view(str(tmp_path), 0, **kw)
    out = kt.io.render.import_synthetic_view(str(tmp_path), 0,
                                             device='cpu', **kw)
    assert out['instance'] is None
    _eq(ref, out)


class _ToyDataset(kt.io.dataset.KaolinDataset):
    def __len__(self):
        return 5

    def get_data(self, i):
        return {'x': torch.full((2, 2), float(i)), 'n': i}

    def get_attributes(self, i):
        return {'name': f'item_{i}'}


def test_datasets_cache_numpy(tmp_path):
    """``Cache`` and ``CachedDataset`` give numpy, as ``kaolin_tpu``'s;
    the second instantiation reads the disk cache."""
    ds = _ToyDataset()
    assert ds[2].attributes['name'] == 'item_2'
    cached = kt.io.dataset.CachedDataset(ds, str(tmp_path / 'cache'))
    got = cached[3]
    assert isinstance(got.data['x'], np.ndarray)
    np.testing.assert_array_equal(got.data['x'], np.full((2, 2), 3.))
    assert got.data['n'] == 3
    calls = []
    cached2 = kt.io.dataset.CachedDataset(
        ds, str(tmp_path / 'cache'), transform=lambda s: calls.append(s))
    np.testing.assert_array_equal(cached2[3].data['x'], np.full((2, 2), 3.))
    assert not calls
    cache = kt.io.dataset.Cache(lambda a: torch.arange(a), str(tmp_path / 'c'),
                                'k')
    assert cache.try_get('k4') is None
    np.testing.assert_array_equal(cache('k4', 4), np.arange(4))
    np.testing.assert_array_equal(cache.try_get('k4'), np.arange(4))
    processed = kt.io.dataset.ProcessedDataset(
        ds, lambda d: {'x': d['x'] * 2}, cache_dir=str(tmp_path / 'proc'))
    np.testing.assert_array_equal(processed[2].data['x'], np.full((2, 2), 4))
    assert processed[2].attributes == {'name': 'item_2'}
    combo = kt.io.dataset.CombinationDataset([ds, ds])
    assert len(combo) == 5
    assert torch.equal(combo[1].data[0]['x'], combo[1].data[1]['x'])


def _tree(root, files):
    for rel, text in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)


TRI = "v 0 0 0\nv 1 0 0\nv 0 1 {z}\nf 1 2 3\n"
OFF_TRI = "OFF\n3 1 0\n0 0 0\n1 0 0\n0 1 {z}\n3 0 1 2\n"


def test_dataset_wrappers_match_kaolin_tpu(tmp_path):
    """ModelNet (OFF), ShapeNet V1 / V2 and SHREC16 (OBJ) on directory
    trees of their layouts: lengths, attributes and meshes equal."""
    _tree(tmp_path / 'mn', {f'{c}/{s}/m{i}.off': OFF_TRI.format(z=i)
                            for c in ('chair', 'desk') for s in ('train',
                                                                 'test')
                            for i in range(2)})
    _tree(tmp_path / 'sn1', {f'03001627/m{i}/model.obj': TRI.format(z=i)
                             for i in range(4)})
    _tree(tmp_path / 'sn2', {f'02691156/m{i}/models/model_normalized.obj':
                             TRI.format(z=i) for i in range(3)})
    _tree(tmp_path / 'sh', {f'c{c}/{s}/m{i}.obj': TRI.format(z=i + c)
                            for c in range(2) for s in ('train', 'test')
                            for i in range(2)})
    cases = [
        (jio.modelnet.ModelNet, kt.io.modelnet.ModelNet, 'mn',
         dict(split='test')),
        (jio.shapenet.ShapeNetV1, kt.io.shapenet.ShapeNetV1, 'sn1',
         dict(categories=['chair'], train=False, split=0.5)),
        (jio.shapenet.ShapeNetV2, kt.io.shapenet.ShapeNetV2, 'sn2',
         dict(categories=['plane'])),
        (jio.shrec.SHREC16, kt.io.shrec.SHREC16, 'sh', dict(split='train')),
    ]
    for jcls, tcls, sub, kw in cases:
        ref = jcls(str(tmp_path / sub), **kw)
        out = tcls(str(tmp_path / sub), device='cpu', **kw)
        assert len(out) == len(ref) > 0
        for i in range(len(ref)):
            assert out[i].attributes == ref[i].attributes
            for r, o in zip(ref[i].data, out[i].data):
                _eq(r, o)


def test_geometry_loads_without_pil(tmp_path, monkeypatch):
    """With PIL hidden (importing it raises), OBJ with a Kd-only material
    and OFF files load: only images import PIL. ``import kaolin_tpu_torch``
    imports no PIL (``tests/test_torch_ops.py``'s import scan)."""
    monkeypatch.setitem(sys.modules, 'PIL', None)
    monkeypatch.setitem(sys.modules, 'PIL.Image', None)
    with pytest.raises(ImportError):
        from PIL import Image  # noqa: F401
    (tmp_path / 'a.mtl').write_text('newmtl m\nKd 1 0 0\n')
    (tmp_path / 'a.obj').write_text('mtllib a.mtl\nv 0 0 0\nv 1 0 0\n'
                                    'v 0 1 0\nusemtl m\nf 1 2 3\n')
    (tmp_path / 'a.off').write_text('OFF\n3 1 0\n0 0 0\n1 0 0\n0 1 0\n'
                                    '3 0 1 2\n')
    m = obj.import_mesh(str(tmp_path / 'a.obj'), with_materials=True,
                        with_normals=True, device='cpu')
    assert m.materials[0]['Kd'].tolist() == [1., 0., 0.]
    assert off.import_mesh(str(tmp_path / 'a.off'),
                           device='cpu').faces.shape == (1, 3)


@pytest.mark.skipif(not os.path.isdir(REF_SAMPLES),
                    reason='reference fixtures unavailable')
def test_simple_obj_off_fixtures_match_kaolin_tpu():
    """The reference's simple_obj / simple_off fixtures, as
    ``tests/test_io.py`` reads them."""
    d = os.path.join(REF_SAMPLES, 'simple_obj')
    kw = dict(with_materials=True, with_normals=True)
    for name, extra in (('model.obj', {}), ('model_heterogeneous.obj', {
            'heterogeneous_mesh_handler':
            'heterogeneous_mesh_handler_naive_homogenize'})):
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            ref = jio.obj.import_mesh(
                os.path.join(d, name), error_handler=jio.obj.skip_error_handler,
                **kw, **{k: getattr(jio.utils, v) for k, v in extra.items()})
            out = obj.import_mesh(
                os.path.join(d, name), error_handler=obj.skip_error_handler,
                device='cpu', **kw,
                **{k: getattr(io_utils, v) for k, v in extra.items()})
        for r, o in zip(ref, out):
            _eq(r, o)
    p = os.path.join(REF_SAMPLES, 'simple_off/model.off')
    for r, o in zip(jio.off.import_mesh(p, with_face_colors=True),
                    off.import_mesh(p, with_face_colors=True, device='cpu')):
        _eq(r, o)
