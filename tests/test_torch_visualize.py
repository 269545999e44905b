"""The port's ``visualize.Timelapse`` and ``experimental.dash3d`` against
``kaolin_tpu``'s on the CPU.

- Timelapse: the same batches (tensors that require grad on the port's
  side, numpy arrays on ``kaolin_tpu``'s) at three iterations give log
  directories equal file for file and byte for byte, and
  ``TimelapseParser`` finds the same items in both.
- dash3d: ``StreamingGeometryHelper``'s mesh, point-cloud and voxel-grid
  payloads and its directory info equal ``kaolin_tpu``'s on the same log
  directory; the tornado server's binary protocol as
  ``tests/test_dash3d.py`` drives it; the page and scripts are
  ``kaolin_tpu``'s bytes; importing the package's ``__main__`` starts no
  server.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import kaolin_tpu.experimental.dash3d.util as jutil
import kaolin_tpu.visualize as jvis
import kaolin_tpu_torch.experimental.dash3d.util as tutil
from kaolin_tpu_torch.visualize import Timelapse, TimelapseParser

ROOT = Path(__file__).resolve().parents[1]

RNG = np.random.default_rng(7)
MESHES = [(RNG.standard_normal((12, 3)).astype(np.float32),
           RNG.integers(0, 12, (20, 3))) for _ in range(2)]
UVS = RNG.random((60, 2)).astype(np.float32)
FUV = RNG.permutation(60).reshape(20, 3)
CLOUDS = [RNG.standard_normal((30, 3)).astype(np.float32) for _ in range(2)]
COLORS = [RNG.random((30, 3)).astype(np.float32) for _ in range(2)]
GRIDS = [RNG.random((7, 7, 7)) > 0.5 for _ in range(2)]
ITERATIONS = (0, 10, 20)


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(a, it=0):
    return a + np.float32(it) if a.dtype == np.float32 else a


def _t(a, it=0):
    """The port's batch item: a tensor; float ones require grad and come
    out of an op, as a train step's vertices do."""
    t = torch.tensor(a)
    if not t.is_floating_point():
        return t
    return t.requires_grad_(True) + float(it)


def _log(vis, logdir, conv):
    tl = vis.Timelapse(logdir)
    for it in ITERATIONS:
        tl.add_mesh_batch(iteration=it, category='fit',
                          vertices_list=[conv(v, it) for v, _ in MESHES],
                          faces_list=[conv(f) for _, f in MESHES],
                          uvs_list=[conv(UVS), None],
                          face_uvs_idx_list=[conv(FUV), None])
        tl.add_pointcloud_batch(iteration=it, category='pts',
                                pointcloud_list=[conv(c, it)
                                                 for c in CLOUDS],
                                colors=[conv(c) for c in COLORS])
        tl.add_voxelgrid_batch(iteration=it, category='vox',
                               voxelgrid_list=[conv(g) for g in GRIDS])
    tl.add_mesh_batch(iteration=5, category='target',
                      vertices_list=[conv(MESHES[0][0])],
                      faces_list=[conv(MESHES[0][1])])


@pytest.fixture(scope='module')
def logs(tmp_path_factory):
    root = tmp_path_factory.mktemp('timelapse')
    jdir, tdir = str(root / 'jax'), str(root / 'torch')
    _log(jvis, jdir, _np)
    _log(sys.modules[Timelapse.__module__], tdir, _t)
    return jdir, tdir


def _files(logdir):
    return sorted(str(p.relative_to(logdir))
                  for p in Path(logdir).rglob('*') if p.is_file())


def test_timelapse_dirs_equal(logs):
    jdir, tdir = logs
    files = _files(jdir)
    assert len(files) == 2 + 2 + 2 + 1
    assert files == _files(tdir)
    for rel in files:
        assert (Path(jdir) / rel).read_bytes() == (Path(tdir) / rel
                                                   ).read_bytes(), rel


def _relative(info, logdir):
    return {typ: [dict(i, path=os.path.relpath(i['path'], logdir))
                  for i in items] for typ, items in info.items()}


def test_timelapse_parser(logs, tmp_path):
    jdir, tdir = logs
    ref = jvis.TimelapseParser(jdir)
    got = TimelapseParser(tdir)
    assert _relative(got.dir_info, tdir) == _relative(ref.dir_info, jdir)
    assert got.get_category_list() == ref.get_category_list() == [
        'fit', 'pts', 'target', 'vox']
    for typ in ('mesh', 'pointcloud', 'voxelgrid'):
        assert got.num_items(typ) == ref.num_items(typ)
    assert [os.path.relpath(p, tdir)
            for p in got.get_filepaths('fit', 'mesh')] == [
        os.path.relpath(p, jdir) for p in ref.get_filepaths('fit', 'mesh')]
    assert not got.check_for_updates()
    tl = Timelapse(str(tmp_path))
    parser = TimelapseParser(str(tmp_path))
    tl.add_pointcloud_batch(iteration=30, category='pts',
                            pointcloud_list=[torch.tensor(CLOUDS[0])])
    assert parser.check_for_updates()
    assert not parser.check_for_updates()
    assert parser.num_items('pointcloud') == 1


def test_timelapse_read_back(logs):
    """Each checkpoint reads back as written (the vertices of a tensor
    that required grad, the grids exactly)."""
    from kaolin_tpu_torch.io import usd
    _, tdir = logs
    path = os.path.join(tdir, 'fit', 'mesh_0.usda')
    for it in ITERATIONS:
        mesh = usd.import_mesh(path, time=it, device='cpu')
        np.testing.assert_array_equal(mesh.vertices.numpy(),
                                      MESHES[0][0] + np.float32(it))
        np.testing.assert_array_equal(mesh.faces.numpy(), MESHES[0][1])
        np.testing.assert_array_equal(mesh.uvs.numpy(), UVS)
        np.testing.assert_array_equal(mesh.face_uvs_idx.numpy(), FUV)
        grid = usd.import_voxelgrid(os.path.join(tdir, 'vox',
                                                 'voxelgrid_1.usda'),
                                    time=it, device='cpu')
        assert grid.dtype == torch.bool
        np.testing.assert_array_equal(grid.numpy(), GRIDS[1])


@pytest.mark.parametrize('kind,category,idx', [
    ('mesh', 'fit', 0), ('mesh', 'fit', 1), ('mesh', 'target', 0),
    ('pointcloud', 'pts', 1), ('voxelgrid', 'vox', 0), ('mesh', 'fit', 5)])
@pytest.mark.parametrize('target,current', [(0, None), (12, None),
                                            (17, 10), (20, 20), (99, 0)])
def test_payloads_equal_kaolin_tpu(logs, kind, category, idx, target,
                                   current):
    jdir, _ = logs
    method = {'mesh': 'parse_encode_mesh',
              'pointcloud': 'parse_encode_pointcloud',
              'voxelgrid': 'parse_encode_voxelgrid_as_pointcloud'}[kind]
    ref = getattr(jutil.StreamingGeometryHelper(jdir), method)(
        category, idx, target, current_time=current)
    got = getattr(tutil.StreamingGeometryHelper(jdir), method)(
        category, idx, target, current_time=current)
    assert got == ref


def test_directory_info_equal(logs):
    jdir, tdir = logs
    ref = jutil.StreamingGeometryHelper(jdir).get_directory_info()
    got = tutil.StreamingGeometryHelper(tdir).get_directory_info()
    assert _relative(got, tdir) == _relative(ref, jdir)
    assert got['mesh'][0]['times'] == [0.0, 10.0, 20.0]


def test_payload_decodes_to_checkpoint(logs):
    """The mesh payload, after the 16-byte int32 header, decodes to the
    arrays written at the snapped time."""
    _, tdir = logs
    payload, snap = tutil.StreamingGeometryHelper(tdir).parse_encode_mesh(
        'fit', 0, 12)
    assert snap == 10.0
    head = np.array([tutil.TYPE_MESH, 3, int(snap), 0], np.int32).tobytes()
    out = tutil.decode_binary_message(head + payload)
    assert (out['type_id'], out['view_id'], out['snap_time']) == (0, 3, 10)
    np.testing.assert_array_equal(out['items'][0]['vertices'],
                                  MESHES[0][0] + np.float32(10))
    np.testing.assert_array_equal(out['items'][0]['faces'], MESHES[0][1])
    assert tutil.meshes_to_binary([MESHES[0][0]], [MESHES[0][1]]) \
        == jutil.meshes_to_binary([MESHES[0][0]], [MESHES[0][1]])
    assert tutil.point_clouds_to_binary(CLOUDS) \
        == jutil.point_clouds_to_binary(CLOUDS)


@pytest.mark.parametrize('rel', ['index.html', 'static/geometry.js',
                                 'static/render.js'])
def test_static_files_equal(rel):
    from kaolin_tpu_torch.experimental.dash3d import run
    base = ROOT / 'kaolin_tpu' / 'experimental' / 'dash3d'
    port = Path(run._HTML_PATH).parent
    assert port == ROOT / 'kaolin_tpu_torch' / 'experimental' / 'dash3d'
    assert Path(run._STATIC_DIR) == port / 'static'
    assert (port / rel).read_bytes() == (base / rel).read_bytes()


def test_main_import_starts_no_server():
    """Importing ``__main__`` only defines; ``python -m`` parses the
    arguments (here ``--help``)."""
    code = ('import sys, kaolin_tpu_torch.experimental.dash3d.__main__; '
            'print("tornado" in sys.modules)')
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == 'False', \
        res.stdout + res.stderr
    res = subprocess.run(
        [sys.executable, '-m', 'kaolin_tpu_torch.experimental.dash3d',
         '--help'], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and '--logdir' in res.stdout, res.stderr


def _free_port():
    import socket
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_server_binary_protocol(tmp_path):
    """The port's server over the reference wire format, as
    tests/test_dash3d.py drives kaolin_tpu's: dirinfo pushed on connect,
    geometry requests answered with int32-headed binary frames, and a
    request within 0.5 of the client's current time left unanswered."""
    pytest.importorskip('tornado')
    import asyncio
    from tornado.httpclient import AsyncHTTPClient
    from tornado.websocket import websocket_connect
    from kaolin_tpu_torch.experimental.dash3d import create_server

    logdir = str(tmp_path / 'logs')
    tl = Timelapse(logdir)
    tri = torch.tensor([[0, 1, 2]])
    tl.add_mesh_batch(iteration=0, category='fit',
                      vertices_list=[torch.zeros((3, 3),
                                                 requires_grad=True)],
                      faces_list=[tri])
    tl.add_mesh_batch(iteration=5, category='fit',
                      vertices_list=[torch.ones((3, 3))], faces_list=[tri])
    tl.add_pointcloud_batch(iteration=5, category='pts',
                            pointcloud_list=[torch.ones((17, 3)) * 0.25])
    result = {}
    port = _free_port()

    async def drive():
        create_server(logdir, port)
        http = AsyncHTTPClient()
        resp = await http.fetch(f'http://localhost:{port}/')
        result['page'] = resp.body.decode()
        resp = await http.fetch(f'http://localhost:{port}/static/render.js')
        result['render_js'] = resp.body.decode()
        ws = await websocket_connect(f'ws://localhost:{port}/ws')
        result['dirinfo'] = json.loads(await ws.read_message())
        ws.write_message(json.dumps({'type': 'geometry', 'data': [
            {'type': 'mesh', 'category': 'fit', 'id': 0, 'time': 5,
             'view_id': 0},
            {'type': 'pointcloud', 'category': 'pts', 'id': 0, 'time': 0,
             'view_id': 1}]}))
        result['mesh'] = tutil.decode_binary_message(await ws.read_message())
        result['cloud'] = tutil.decode_binary_message(
            await ws.read_message())
        ws.write_message(json.dumps({'type': 'geometry', 'data': [
            {'type': 'mesh', 'category': 'fit', 'id': 0, 'time': 5,
             'view_id': 0, 'current_time': 5},
            {'type': 'mesh', 'category': 'fit', 'id': 0, 'time': 0,
             'view_id': 2}]}))
        result['after'] = tutil.decode_binary_message(await ws.read_message())
        ws.close()

    asyncio.run(drive())
    assert 'dash3d' in result['page']
    assert 'Viewport' in result['render_js']
    info = result['dirinfo']
    assert info['type'] == 'dirinfo'
    assert info['data']['mesh'][0]['category'] == 'fit'
    assert info['data']['mesh'][0]['times'] == [0.0, 5.0]
    mesh = result['mesh']
    assert (mesh['type_id'], mesh['view_id'], mesh['snap_time']) == (0, 0, 5)
    np.testing.assert_array_equal(mesh['items'][0]['vertices'],
                                  np.ones((3, 3), np.float32))
    np.testing.assert_array_equal(mesh['items'][0]['faces'], [[0, 1, 2]])
    cloud = result['cloud']
    assert (cloud['type_id'], cloud['view_id']) == (1, 1)
    assert cloud['items'][0]['points'].shape == (17, 3)
    np.testing.assert_array_equal(cloud['items'][0]['bbox_min'], 0.25)
    np.testing.assert_array_equal(cloud['items'][0]['bbox_max'], 0.25)
    after = result['after']
    assert after['view_id'] == 2 and after['snap_time'] == 0
    np.testing.assert_array_equal(after['items'][0]['vertices'], 0.)
