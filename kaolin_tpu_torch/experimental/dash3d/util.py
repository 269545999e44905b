"""Binary geometry streaming for the dash3d viewer.

Wire-format parity with the reference
(``kaolin/experimental/dash3d/util.py:27-92`` meshes/point-clouds to
binary, ``:292-303`` response header): little-endian int32/float32,

* response = header int32[4] ``[type_id (0 mesh, 1 pointcloud),
  view_id, snap_time, 0]`` + payload;
* mesh payload = int32[4] ``[nmeshes, texture_mode, 0, 0]`` then per
  mesh int32[2] ``[nverts, nfaces]`` + float32 verts(V*3) + int32
  faces(F*3);
* pointcloud payload = int32[4] ``[nclouds, 0, 0, 0]`` then per cloud
  int32[2] ``[npts, 0]`` + float32 bbox min(3) + bbox max(3) + float32
  points(P*3).

Port of ``kaolin_tpu/experimental/dash3d/util.py``. The pxr-backed
``StreamingGeometryHelper`` becomes a thin layer over the port's
self-contained USD reader, which it asks for host tensors
(``device='cpu'``) and encodes from numpy; snap-time semantics (closest
available sample, skip updates within 0.5 of the client's current time)
match the reference.
"""

import logging

import numpy as np
import torch

from ...visualize import TimelapseParser
from ...io import usd

logger = logging.getLogger(__name__)

TYPE_MESH = 0
TYPE_POINTCLOUD = 1


def _host(a, dtype):
    """``a`` (a tensor on any device, or an array) as a numpy array."""
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def meshes_to_binary(vertices_list, faces_list):
    """Encodes meshes for the websocket client (reference
    ``dash3d/util.py:27``)."""
    if len(faces_list) != len(vertices_list):
        raise RuntimeError(
            f'Expected equal number of vertex and face lists, got: '
            f'{len(vertices_list)}, {len(faces_list)}')
    parts = [np.array([len(vertices_list), 0, 0, 0], np.int32).tobytes()]
    for vertices, faces in zip(vertices_list, faces_list):
        vertices = _host(vertices, np.float32).reshape(-1, 3)
        faces = _host(faces, np.int32).reshape(-1, 3)
        parts.append(np.array([vertices.shape[0], faces.shape[0]],
                              np.int32).tobytes())
        parts.append(vertices.tobytes())
        parts.append(faces.tobytes())
    return b''.join(parts)


def point_clouds_to_binary(positions_list):
    """Encodes point clouds for the websocket client (reference
    ``dash3d/util.py:64``)."""
    parts = [np.array([len(positions_list), 0, 0, 0], np.int32).tobytes()]
    for positions in positions_list:
        positions = _host(positions, np.float32).reshape(-1, 3)
        parts.append(np.array([positions.shape[0], 0], np.int32).tobytes())
        if positions.shape[0]:
            lo = positions.min(axis=0)
            hi = positions.max(axis=0)
        else:
            lo = hi = np.zeros(3, np.float32)
        parts.append(lo.astype(np.float32).tobytes())
        parts.append(hi.astype(np.float32).tobytes())
        parts.append(positions.tobytes())
    return b''.join(parts)


def decode_binary_message(buf):
    """Decodes a full binary websocket message (header + payload) back
    into python objects — the python twin of the JS client's parser
    (and the reference's ``test_binary_parse.js`` assertions)."""
    head = np.frombuffer(buf[:16], np.int32)
    type_id, view_id, snap_time = int(head[0]), int(head[1]), int(head[2])
    off = 16
    meta = np.frombuffer(buf[off:off + 16], np.int32)
    count = int(meta[0])
    off += 16
    items = []
    for _ in range(count):
        n1, n2 = np.frombuffer(buf[off:off + 8], np.int32)
        off += 8
        if type_id == TYPE_MESH:
            verts = np.frombuffer(buf[off:off + 12 * n1],
                                  np.float32).reshape(-1, 3)
            off += 12 * n1
            faces = np.frombuffer(buf[off:off + 12 * n2],
                                  np.int32).reshape(-1, 3)
            off += 12 * n2
            items.append({'vertices': verts, 'faces': faces})
        else:
            bbox = np.frombuffer(buf[off:off + 24], np.float32)
            off += 24
            pts = np.frombuffer(buf[off:off + 12 * n1],
                                np.float32).reshape(-1, 3)
            off += 12 * n1
            items.append({'points': pts, 'bbox_min': bbox[:3],
                          'bbox_max': bbox[3:]})
    return {'type_id': type_id, 'view_id': view_id,
            'snap_time': snap_time, 'items': items}


def _times_for(path):
    stage = usd.Stage.load(path)
    times = set()
    for _, prim in stage.walk():
        for _, (_, samples) in prim.time_attrs.items():
            times.update(samples.keys())
    return sorted(times)


class StreamingGeometryHelper:
    """Parses Timelapse logs and prepares binary geometry updates
    (reference ``dash3d/util.py:92``)."""

    def __init__(self, logdir):
        self.logdir = logdir
        self.parser = TimelapseParser(logdir)

    def get_directory_info(self):
        self.parser.check_for_updates()
        info = {}
        for typ, items in self.parser.dir_info.items():
            info[typ] = [dict(i, times=_times_for(i['path']))
                         for i in items]
        return info

    @staticmethod
    def _find_snap_time(times, target_time):
        if not times:
            return 0
        return min(times, key=lambda t: abs(t - target_time))

    @staticmethod
    def _does_snap_time_require_update(snap_time, current_time):
        if current_time is not None and abs(snap_time - current_time) < 0.5:
            return False
        return True

    def _find_path(self, prim_type, category, idx):
        paths = self.parser.get_filepaths(category, prim_type)
        if idx >= len(paths):
            logger.warning('no %s #%d in category %r', prim_type, idx,
                           category)
            return None
        return paths[idx]

    def parse_encode_mesh(self, category, idx, target_time,
                          current_time=None):
        fpath = self._find_path('mesh', category, idx)
        if fpath is None:
            return None, 0
        snap_time = self._find_snap_time(_times_for(fpath), target_time)
        if not self._does_snap_time_require_update(snap_time, current_time):
            return None, current_time
        out = usd.import_mesh(fpath, time=snap_time, device='cpu')
        return meshes_to_binary([out.vertices.numpy()],
                                [out.faces.numpy()]), snap_time

    def parse_encode_pointcloud(self, category, idx, target_time,
                                current_time=None):
        fpath = self._find_path('pointcloud', category, idx)
        if fpath is None:
            return None, 0
        snap_time = self._find_snap_time(_times_for(fpath), target_time)
        if not self._does_snap_time_require_update(snap_time, current_time):
            return None, current_time
        out = usd.import_pointcloud(fpath, time=snap_time, device='cpu')
        return point_clouds_to_binary([out.points.numpy()]), snap_time

    def parse_encode_voxelgrid_as_pointcloud(self, category, idx,
                                             target_time,
                                             current_time=None):
        """Voxelgrids stream as their occupied-cell centers in [-1, 1]
        (this build's extension; the reference client skips them)."""
        fpath = self._find_path('voxelgrid', category, idx)
        if fpath is None:
            return None, 0
        snap_time = self._find_snap_time(_times_for(fpath), target_time)
        if not self._does_snap_time_require_update(snap_time, current_time):
            return None, current_time
        grid = usd.import_voxelgrid(fpath, time=snap_time,
                                    device='cpu').numpy()
        idxs = np.argwhere(grid)
        res = max(grid.shape) if grid.size else 1
        pts = (idxs + 0.5) / res * 2. - 1.
        return point_clouds_to_binary([pts.astype(np.float32)]), snap_time
