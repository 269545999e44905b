"""3D training checkpoints: timesampled USD files per item per category.

Port of ``kaolin_tpu/visualize/timelapse.py`` (reference
``kaolin/visualize/timelapse.py:22-425``). One ``.usda`` file per item per
category under the log directory; every ``add_*_batch`` call appends a
time sample at ``iteration``, reloading and rewriting the item's file, so
a checkpoint costs more the more samples the file holds. The batches are
lists of tensors on any device, with or without grad (or numpy arrays):
each is copied to the host once, and the files are ``kaolin_tpu``'s, byte
for byte. ``TimelapseParser`` is the viewer side (directory scanning +
update polling), host only.
"""

import glob
import os

from ..io import usd

__all__ = ['Timelapse', 'TimelapseParser']


class Timelapse:
    """Writes 3D checkpoints of meshes / pointclouds / voxelgrids.

    Args:
        log_dir (str): root output directory.
        up_axis (str): USD up axis. Default 'Y'.
    """

    def __init__(self, log_dir, up_axis='Y'):
        self.logdir = log_dir
        self.up_axis = up_axis
        os.makedirs(self.logdir, exist_ok=True)

    def _add_shading_group(self, category, subdirectory=None):
        out = self.logdir
        if subdirectory is not None:
            out = os.path.join(out, subdirectory)
        out = os.path.join(out, category)
        os.makedirs(out, exist_ok=True)
        return out

    def _stage(self, dir_path, name):
        path = os.path.join(dir_path, f'{name}.usda')
        if os.path.exists(path) and os.path.getsize(path) > 0:
            return usd.Stage.load(path)
        stage = usd.Stage(path, self.up_axis)
        return stage

    def add_mesh_batch(self, iteration=0, category='output',
                       vertices_list=None, faces_list=None, uvs_list=None,
                       face_uvs_idx_list=None, materials_list=None):
        """Checkpoints a batch of meshes at ``iteration``.

        Reference: ``kaolin/visualize/timelapse.py`` (add_mesh_batch).
        """
        out_dir = self._add_shading_group(category)
        n = len(vertices_list) if vertices_list is not None \
            else len(faces_list)
        for i in range(n):
            stage = self._stage(out_dir, f'mesh_{i}')
            usd.add_mesh(
                stage, f'/mesh_{i}',
                None if vertices_list is None else vertices_list[i],
                None if faces_list is None else faces_list[i],
                None if uvs_list is None else uvs_list[i],
                None if face_uvs_idx_list is None else face_uvs_idx_list[i],
                time=iteration)
            stage.save()

    def add_pointcloud_batch(self, iteration=0, category='output',
                             pointcloud_list=None, colors=None,
                             semantic_ids=None):
        """Checkpoints a batch of pointclouds at ``iteration``.

        Reference: ``kaolin/visualize/timelapse.py:66``.
        """
        out_dir = self._add_shading_group(category)
        for i, pc in enumerate(pointcloud_list):
            stage = self._stage(out_dir, f'pointcloud_{i}')
            usd.add_pointcloud(
                stage, f'/pointcloud_{i}', pc,
                colors=None if colors is None else colors[i],
                time=iteration)
            stage.save()

    def add_voxelgrid_batch(self, iteration=0, category='output',
                            voxelgrid_list=None, semantic_ids=None):
        """Checkpoints a batch of voxelgrids at ``iteration``."""
        out_dir = self._add_shading_group(category)
        for i, vg in enumerate(voxelgrid_list):
            stage = self._stage(out_dir, f'voxelgrid_{i}')
            usd.add_voxelgrid(stage, f'/voxelgrid_{i}', vg, time=iteration)
            stage.save()


class TimelapseParser:
    """Parses a Timelapse log directory for viewers.

    Reference: ``kaolin/visualize/timelapse.py:228``.
    """

    def __init__(self, logdir):
        self.logdir = logdir
        self.dir_info = {'mesh': [], 'pointcloud': [], 'voxelgrid': []}
        self._mtimes = {}
        self.check_for_updates()

    @staticmethod
    def get_file_info(path):
        rel = os.path.relpath(path)
        name = os.path.splitext(os.path.basename(path))[0]
        typ = name.split('_')[0]
        return {'path': path, 'category': os.path.basename(
            os.path.dirname(path)), 'type': typ,
            'id': int(name.split('_')[-1])}

    def check_for_updates(self):
        """Rescans the log dir; True if any file was added or modified.

        Reference: ``kaolin/visualize/timelapse.py:303``.
        """
        changed = False
        found = {'mesh': [], 'pointcloud': [], 'voxelgrid': []}
        for path in sorted(glob.glob(
                os.path.join(self.logdir, '**', '*.usda'),
                recursive=True)):
            info = self.get_file_info(path)
            if info['type'] not in found:
                continue
            found[info['type']].append(info)
            mtime = os.path.getmtime(path)
            if self._mtimes.get(path) != mtime:
                changed = True
                self._mtimes[path] = mtime
        if found != self.dir_info:
            changed = True
        self.dir_info = found
        return changed

    def get_filepaths(self, category, prim_type):
        """File paths for one category / type
        (``timelapse.py:354``)."""
        return [i['path'] for i in self.dir_info.get(prim_type, [])
                if i['category'] == category]

    def num_items(self, prim_type):
        return len(self.dir_info.get(prim_type, []))

    def get_category_list(self):
        return sorted({i['category'] for infos in self.dir_info.values()
                       for i in infos})
