"""DIB-R renderer wrapper: textured mesh + camera-parameterized rendering.

Reference: ``examples/tutorial/ian_renderer.py:26-225`` (fork layer).
"""

import torch

from .. import io as kio
from .. import ops
from ..render import mesh as kmesh
from ..render.mesh.utils import _clip
from . import utils


class TexturedMesh:
    """A mesh with UVs and a texture map (``ian_renderer.py:26``); every
    tensor on the vertices' device."""

    def __init__(self, vertices, faces, uvs, face_uvs_idx, texture_res=256):
        dev = vertices.device
        self.vertices = vertices          # (1, V, 3)
        self.faces = torch.as_tensor(faces, device=dev)    # (F, 3)
        self.uvs = torch.as_tensor(uvs, device=dev)        # (1, U, 2)
        self.face_uvs_idx = torch.as_tensor(face_uvs_idx, device=dev)
        self.face_uvs = ops.mesh.index_vertices_by_faces(
            self.uvs, self.face_uvs_idx)
        self.texture_map = torch.ones((1, 3, texture_res, texture_res),
                                      dtype=torch.float32, device=dev)

    @classmethod
    def from_obj(cls, path, texture_res=256, device='cuda'):
        device = utils.check_device(device)
        mesh = kio.obj.import_mesh(path, with_materials=True, device=device)
        vertices = mesh.vertices[None]
        # normalize into [-0.5, 0.5] as the reference tutorials do
        vmin = vertices.amin(dim=1, keepdim=True)
        vmax = vertices.amax(dim=1, keepdim=True)
        vertices = (vertices - (vmin + vmax) / 2) / (vmax - vmin).max()
        return cls(vertices, mesh.faces, mesh.uvs[None], mesh.face_uvs_idx,
                   texture_res)


class Renderer:
    """Batched DIB-R rendering with spherical camera parameters; renders on
    the mesh's device.

    Reference: ``ian_renderer.py:137-225``.
    """

    def __init__(self, batch_size, render_res=(512, 512),
                 interpolation_mode='bilinear'):
        assert interpolation_mode in ('nearest', 'bilinear'), \
            f'no interpolation mode {interpolation_mode}'
        self.batch_size = batch_size
        self.render_res = render_res
        self.interpolation_mode = interpolation_mode

    def render_image_and_mask_with_camera_params(
            self, elev, azim, r, look_at_height, fovyangle, mesh,
            sigmainv=7000, texture_map=None, offset=None):
        dev = mesh.vertices.device
        cam_transform = utils.get_camera_transform_from_view(
            elev, azim, r, look_at_height, device=dev)
        cam_proj = utils.get_camera_projection(fovyangle, device=dev)
        if texture_map is None:
            texture_map = mesh.texture_map
        return self.render_image_and_mask(
            cam_proj, cam_transform, self.render_res[0],
            self.render_res[1], mesh, sigmainv, texture_map, offset)

    def render_image_and_mask(self, cam_proj, cam_transform, height, width,
                              mesh, sigmainv=7000, texture_map=None,
                              offset=None):
        """Returns (image (B, H, W, 3), mask, soft_mask)."""
        camera_transform = cam_transform if offset is None \
            else cam_transform + offset
        B = self.batch_size
        fvc, fvi, fn = kmesh.prepare_vertices(
            mesh.vertices.expand(B, -1, -1), mesh.faces, cam_proj,
            camera_transform=camera_transform)
        num_faces = mesh.faces.shape[0]
        face_attributes = [
            mesh.face_uvs.expand(B, -1, -1, -1),
            torch.ones((B, num_faces, 3, 1), dtype=fvc.dtype,
                       device=fvc.device),
        ]
        image_features, soft_mask, face_idx = kmesh.dibr_rasterization(
            height, width, fvc[:, :, :, -1], fvi, face_attributes,
            fn[:, :, -1], sigmainv=sigmainv)
        texture_coords, mask = image_features
        if texture_map is None:
            texture_map = mesh.texture_map
        image = kmesh.texture_mapping(
            texture_coords, texture_map.expand(B, -1, -1, -1),
            mode=self.interpolation_mode)
        image = _clip(image * mask, 0., 1.)
        return image, mask, soft_mask
