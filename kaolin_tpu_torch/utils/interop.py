"""Numpy interop and the DIB-R demo scenes.

``icosphere`` is a numpy copy of the icosphere builder that the repo's
``__graft_entry__._icosphere`` holds, so the port builds the same meshes
without importing the JAX side. ``dibr_params_from_numpy``,
``extrinsics_from_numpy``, ``intrinsics_from_numpy`` and
``texture_from_numpy`` turn parameters, as numpy arrays, into the port's
tensors and cameras; the parity tests feed both packages through them.
``scene`` is the DIB-R silhouette scene; ``textured_scene``,
``textured_maps``, ``textured_render`` and ``textured_loss`` are the
textured train step of ``bench_suite.py``'s config 2.
``pointclouds_from_numpy`` and ``mesh_from_numpy`` carry point clouds and
meshes over; ``metrics_scene`` and ``metrics_step`` are config 3's
point-cloud and mesh metrics step, ``ellipsoid_points`` and
``mesh_fit_loss`` its mesh fit.
"""

import math

import numpy as np
import torch

from .. import metrics, ops
from ..ops.mesh.trianglemesh import _sample_from_uniforms
from ..render import camera, mesh
from ..render.mesh.utils import _clip

__all__ = ['icosphere', 'dibr_params_from_numpy', 'extrinsics_from_numpy',
           'intrinsics_from_numpy', 'texture_from_numpy', 'scene',
           'textured_scene', 'textured_maps', 'textured_render',
           'textured_loss', 'pointclouds_from_numpy', 'mesh_from_numpy',
           'metrics_scene', 'metrics_step', 'ellipsoid_points',
           'mesh_fit_loss']


def icosphere(subdiv=2):
    """Unit icosphere: (verts (V, 3) float32, faces (20 * 4**subdiv, 3)
    int32), numpy."""
    t = (1. + 5 ** 0.5) / 2.
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
             (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
             (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = [np.array(v) / np.linalg.norm(v) for v in verts]
    for _ in range(subdiv):
        mid = {}
        new_faces = []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = (verts[a] + verts[b]) / 2.
                verts.append(m / np.linalg.norm(m))
                mid[key] = len(verts) - 1
            return mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc),
                          (ab, bc, ca)]
        faces = new_faces
    return (np.stack(verts).astype(np.float32),
            np.array(faces, dtype=np.int32))


def dibr_params_from_numpy(vertices, faces, cam_rot, cam_trans, cam_proj,
                           device='cuda'):
    """DIB-R parameters from numpy arrays to the port's tensors.

    Float arrays keep their dtype (float32 or float64); faces become int64,
    torch's index type. Returns (vertices, faces, cam_rot, cam_trans,
    cam_proj) on ``device``.
    """
    def to(a, dtype=None):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return (to(vertices), to(faces, torch.int64), to(cam_rot),
            to(cam_trans), to(cam_proj))


def extrinsics_from_numpy(params, backend, device='cuda'):
    """A ``CameraExtrinsics`` from its params (C, P) as a numpy array (dtype
    kept) and its backend name, on ``device``."""
    return camera.CameraExtrinsics(
        torch.tensor(np.asarray(params), device=device), backend=backend)


def intrinsics_from_numpy(params, width, height, lens_type='pinhole',
                          near=1e-2, far=1e2, ndc_min=-1., ndc_max=1.,
                          device='cuda'):
    """Camera intrinsics from their params (C, P) as a numpy array (dtype
    kept) and their settings, on ``device``. ``lens_type`` is 'pinhole'
    or 'ortho', as the classes' ``lens_type``."""
    cls = {'pinhole': camera.PinholeIntrinsics,
           'ortho': camera.OrthographicIntrinsics}[lens_type]
    return cls(width, height, torch.tensor(np.asarray(params), device=device),
               near=near, far=far, ndc_min=ndc_min, ndc_max=ndc_max)


def texture_from_numpy(texture, uvs, device='cuda'):
    """(texture (B, C, H, W), UVs) from numpy arrays to tensors on
    ``device``, dtypes kept."""
    return (torch.tensor(np.asarray(texture), device=device),
            torch.tensor(np.asarray(uvs), device=device))


def scene(batch_size, subdiv, dtype=torch.float32, device='cuda'):
    """The DIB-R demo scene: ``batch_size`` copies of an icosphere seen by
    cameras on a ring of radius 3, 0.5 above the equator, 45-degree fovy.

    Returns (vertices (B,V,3), faces (F,3) int64, cam_rot (B,3,3),
    cam_trans (B,3), cam_proj (3,1)) on ``device``.
    """
    verts_np, faces_np = icosphere(subdiv)
    angles = np.linspace(0., 2 * np.pi, batch_size, endpoint=False)
    cam_pos = torch.as_tensor(
        np.stack([3 * np.sin(angles), 0.5 * np.ones_like(angles),
                  3 * np.cos(angles)], axis=-1), dtype=dtype, device=device)
    look_at = torch.zeros((batch_size, 3), dtype=dtype, device=device)
    cam_up = torch.tensor([[0., 1., 0.]], dtype=dtype,
                          device=device).repeat(batch_size, 1)
    cam_rot, cam_trans = camera.generate_rotate_translate_matrices(
        cam_pos, look_at, cam_up)
    cam_proj = camera.generate_perspective_projection(
        math.pi / 4., dtype=dtype, device=device)
    verts = torch.as_tensor(verts_np, dtype=dtype, device=device)
    verts = verts[None].repeat(batch_size, 1, 1)
    faces = torch.as_tensor(faces_np, dtype=torch.int64, device=device)
    return verts, faces, cam_rot, cam_trans, cam_proj


def textured_scene(batch_size, subdiv, tex_size, seed=0, dtype=torch.float32,
                   device='cuda'):
    """``bench_suite.py``'s config-2 scene: ``batch_size`` copies of an
    icosphere seen by cameras on a ring of radius 3, 0.5 above the equator
    (6-DoF extrinsics from ``from_lookat``, 45-degree fovy), a seeded
    random (B, 3, tex_size, tex_size) texture and seeded random per-vertex
    UVs in [0, 1], drawn in that order from ``default_rng(seed)``.

    Returns a dict: vertices (B,V,3), faces (F,3) int64, cam_params (B,9),
    cam_proj (3,1), texture, face_uvs (B,F,3,2), on ``device``.
    """
    verts_np, faces_np = icosphere(subdiv)
    angles = np.linspace(0., 2 * np.pi, batch_size, endpoint=False)
    eye = np.stack([3 * np.sin(angles), 0.5 * np.ones_like(angles),
                    3 * np.cos(angles)], -1)
    ext = camera.CameraExtrinsics.from_lookat(
        eye, np.zeros((batch_size, 3)),
        np.tile(np.array([[0., 1., 0.]]), (batch_size, 1)), dtype=dtype,
        backend='matrix_6dof_rotation', device=device)
    rng = np.random.default_rng(seed)
    texture, uvs = texture_from_numpy(
        rng.random((batch_size, 3, tex_size, tex_size)),
        rng.random((batch_size, verts_np.shape[0], 2)), device=device)
    faces = torch.as_tensor(faces_np, dtype=torch.int64, device=device)
    verts = torch.as_tensor(verts_np, dtype=dtype, device=device)
    return dict(
        vertices=verts[None].repeat(batch_size, 1, 1), faces=faces,
        cam_params=ext.parameters(),
        cam_proj=camera.generate_perspective_projection(
            math.pi / 4., dtype=dtype, device=device),
        texture=texture.to(dtype),
        face_uvs=ops.mesh.index_vertices_by_faces(uvs.to(dtype), faces))


def textured_maps(vertices, cam_params, faces, face_uvs, cam_proj, height,
                  width):
    """Config 2's rasterized maps: 6-DoF extrinsics, perspective
    projection, ``rasterize`` of [face UVs, normal z] with normal-z
    culling. ``vertices`` (B, V, 3) or (V, 3) for one mesh seen by every
    camera; ``face_uvs`` (B, F, 3, 2) or (1, F, 3, 2). Returns (UV map
    (B, height, width, 2), normal-z map (B, height, width, 1))."""
    ext = camera.CameraExtrinsics(cam_params, backend='matrix_6dof_rotation')
    vc = ext.transform(vertices)
    vi = camera.perspective_camera(vc, cam_proj)
    fvc = ops.mesh.index_vertices_by_faces(vc, faces)
    fvi = ops.mesh.index_vertices_by_faces(vi, faces)
    fn = ops.mesh.face_normals(fvc, unit=True)
    ff = [face_uvs.expand(fvc.shape[:2] + face_uvs.shape[2:]),
          fn[:, :, None, 2:].expand(fvc.shape[:3] + (1,))]
    maps, _ = mesh.rasterize(height, width, fvc[..., 2], fvi, ff,
                             fn[..., 2] >= 0)
    return maps


def textured_render(vertices, texture, cam_params, faces, face_uvs, cam_proj,
                    height, width):
    """Config 2's image (B, height, width, 3): :func:`textured_maps`, then
    bilinear ``texture_mapping`` times ``clip(normal z, 0, 1)``."""
    uv_map, nz_map = textured_maps(vertices, cam_params, faces, face_uvs,
                                   cam_proj, height, width)
    img = mesh.texture_mapping(uv_map, texture, mode='bilinear')
    return img * _clip(nz_map, 0., 1.)


def textured_loss(vertices, texture, cam_params, faces, face_uvs, cam_proj,
                  target):
    """Config 2's loss: L1 of :func:`textured_render` to ``target``
    (B, H, W, 3)."""
    img = textured_render(vertices, texture, cam_params, faces, face_uvs,
                          cam_proj, *target.shape[1:3])
    return torch.mean(torch.abs(img - target))


def pointclouds_from_numpy(*arrays, device='cuda'):
    """Point clouds (B, N, 3), or face vertices (B, F, 3, 3), from numpy
    arrays to tensors on ``device``, float dtypes kept. One array gives
    one tensor, several a tuple."""
    out = tuple(torch.tensor(np.asarray(a), device=device) for a in arrays)
    return out[0] if len(out) == 1 else out


def mesh_from_numpy(vertices, faces, device='cuda'):
    """(vertices, faces) from numpy arrays to tensors on ``device``: the
    vertices' float dtype kept, faces int64."""
    return (torch.tensor(np.asarray(vertices), device=device),
            torch.tensor(np.asarray(faces), dtype=torch.int64, device=device))


def metrics_scene(seed=0, n1=100_000, n2=100_000, num_faces=10_000,
                  device='cuda'):
    """``bench_suite.py``'s config-3 inputs: uniform clouds ``p1`` (1, n1,
    3) and ``p2`` (1, n2, 3) and a triangle soup ``fv`` (1, num_faces, 3,
    3) in [0, 1), drawn in that order from ``default_rng(seed)`` in float64
    and rounded to float32, on ``device``."""
    rng = np.random.default_rng(seed)
    arrays = (rng.random((1, n1, 3)), rng.random((1, n2, 3)),
              rng.random((1, num_faces, 3, 3)))
    return tuple(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in arrays)


def metrics_step(p, p2, fv):
    """Config 3's step (``bench_suite.py:196-199``): ``chamfer_distance(p,
    p2)`` and ``point_to_mesh_distance(p, fv)``, folded into the next
    ``p`` as ``p + 1e-20 * (c + mean(d))``."""
    c = metrics.pointcloud.chamfer_distance(p, p2)
    d, _, _ = metrics.trianglemesh.point_to_mesh_distance(p, fv)
    return p + 1e-20 * (c[..., None, None] + torch.mean(d))


def ellipsoid_points(num_points, subdiv=5, scale=(1.3, 0.75, 1.),
                     generator=None, device='cuda'):
    """(1, num_points, 3) float32 points sampled uniformly on an icosphere
    of ``subdiv`` scaled by ``scale``, from ``generator``."""
    verts, faces = mesh_from_numpy(*icosphere(subdiv), device=device)
    verts = verts * torch.tensor(scale, dtype=verts.dtype, device=device)
    return ops.mesh.sample_points(verts[None], faces, num_points,
                                  generator=generator)[0]


def mesh_fit_loss(vertices, faces, target, num_samples, lap_weight,
                  uniforms=None, generator=None):
    """Config 3's mesh-fit loss, for ``vertices`` (1, V, 3) and ``target``
    (1, N, 3): ``chamfer_distance`` from ``num_samples`` points sampled on
    the mesh to the target, plus the mean ``point_to_mesh_distance`` from
    the target to the mesh, plus ``lap_weight`` times the mean squared
    length of ``uniform_laplacian_smoothing(vertices) - vertices``. The
    samples come from ``uniforms`` (face (1, S), barycentric u and v (1, S,
    1), in [0, 1)) when given, else from ``generator``."""
    if uniforms is None:
        pts = ops.mesh.sample_points(vertices, faces, num_samples,
                                     generator=generator)[0]
    else:
        pts = _sample_from_uniforms(vertices, faces, *uniforms)[0]
    fv = ops.mesh.index_vertices_by_faces(vertices, faces)
    cham = metrics.pointcloud.chamfer_distance(pts, target)
    p2m = metrics.trianglemesh.point_to_mesh_distance(target, fv)[0]
    lap = metrics.trianglemesh.uniform_laplacian_smoothing(vertices, faces) \
        - vertices
    lap = (lap * lap).sum(dim=-1)
    return torch.mean(cham + p2m.mean(dim=-1) + lap_weight * lap.mean(dim=-1))
