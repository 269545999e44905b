"""The port's spans (``kaolin_tpu_torch.tracing``) on the CPU.

While ``torch.profiler`` records, the render entry points open one span
``kaolin.<public name>`` a call, nested as the calls are, in the forward
only; with no profiler, :func:`span` makes nothing and hands back one
shared null context. A profiled step computes the same losses and
gradients, bit for bit, as an unprofiled one.
"""

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

import kaolin_tpu_torch as kt
from kaolin_tpu_torch import tracing
from kaolin_tpu_torch.utils import interop

H = W = 32


def _textured():
    s = interop.textured_scene(2, 1, 8, seed=3, device='cpu')
    leaves = [s['vertices'], s['texture'], s['cam_params']]
    target = torch.rand((2, H, W, 3),
                        generator=torch.Generator().manual_seed(4))

    def loss(verts, tex, cams):
        return interop.textured_loss(verts, tex, cams, s['faces'],
                                     s['face_uvs'], s['cam_proj'], target)
    return loss, leaves


def _silhouette():
    verts, faces, rot, trans, proj = interop.scene(2, 1, device='cpu')
    gray = torch.rand((2, faces.shape[0], 3, 1),
                      generator=torch.Generator().manual_seed(5))
    target = torch.zeros((2, H, W))
    target[:, 8:24, 10:22] = 1.

    def loss(v):
        fvc, fvi, fn = kt.render.mesh.prepare_vertices(
            v, faces, proj, camera_rot=rot, camera_trans=trans)
        feat, mask, _ = kt.render.mesh.dibr_rasterization(
            H, W, fvc[..., 2], fvi, gray, fn[..., 2])
        return feat.abs().mean() + kt.metrics.render.mask_iou(mask, target)
    return loss, [verts]


def _sharded():
    """The textured cell's sharded render on a mesh of one rank: the
    faces prepared whole, the textures replicated, the loss summed."""
    s = interop.textured_scene(2, 1, 8, seed=6, device='cpu')
    leaves = [s['vertices'], s['texture'], s['cam_params']]
    mesh = kt.parallel.make_mesh()

    def loss(verts, tex, cams):
        from kaolin_tpu_torch.parallel.mesh import mesh_sum, replicate
        ext = kt.render.camera.CameraExtrinsics(
            cams, backend='matrix_6dof_rotation')
        vc = ext.transform(verts)
        vi = kt.render.camera.perspective_camera(vc, s['cam_proj'])
        fvc = kt.ops.mesh.index_vertices_by_faces(vc, s['faces'])
        fvi = kt.ops.mesh.index_vertices_by_faces(vi, s['faces'])
        fn = kt.ops.mesh.face_normals(fvc, unit=True)
        (uv, nz), _ = kt.parallel.sharded_rasterize(
            mesh, H, W, fvc[..., 2], fvi, [s['face_uvs'], fn[..., None, 2:]
                                           .expand(fvc.shape[:3] + (1,))],
            fn[..., 2] >= 0)
        tex = replicate(mesh, tex)[0]
        img = kt.render.mesh.texture_mapping(uv, tex, mode='bilinear') * nz
        return mesh_sum(mesh, img.abs().sum())
    return loss, leaves


# each span of a step, with the innermost span around it (None: none)
EXPECTED = {
    'textured': [
        ('kaolin.CameraExtrinsics.transform', None),
        ('kaolin.perspective_camera', None),
        ('kaolin.index_vertices_by_faces', None),
        ('kaolin.index_vertices_by_faces', None),
        ('kaolin.face_normals', None),
        ('kaolin.rasterize', None),
        ('kaolin.texture_mapping', None)],
    'silhouette': [
        ('kaolin.prepare_vertices', None),
        ('kaolin.perspective_camera', 'kaolin.prepare_vertices'),
        ('kaolin.index_vertices_by_faces', 'kaolin.prepare_vertices'),
        ('kaolin.index_vertices_by_faces', 'kaolin.prepare_vertices'),
        ('kaolin.face_normals', 'kaolin.prepare_vertices'),
        ('kaolin.dibr_rasterization', None),
        ('kaolin.rasterize', 'kaolin.dibr_rasterization'),
        ('kaolin.dibr_soft_mask', 'kaolin.dibr_rasterization'),
        ('kaolin.mask_iou', None)],
    'sharded': [
        ('kaolin.CameraExtrinsics.transform', None),
        ('kaolin.perspective_camera', None),
        ('kaolin.index_vertices_by_faces', None),
        ('kaolin.index_vertices_by_faces', None),
        ('kaolin.face_normals', None),
        ('kaolin.sharded_rasterize', None),
        ('kaolin.replicate', 'kaolin.sharded_rasterize'),
        ('kaolin.rasterize', 'kaolin.sharded_rasterize'),
        ('kaolin.replicate', None),
        ('kaolin.texture_mapping', None),
        ('kaolin.mesh_sum', None)],
}
STEPS = {'textured': _textured, 'silhouette': _silhouette,
         'sharded': _sharded}


@pytest.fixture
def step(request):
    """(loss function, leaves) of the step ``request.param``; the sharded
    step's group of one is left again after the test."""
    try:
        yield STEPS[request.param]()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _grads(loss_fn, leaves):
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    loss = loss_fn(*leaves)
    loss.backward()
    return [loss.detach()] + [t.grad for t in leaves]


def _spans(prof):
    """[(name, innermost enclosing kaolin span)] of the trace's kaolin
    spans, in the order they start."""
    spans = sorted((e for e in prof.profiler.kineto_results.events()
                    if e.is_user_annotation()
                    and e.name().startswith('kaolin.')),
                   key=lambda e: (e.start_ns(), -e.end_ns()))
    out = []
    for i, e in enumerate(spans):
        around = [o for o in spans[:i]
                  if o.start_thread_id() == e.start_thread_id()
                  and o.end_ns() >= e.end_ns()]
        out.append((e.name(), around[-1].name() if around else None))
    return out


@pytest.mark.parametrize('step', sorted(STEPS), indirect=True)
def test_step_opens_each_span_once_nested_as_called(step, request):
    loss_fn, leaves = step
    _grads(loss_fn, leaves)               # the first call's set-up
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _grads(loss_fn, leaves)
    name = request.node.callspec.params['step']
    assert _spans(prof) == EXPECTED[name]


@pytest.mark.parametrize('step', sorted(STEPS), indirect=True)
def test_profiled_step_is_bit_identical(step):
    loss_fn, leaves = step
    plain = _grads(loss_fn, leaves)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _grads(loss_fn, leaves)
    again = _grads(loss_fn, leaves)
    for a, b, c in zip(plain, traced, again):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_span_off_is_one_check_and_makes_nothing(monkeypatch):
    calls = []
    enabled = torch.autograd._profiler_enabled

    def counted():
        calls.append(1)
        return enabled()

    def made(name):
        raise AssertionError(f'a span {name!r} was made with no profiler')

    monkeypatch.setattr(torch.autograd, '_profiler_enabled', counted)
    monkeypatch.setattr(torch.profiler, 'record_function', made)
    first = tracing.span('kaolin.a')
    assert first is tracing.span('kaolin.b')
    assert calls == [1, 1]
    with first:
        with first:                       # the shared context nests
            pass
    kt.ops.mesh.face_normals(torch.rand(1, 2, 3, 3))


def test_span_on_is_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ctx = tracing.span('kaolin.x')
        assert ctx is not tracing.span('kaolin.y')
        with ctx:
            torch.ones(2).sum()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    assert names == ['kaolin.x']
