"""Sharded SPC ray tracing: rays split over a mesh axis.

Port of ``kaolin_tpu/parallel/spc.py``. The octree (bytes and hierarchy,
small) is held whole by every rank; each rank traces its slice of the rays
through the port's traversal kernel and keeps its hits, ray-split for the
per-ray integration that follows. The forward exchanges nothing.

The JAX package caches a jitted ``shard_map`` tracer per configuration;
PyTorch runs eagerly, so there is nothing to cache.
"""

from ..render.spc.raytrace import plan_raytrace, unbatched_raytrace_fixed
from .mesh import axis as mesh_axis

__all__ = ['sharded_raytrace', 'plan_sharded_raytrace']


def _offset_fn(ray_fn, offset):
    """``ray_fn`` of a shard whose first ray is global ray ``offset``."""
    if ray_fn is None:
        return None

    def local_fn(ridx):
        return ray_fn(ridx + offset)
    return local_fn


def plan_sharded_raytrace(n_shards, octree, point_hierarchy, exsum,
                          origin, direction, level, cap=None,
                          margin=1.25, ray_fn=None, level_offsets=None,
                          return_counts=False):
    """Per-shard ``cap_schedule`` for :func:`sharded_raytrace`.

    Plans each ray shard on its own and takes the elementwise max of the
    per-level sizes (rays cluster in space: the largest shard's counts,
    not counts / n, are the safe per-shard sizes). The port's traversal
    sizes its own buffers, so the schedule only bounds ``cap``. Returns
    (schedule, cap_per_device[, counts]).
    """
    num_rays = origin.shape[0]
    assert num_rays % n_shards == 0, (num_rays, n_shards)
    per = num_rays // n_shards
    scheds = []
    for s in range(n_shards):
        sl = slice(s * per, (s + 1) * per)
        scheds.append(plan_raytrace(
            octree, point_hierarchy, exsum, origin[sl], direction[sl],
            level, cap=cap, margin=margin,
            ray_fn=_offset_fn(ray_fn, s * per),
            level_offsets=level_offsets, return_counts=True))
    sched = tuple(max(col) for col in zip(*(s0 for s0, _ in scheds)))
    counts = tuple(max(col) for col in zip(*(c0 for _, c0 in scheds)))
    if return_counts:
        return sched, max(max(sched), per), counts
    return sched, max(max(sched), per)


def sharded_raytrace(mesh, octree, point_hierarchy, exsum, origin,
                     direction, level, cap_per_device, with_exit=False,
                     axis='pix', cap_schedule=None, ray_fn=None,
                     level_offsets=None, backend='auto'):
    """Traces this rank's slice of the rays, split along ``axis`` of the
    mesh (ranks along the other axis trace the same slice).

    Args:
        mesh: from :func:`kaolin_tpu_torch.parallel.make_mesh`.
        octree / point_hierarchy / exsum: the SPC, whole on every rank.
        origin, direction: (num_rays, 3), whole on every rank; num_rays
            must divide by the axis size.
        level (int): target octree level.
        cap_per_device (int): rows of this rank's outputs.
        axis (str): the mesh axis the rays split over.
        cap_schedule, level_offsets, backend: forwarded to
            :func:`unbatched_raytrace_fixed` (the port's traversal sizes
            its own buffers and accepts them for ``kaolin_tpu``'s
            signature).
        ray_fn: optional closure of GLOBAL ray indices (see
            :func:`kaolin_tpu_torch.render.spc.primary_rays_fn`); this
            rank offsets its local indices by ``index * rays_per_device``.

    Returns:
        This rank's (ray_index (cap,), point_index (cap,), depth (cap, 1
        or 2), count (1,)): ``ray_index`` is LOCAL to the rank's slice
        (add ``index * rays_per_device`` to globalize), as the JAX
        package's per-device blocks are.
    """
    n, index = mesh_axis(mesh, axis)
    num_rays = origin.shape[0]
    assert num_rays % n == 0, (origin.shape, n)
    per = num_rays // n
    sl = slice(index * per, (index + 1) * per)
    ridx, pidx, depth, count = unbatched_raytrace_fixed(
        octree, point_hierarchy, exsum, origin[sl], direction[sl], level,
        int(cap_per_device), with_exit, cap_schedule=cap_schedule,
        ray_fn=_offset_fn(ray_fn, index * per), level_offsets=level_offsets,
        backend=backend)
    return ridx, pidx, depth, count.reshape(1)

