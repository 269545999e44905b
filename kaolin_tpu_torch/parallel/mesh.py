"""Device-mesh construction, and the two collectives of the sharded paths.

Port of ``kaolin_tpu/parallel/mesh.py``. The JAX package lays devices out
on a ``jax.sharding.Mesh`` and cuts arrays with ``shard_map``; here the
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` of ranks (one
process and one card a rank) with the axes ``('data', 'pix')``, and each
rank computes its own block. JAX's ``PartitionSpec`` (``P``) has no
counterpart: no function here takes a spec, each says which block a rank
gets.

Where ``shard_map``'s transpose sums the gradients of a replicated input
over the mesh, the port passes that input through :func:`replicate`,
the identity forward and an ``all_reduce`` of the gradient backward.
Where a rank's partial result joins the others', :func:`mesh_sum` sums it
over the mesh forward and passes the gradient through unchanged: a loss
that every rank computes from it then has the one-process gradient on
every rank. Only ``all_reduce`` is used, which gloo also runs on CUDA
tensors.
"""

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..tracing import span

__all__ = ['make_mesh', 'replicate', 'mesh_sum']

# the mesh class (exported by the package as ``Mesh``, as the JAX package
# exports ``jax.sharding.Mesh``): PyTorch's, with its own constructor
Mesh = DeviceMesh
AXES = ('data', 'pix')


def _ranks_per_host(world):
    """Ranks a host runs, from the launcher (torchrun's
    ``LOCAL_WORLD_SIZE``, SLURM's ``SLURM_NTASKS_PER_NODE``, Open MPI's
    ``OMPI_COMM_WORLD_LOCAL_SIZE``); the whole world if none says."""
    for var in ('LOCAL_WORLD_SIZE', 'SLURM_NTASKS_PER_NODE',
                'OMPI_COMM_WORLD_LOCAL_SIZE'):
        raw = os.environ.get(var, '')
        if raw.isdigit() and int(raw) > 0:
            return int(raw)
    return world


def _layout(data, pix, devices, ranks_per_host):
    """The (data, pix) array of ranks that :func:`make_mesh` builds its
    mesh on. Ranks are numbered host-major (torchrun's order), so rank
    ``r`` runs on host ``r // ranks_per_host``."""
    devices = [int(d) for d in devices]
    n = len(devices)
    n_proc = len({d // ranks_per_host for d in devices})
    if data is None and pix is None:
        if n_proc > 1:
            data, pix = n_proc, n // n_proc
        else:
            data, pix = n, 1
    elif data is None:
        data = n // pix
    elif pix is None:
        pix = n // data
    assert data * pix == n, (data, pix, n)
    if n_proc > 1:
        # Host-major layout: each length-``pix`` mesh row must live inside
        # one host, so that its collectives stay on the host's links.
        devices = sorted(devices, key=lambda d: (d // ranks_per_host, d))
        per_proc = n // n_proc
        if pix > 1 and per_proc % pix != 0:
            raise ValueError(
                f'pix={pix} does not divide the ranks of a host '
                f'({per_proc}); pixel-axis collectives would cross hosts')
    return np.asarray(devices, np.int64).reshape(data, pix)


def make_mesh(data=None, pix=None, devices=None):
    """Builds a mesh of ranks with axes ('data', 'pix').

    One host: by default every rank on the 'data' axis. Several hosts:
    ranks laid out host-major, and the defaults become ``data`` = the
    number of hosts and ``pix`` = the ranks of a host, so that the
    pixel-axis collectives stay within a host.

    In a process that has joined no process group (a single-process run),
    it first makes a group of one on a ``torch.distributed.HashStore``
    (gloo; no collective runs on it), so that a one-rank mesh goes through
    the same code as a larger one. Every rank of the world must call it,
    in the same order, since building the axes' groups is collective.

    Args:
        data: size of the data-parallel axis (default: all ranks if
            ``pix`` is unset, else ``n_ranks // pix``; several hosts: the
            number of hosts).
        pix: size of the pixel-row axis (default 1, or ``n_ranks // data``
            if ``data`` is given; several hosts: the ranks of a host).
        devices: the global ranks of the mesh (default: every rank).

    Returns:
        ``torch.distributed.device_mesh.DeviceMesh`` with
        ``mesh_dim_names=('data', 'pix')``.
    """
    if not dist.is_initialized():
        dist.init_process_group('gloo', store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    if devices is None:
        devices = range(world)
    layout = _layout(data, pix, devices, _ranks_per_host(world))
    if dist.get_rank() not in layout:
        raise ValueError(f'rank {dist.get_rank()} is not in the mesh '
                         f'{layout.tolist()}')
    device_type = 'cuda' if 'nccl' in str(dist.get_backend()) else 'cpu'
    return DeviceMesh(device_type, torch.as_tensor(layout),
                      mesh_dim_names=AXES)


def axis(mesh, name):
    """(size, this rank's index) of the mesh axis ``name``."""
    dim = mesh.mesh_dim_names.index(name)
    return mesh.size(dim), mesh.get_local_rank(dim)


def flat_index(mesh):
    """(number of ranks, this rank's index) over both axes, data-major."""
    ndata, di = axis(mesh, 'data')
    npix, pi = axis(mesh, 'pix')
    return ndata * npix, di * npix + pi


def _all_reduce(tensor, mesh):
    """Sums ``tensor`` in place over every rank of the mesh: over each
    axis of more than one rank, in the axes' order."""
    for dim in range(mesh.ndim):
        if mesh.size(dim) > 1:
            dist.all_reduce(tensor, group=mesh.get_group(dim))
    return tensor


class _Replicate(torch.autograd.Function):

    @staticmethod
    def forward(ctx, mesh, *tensors):
        ctx.mesh = mesh
        # an output no gradient reaches stays None backward, and so does its
        # input's gradient: autograd then skips the input's graph (the
        # render's z and normals). Which outputs get one is the graph's
        # doing, the same on every rank, so the ranks' all_reduces match.
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        # one all_reduce a gradient, in the inputs' order on every rank
        out = [None]
        for g, needed in zip(grads, ctx.needs_input_grad[1:]):
            out.append(_all_reduce(g.contiguous().clone(), ctx.mesh)
                       if needed and g is not None else None)
        return tuple(out)


def replicate(mesh, *tensors):
    """The identity on tensors that every rank of ``mesh`` holds whole;
    backward, each one's gradient is summed over the mesh, so that every
    rank gets the sum of all ranks' partials. ``None`` passes through."""
    with span('kaolin.replicate'):
        live = [t for t in tensors if t is not None]
        out = iter(_Replicate.apply(mesh, *live) if live else ())
        return tuple(None if t is None else next(out) for t in tensors)


class _MeshSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, mesh, tensor):
        return _all_reduce(tensor.contiguous().clone(), mesh)

    @staticmethod
    def backward(ctx, grad):
        # identity: every rank computes the same loss from the sum, and the
        # replicated inputs' all_reduce adds the ranks' partials once
        return None, grad


def mesh_sum(mesh, tensor):
    """Sum of ``tensor`` over every rank of ``mesh``, on every rank; the
    gradient passes through to this rank's ``tensor`` unchanged."""
    with span('kaolin.mesh_sum'):
        return _MeshSum.apply(mesh, tensor)
