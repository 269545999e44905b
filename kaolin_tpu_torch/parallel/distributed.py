"""Multi-process runtime initialization on ``torch.distributed``.

Port of ``kaolin_tpu/parallel/distributed.py``. The JAX package starts
JAX's multi-process runtime; here each process is one rank of a
``torch.distributed`` process group, one card a rank.

Launch recipe (one process per card), with torchrun::

    torchrun --nproc-per-node 4 train.py

or under SLURM / Open MPI with ``MASTER_ADDR`` and ``MASTER_PORT`` set,
and in ``train.py``, before any collective::

    import kaolin_tpu_torch as kal
    kal.parallel.init_distributed()
    mesh = kal.parallel.make_mesh()   # data across hosts, pix within one

``init_distributed()`` with no arguments and no launcher variables set is
a single-process no-op, so the same script runs unchanged on one card.
"""

import os

import torch
import torch.distributed as dist

__all__ = ['init_distributed', 'is_distributed']


def _env_int(*names):
    for name in names:
        value = os.environ.get(name)
        if value not in (None, ''):
            return int(value)
    return None


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, local_device_ids=None, backend='nccl'):
    """Joins this process to the ``torch.distributed`` process group
    (idempotent).

    Each argument resolves, in order, from the argument itself, then
    torchrun's variables (``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``), then those of SLURM (``SLURM_NTASKS``,
    ``SLURM_PROCID``, ``SLURM_LOCALID``) or Open MPI
    (``OMPI_COMM_WORLD_SIZE``, ``..._RANK``, ``..._LOCAL_RANK``). If
    nothing indicates a multi-process launch, this is a no-op.

    Args:
        coordinator_address: ``'host:port'`` of rank 0's store, or an
            ``init_method`` URL (``'tcp://...'``, ``'file://...'``).
        num_processes, process_id: the world size and this rank.
        local_device_ids: the CUDA device of this rank, as a one-element
            list (default: the local rank).
        backend: ``'nccl'`` (the card's; the default) or ``'gloo'``, which
            also runs where there is no card. Nothing falls back from one
            to the other.

    Returns:
        (rank, world_size).
    """
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()

    if coordinator_address is None and os.environ.get('MASTER_ADDR'):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int('WORLD_SIZE', 'SLURM_NTASKS',
                                 'OMPI_COMM_WORLD_SIZE')
    if process_id is None:
        process_id = _env_int('RANK', 'SLURM_PROCID', 'OMPI_COMM_WORLD_RANK')
    if local_device_ids is None:
        local = _env_int('LOCAL_RANK', 'SLURM_LOCALID',
                         'OMPI_COMM_WORLD_LOCAL_RANK')
        local_device_ids = None if local is None else [local]

    if coordinator_address is None:
        if _cluster_autodetects():
            raise ValueError(
                'init_distributed: the scheduler starts several processes, '
                'but no coordinator is given: set MASTER_ADDR and '
                'MASTER_PORT or pass coordinator_address')
        # Single-process launch: nothing to initialize.
        return 0, 1
    if num_processes is None or process_id is None:
        raise ValueError('init_distributed: a coordinator is given but the '
                         'world size or the rank is not (WORLD_SIZE, RANK)')
    if backend == 'nccl':
        torch.cuda.set_device((local_device_ids or [0])[0])
    init_method = (coordinator_address if '://' in coordinator_address
                   else f'tcp://{coordinator_address}')
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(num_processes),
                            rank=int(process_id))
    return dist.get_rank(), dist.get_world_size()


def _cluster_autodetects():
    """True when SLURM or Open MPI says that this process is one of more
    than one. Reads only the schedulers' documented variables."""
    for var in ('SLURM_NTASKS', 'OMPI_COMM_WORLD_SIZE'):
        raw = os.environ.get(var)
        if raw is not None:
            try:
                if int(raw) > 1:
                    return True
            except ValueError:
                pass
    return False


def is_distributed():
    """True when running as one rank of a world of more than one."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)
