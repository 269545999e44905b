"""Starts a world of ranks on this host and waits for it, with a deadline.

Each rank is a process of its own, started with torchrun's variables
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``; and
``MASTER_ADDR`` / ``MASTER_PORT`` where a port is given), so that
:func:`kaolin_tpu_torch.parallel.init_distributed` finds its place. A rank
that fails ends the world: the others, which may wait in a collective for
it, are killed, and :class:`RankError` carries every failed rank's
traceback. So does a world still running at the deadline. Usage::

    outs = run_ranks(4, [sys.executable, 'my_rank.py', out_dir],
                     deadline=120)
"""

import os
import signal
import subprocess
import tempfile
import time

__all__ = ['RankError', 'run_ranks']

_TAIL = 6000     # characters of a failed rank's stderr in the error


class RankError(RuntimeError):
    """A rank exited with an error, or the world outran its deadline."""


def _kill(proc):
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    proc.wait()


def run_ranks(world, argv, deadline=120., env=None, master_port=None):
    """Runs ``argv`` as ``world`` ranks and waits for all of them.

    Args:
        world (int): number of ranks.
        argv (list of str): the command of every rank.
        deadline (float): seconds the world may take; at the deadline every
            rank still running is killed.
        env (dict, optional): variables added to this process's
            environment for every rank.
        master_port (int, optional): sets ``MASTER_ADDR=localhost`` and
            ``MASTER_PORT``.

    Returns:
        The standard output of each rank, in rank order.

    Raises:
        RankError: a rank exited non-zero (the others are then killed at
            once), or the deadline passed; the message holds the end of
            each failed or killed rank's standard error.
    """
    base = dict(os.environ, **(env or {}), WORLD_SIZE=str(world),
                LOCAL_WORLD_SIZE=str(world))
    if master_port is not None:
        base.update(MASTER_ADDR='localhost', MASTER_PORT=str(master_port))
    with tempfile.TemporaryDirectory(prefix='ranks-') as tmp:
        procs, files = [], []
        try:
            for rank in range(world):
                out = open(os.path.join(tmp, f'{rank}.out'), 'w+')
                err = open(os.path.join(tmp, f'{rank}.err'), 'w+')
                files.append((out, err))
                procs.append(subprocess.Popen(
                    argv, stdout=out, stderr=err, stdin=subprocess.DEVNULL,
                    env=dict(base, RANK=str(rank), LOCAL_RANK=str(rank)),
                    start_new_session=True))
            end = time.monotonic() + deadline
            while True:
                codes = [p.poll() for p in procs]
                if (all(c == 0 for c in codes)
                        or any(c not in (None, 0) for c in codes)
                        or time.monotonic() > end):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                _kill(p)
        texts = []
        for out, err in files:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
            out.close()
            err.close()
    failed = [(rank, code) for rank, code in enumerate(codes)
              if code != 0]
    if failed:
        exited = [f'rank {r} exited with code {c}' for r, c in failed
                  if c is not None]
        why = ', '.join(exited) or f'the deadline of {deadline:g} s passed'
        parts = [f'{why}; killed the ranks still running']
        for rank, code in failed:
            state = 'killed' if code is None else f'exit code {code}'
            parts.append(f'--- rank {rank} ({state}), stderr:\n'
                         f'{texts[rank][1][-_TAIL:]}')
        raise RankError('\n'.join(parts))
    return [out for out, _ in texts]
