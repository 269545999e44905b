"""A cell of several chips: one process a card, joined by NCCL.

The parent (the process of ``run.py``) builds the step's kernel
libraries once, so that the ranks do not build them at once, starts one
rank a card (``python3 portbench/multichip.py --rank r ...``) with a free
port of this host and a deadline, waits for every rank, and prints the
result from theirs: rank 0's rate and step times, the largest peak
memory, each number compared at its worst over the ranks; none where a
rank loaded a forbidden module.

Every rank builds the whole scene from the seed (the sharded render's
contract: every rank holds the whole batch), runs the same number of steps
(the ranks meet in every step's all-reduce, so rank 0 fixes the count
from a timed warm-up), and holds the objects of the next rank's data slice
against the reference: rows that it holds only through the all-reduce.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from portbench import harness  # noqa: E402

DEADLINE_S = 330


def free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def run(cell, args, t_start):
    """The parent: the result line, or None if a rank failed."""
    from kaolin_tpu_torch.kernels import _build
    _build.build_all(cell.step.SOURCES)
    port = free_port()
    cmd = [sys.executable, os.path.abspath(__file__), '--workload',
           cell.name, '--seed', str(args.seed), '--seconds',
           str(args.seconds), '--trace', str(args.trace), '--port',
           str(port), '--world', str(cell.chips), '--t-start', repr(t_start)]
    # the ranks write to files of TMPDIR, which no pipe's size can block
    files = [(tempfile.TemporaryFile('w+'), tempfile.TemporaryFile('w+'))
             for _ in range(cell.chips)]
    procs = [subprocess.Popen(cmd + ['--rank', str(r)], stdout=o, stderr=e)
             for r, (o, e) in enumerate(files)]
    outs, failed = [], False
    deadline = t_start + DEADLINE_S
    # a rank that fails leaves the others waiting in a collective: end them
    while any(p.poll() is None for p in procs):
        late = time.time() > deadline
        if late or any(p.poll() not in (None, 0) for p in procs):
            for p in procs:
                p.kill()
            if late:
                harness.log(f'the ranks passed the deadline of {DEADLINE_S} s')
        time.sleep(0.2)
    for p in procs:
        p.wait()
    for r, (p, (o, e)) in enumerate(zip(procs, files)):
        o.seek(0)
        e.seek(0)
        out, err = o.read(), e.read()
        o.close()
        e.close()
        if r == 0 or p.returncode != 0:
            harness.log(f'--- rank {r} (exit {p.returncode}) ---\n{err}')
        if p.returncode != 0:
            failed = True
            continue
        outs.append(json.loads(out.strip().splitlines()[-1]))
    if failed:
        return None
    found = sorted(set().union(*(o['forbidden'] for o in outs)))
    if found:
        harness.log('forbidden modules loaded by a rank:', ', '.join(found))
        return None
    return combine(cell, outs)


def combine(cell, outs):
    """The result line from the ranks' fields (rank 0's first)."""
    first = outs[0]
    one = dict(first, peak=max(o['peak'] for o in outs),
               readings={k: max(o['readings'][k] for o in outs)
                         for k in harness.CHECK_NAMES},
               failed=sum(o['failed'] for o in outs))
    if 'peak_mem_gib' in one['metrics']:
        one['metrics']['peak_mem_gib'] = dict(value=one['peak'] / 2 ** 30,
                                              unit='GiB')
    return harness.result_line(cell, one, first['kind'], len(outs))


def rank_main(argv):
    p = argparse.ArgumentParser()
    for name, typ in (('--workload', str), ('--seed', int),
                      ('--seconds', float), ('--trace', int),
                      ('--port', int), ('--world', int), ('--rank', int),
                      ('--t-start', float)):
        p.add_argument(name, type=typ, required=True)
    a = p.parse_args(argv)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    torch.cuda.set_device(a.rank)
    dist.init_process_group('nccl', init_method=f'tcp://localhost:{a.port}',
                            rank=a.rank, world_size=a.world,
                            device_id=torch.device('cuda', a.rank))
    try:
        from kaolin_tpu_torch.parallel import make_mesh
        cell = harness.Cell(a.workload)
        mesh = make_mesh(data=a.world, pix=1)
        one = harness.run_one(cell, a.seed, a.seconds, a.trace, a.t_start,
                              mesh=mesh)
        one['kind'] = torch.cuda.get_device_name(a.rank)
    finally:
        dist.destroy_process_group()
    # read after the reference, the last thing the rank runs
    one['forbidden'] = harness.forbidden_modules()
    print(json.dumps(one), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(rank_main(sys.argv[1:]))
