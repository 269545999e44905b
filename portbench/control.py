"""Readings that the limits of ``portbench/limits/<cell>.json`` are set
from, at the cell's own size: the sound program's first steps against the
plain reference on many seeds (the lower readings), and on a few seeds
the controls (the upper readings): the reference computed in bfloat16 in
the program's place, and the program with a fault planted in its step
('half_batch', 'altered'; a state left unchanged reads 1 and needs no
run). The benchmark's own runs do not run this.

    python3 portbench/control.py --workload <cell> --seeds 11,12,... \
        --control-seeds 3 [--out chiprun_out/control_<cell>.json]
"""

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from portbench import harness  # noqa: E402

FAULTS = ('half_batch', 'altered')


def seed_readings(cell, seed, device, controls, mesh=None):
    """{kind: readings} of one seed: 'sound' always, with ``controls`` also
    'bfloat16' and each fault ('no_exchange' too on a ``mesh`` of
    ranks, where each rank reads the objects it holds through the
    all-reduce)."""
    import torch
    inp = cell.step.make_inputs(cell.config, cell.traffic, seed, device)
    start = {k: v.cpu() for k, v in inp['leaves'].items()}
    check = None if mesh is None else harness.rank_rows(mesh, inp)[1]
    faults = FAULTS + (('no_exchange',) if mesh is not None else ())
    progs = {}
    for fault in (None,) + (faults if controls else ()):
        fit = harness.Fit(cell, inp, fault, mesh)
        progs[fault or 'sound'] = harness.first_steps(fit)
        del fit
    ref = harness.reference_fit(cell, inp, rows=check)
    out = {k: harness.held(p, ref, start, check) for k, p in progs.items()}
    if controls:
        low = harness.reference_fit(cell, inp, dtype=torch.bfloat16,
                                    rows=check)
        if check is not None:
            import torch.distributed as dist
            losses = torch.tensor(low['losses'], dtype=torch.float64,
                                  device=device)
            dist.all_reduce(losses)
            low['losses'] = losses.tolist()
        out['bfloat16'] = harness.held(low, ref, start, check)
    return out


def worst_over_ranks(readings, device):
    """Each number at its largest over the ranks."""
    import torch
    import torch.distributed as dist
    kinds = sorted(readings)
    t = torch.tensor([[readings[k][n] for n in harness.CHECK_NAMES]
                      for k in kinds], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return {k: dict(zip(harness.CHECK_NAMES, row))
            for k, row in zip(kinds, t.tolist())}


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--control-seeds', type=int, default=3)
    p.add_argument('--device', default='cuda')
    p.add_argument('--out')
    p.add_argument('--rank', type=int)
    p.add_argument('--port', type=int)
    args = p.parse_args(argv)
    cell = harness.Cell(args.workload)
    if cell.chips > 1 and args.rank is None:
        return spawn(cell, argv)
    mesh = None
    if args.rank is not None:
        import torch
        import torch.distributed as dist
        from kaolin_tpu_torch.parallel import make_mesh
        torch.cuda.set_device(args.rank)
        dist.init_process_group(
            'nccl', init_method=f'tcp://localhost:{args.port}',
            rank=args.rank, world_size=cell.chips,
            device_id=torch.device('cuda', args.rank))
        mesh = make_mesh(data=cell.chips, pix=1)
    seeds = [int(s) for s in args.seeds.split(',')]
    rows = []
    for i, seed in enumerate(seeds):
        t = time.time()
        r = seed_readings(cell, seed, args.device, i < args.control_seeds,
                          mesh)
        if mesh is not None:
            r = worst_over_ranks(r, args.device)
        rows.append(dict(seed=seed, seconds=time.time() - t, readings=r))
        if args.rank in (None, 0):
            print(json.dumps(rows[-1]), flush=True)
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
        if args.rank != 0:
            return 0
    summary = {}
    for kind in ('sound', 'bfloat16') + FAULTS + ('no_exchange',):
        vals = [r['readings'][kind] for r in rows if kind in r['readings']]
        if vals:
            summary[kind] = {
                k: dict(min=min(v[k] for v in vals),
                        max=max(v[k] for v in vals))
                for k in harness.CHECK_NAMES}
    print(json.dumps(dict(workload=cell.name, summary=summary)), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(dict(workload=cell.name, rows=rows, summary=summary), f,
                      indent=1)
    return 0


def spawn(cell, argv):
    """One process a card, as ``multichip.run`` starts them."""
    import subprocess
    from kaolin_tpu_torch.kernels import _build
    from portbench.multichip import free_port
    _build.build_all(cell.step.SOURCES)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               *argv, '--rank', str(r), '--port', str(port)])
             for r in range(cell.chips)]
    return max(p.wait() for p in procs)


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
