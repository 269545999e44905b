"""The benchmark of ``kaolin_tpu_torch``: one cell, one seed, one run.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` loads the cell from ``BENCHMARK.json``, finds its files
by name (``configs/<config>.json`` as the manifest names it,
``traffic/<traffic>.json``, ``limits/<cell>.json``, the step generator
``steps/<step>.py`` that the traffic file names, ``metrics/<metric>.py``
and ``bounds/<kernel>.py``), builds the scene from the seed on the card,
runs the fit's first steps and a warm-up (set-up), then measures for
``--seconds`` (``--trace 0``: the end-to-end metrics) or traces a short
window (``--trace 1``: the per-layer metrics), then holds the first steps
against the plain reference (``reference/``) and prints one JSON line.
A cell of 4 chips runs in 4 processes, one a card (``multichip.py``).
"""

import argparse
import importlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names no run may load (compared whole: the measured
# package's name begins with the second)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'kaolin_tpu', '__graft_entry__')
FIRST_STEPS = 3          # the steps the reference follows
WARMUP_STEPS = 3         # steps after them, before the window
TRACE_STEPS = 20         # steps of a traced window (--trace 1)
CHECK_NAMES = ('loss_gap', 'grad_gap', 'change_gap')


def forbidden_modules():
    return sorted({m.partition('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


# ---- the manifest and the files it names -----------------------------------

class Cell:
    """One workload of ``BENCHMARK.json`` with its files."""

    def __init__(self, name):
        manifest = json.loads((ROOT / 'BENCHMARK.json').read_text())
        cells = {w['name']: w for w in manifest['workloads']}
        if name not in cells:
            raise SystemExit(f'no workload {name!r} in BENCHMARK.json')
        w = cells[name]
        configs = {c['name']: c for c in manifest['configs']}
        self.name, self.chips = name, w['chips']
        self.config = json.loads((ROOT / configs[w['config']]['file'])
                                 .read_text())
        self.traffic = json.loads((BENCH / 'traffic'
                                   / f"{w['traffic']}.json").read_text())
        self.limits = json.loads((BENCH / 'limits' / f'{name}.json')
                                 .read_text())
        self.step = importlib.import_module(
            f"portbench.steps.{self.traffic['step']}")
        self.end_to_end = [m for m in manifest['end_to_end']
                           if name in m.get('workloads', [name])]
        self.per_layer = [m for m in manifest['per_layer']
                          if name in m.get('workloads', [name])]

    def kernels(self):
        """call -> (NAMES, MEMSET_BEFORE, module) of the step's kernels."""
        out = {}
        for k in self.step.KERNELS:
            mod = importlib.import_module(f'portbench.bounds.{k}')
            out[k] = (mod.NAMES, mod.MEMSET_BEFORE, mod)
        return out


# ---- the fit, through the measured package ---------------------------------

class Fit:
    """The training object: the leaves, Adam over them and the step.

    The update is ``torch.optim.adam.adam(..., fused=True)``, the function
    that ``torch.optim.Adam(fused=True).step`` calls, over state held here:
    the class's first construction imports ``torch._dynamo`` (5 s of every
    run's set-up on the card's machine), the function does not.

    ``fault`` plants a fault for the benchmark's own checks: 'unchanged'
    skips the update; the others go to the step's loss
    (``steps/<step>.py``)."""

    def __init__(self, cell, inp, fault=None, mesh=None):
        import torch
        opt = cell.config['optimizer']
        self.cell, self.inp, self.fault, self.mesh = cell, inp, fault, mesh
        self.leaves = {k: v.detach().clone().requires_grad_(True)
                       for k, v in inp['leaves'].items()}
        self.lr, (self.beta1, self.beta2), self.eps = (
            opt['lr'], opt['betas'], opt['eps'])
        params = list(self.leaves.values())
        self.exp_avg = [torch.zeros_like(p) for p in params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in params]
        self.steps = [torch.zeros((), device=p.device) for p in params]

    def step(self):
        from torch.optim.adam import adam
        params = list(self.leaves.values())
        for p in params:
            p.grad = None
        loss = self.cell.step.program_loss(self.inp, self.leaves, self.fault,
                                           self.mesh)
        loss.backward()
        if self.fault != 'unchanged':
            adam(params, [p.grad for p in params], self.exp_avg,
                 self.exp_avg_sq, [], self.steps, fused=True, amsgrad=False,
                 beta1=self.beta1, beta2=self.beta2, lr=self.lr,
                 weight_decay=0., eps=self.eps, maximize=False)
        return loss.detach()

    def first_gradient(self):
        """Each leaf's gradient as the update took it in its first step,
        worked out from its state after that step: Adam's first moment over
        (1 - beta1)."""
        return {k: (m / (1. - self.beta1)).cpu()
                for k, m in zip(self.leaves, self.exp_avg)}


def first_steps(fit):
    """Runs the fit's first steps; returns what the reference is held
    against: the losses, the first gradient, the leaves after them."""
    losses = []
    for i in range(FIRST_STEPS):
        losses.append(fit.step())
        if i == 0:
            grad = fit.first_gradient()
    return dict(losses=[float(v) for v in losses], grad=grad,
                leaves={k: v.detach().to('cpu', copy=True)
                        for k, v in fit.leaves.items()})


# ---- the plain reference ---------------------------------------------------

def reference_fit(cell, inp, dtype=None, rows=None):
    """The reference's first steps from the same seeded leaves: losses,
    first gradient and the leaves after them, the batch taken in blocks of
    ``traffic['reference_rows']`` objects. ``dtype`` computes it in
    another precision (the control); ``rows`` (a slice) follows those
    objects only, and the losses are then their share."""
    import torch
    opt = cell.config['optimizer']
    lr, (b1, b2), eps = opt['lr'], opt['betas'], opt['eps']
    if dtype is not None:
        inp = {k: (v.to(dtype) if torch.is_tensor(v)
                   and v.is_floating_point() else v) for k, v in inp.items()}
        inp['leaves'] = {k: v.to(dtype) for k, v in inp['leaves'].items()}
    leaves = {k: v.detach().clone() for k, v in inp['leaves'].items()}
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    batch = next(iter(leaves.values())).shape[0]
    block = cell.traffic['reference_rows']
    rows = rows or slice(0, batch)
    losses, grad0 = [], None
    for t in range(1, FIRST_STEPS + 1):
        grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
        total = 0.
        for lo in range(rows.start, rows.stop, block):
            part = slice(lo, min(lo + block, rows.stop))
            sub = {k: v[part].clone().requires_grad_(True)
                   for k, v in leaves.items()}
            loss = cell.step.reference_loss(inp, sub, part, batch)
            loss.backward()
            for k in leaves:
                grads[k][part] = sub[k].grad
            total += float(loss.detach())
            del loss, sub
        losses.append(total)
        if t == 1:
            grad0 = {k: g.detach().float().cpu() for k, g in grads.items()}
        for k in leaves:
            g = grads[k]
            m[k] = b1 * m[k] + (1 - b1) * g
            v2[k] = b2 * v2[k] + (1 - b2) * g * g
            denom = (v2[k].sqrt() / math.sqrt(1 - b2 ** t)) + eps
            leaves[k] = leaves[k] - (lr / (1 - b1 ** t)) * m[k] / denom
    return dict(losses=losses, grad=grad0,
                leaves={k: v.detach().float().cpu() for k, v in
                        leaves.items()})


def readings(prog, ref, start):
    """The numbers compared, each against the reference: ``loss_gap``, the
    largest relative gap of a first step's loss; ``grad_gap`` and
    ``change_gap``, over the leaves, the gap between the program's and the
    reference's norm of the first gradient and of the change after the
    first steps, over the larger of the reference's norm of that leaf and
    of the median leaf. Leaves whose reference gradient is under a
    thousandth of the median leaf's are left out of ``change_gap``."""
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(prog['losses'], ref['losses']))

    def gap(p, r, keys):
        norms = {k: float(r[k].double().norm()) for k in r}
        med = statistics.median(norms.values())
        return max(abs(float(p[k].double().norm()) - norms[k])
                   / max(norms[k], med, 1e-30) for k in keys)

    gnorm = {k: float(g.double().norm()) for k, g in ref['grad'].items()}
    gmed = statistics.median(gnorm.values())
    moved = [k for k in gnorm if gnorm[k] >= 1e-3 * gmed]
    change = {k: prog['leaves'][k].double() - start[k].double()
              for k in start}
    rchange = {k: ref['leaves'][k].double() - start[k].double()
               for k in start}
    for k in start:
        log(f"leaf {k}: grad norm {float(prog['grad'][k].double().norm()):.9e}"
            f" / ref {gnorm[k]:.9e}; change {float(change[k].norm()):.9e}"
            f" / ref {float(rchange[k].norm()):.9e}")
    return dict(loss_gap=loss_gap,
                grad_gap=gap(prog['grad'], ref['grad'], list(gnorm)),
                change_gap=gap(change, rchange, moved))


def verdict(values, limits):
    """(correct, the checks for the result line)."""
    checks = {k: dict(value=values[k], limit=limits[k]) for k in CHECK_NAMES}
    ok = all(math.isfinite(values[k]) and values[k] <= limits[k]
             for k in CHECK_NAMES)
    return ok, checks


# ---- one run ---------------------------------------------------------------

def card_name():
    """(name, power limit) from ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return 'unknown'
    return out[0] if out else 'unknown'


class HostEvent:
    """``torch.cuda.Event``'s interface on the host's clock, for runs on the
    CPU (the tests)."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def window(fit, seconds, sync, event, count=None):
    """Steps dispatched ahead for ``seconds`` of the host's clock (or
    ``count`` steps), then one synchronize. Returns (steps, window
    seconds, step ms from the end-of-step events, failed steps)."""
    import torch
    sync()
    start = event()
    events, losses = [], []
    start.record()
    t0 = time.perf_counter()
    while (len(events) < count if count is not None
           else time.perf_counter() - t0 < seconds):
        losses.append(fit.step())
        ev = event()
        ev.record()
        events.append(ev)
    sync()
    elapsed = time.perf_counter() - t0
    times, prev = [], start
    for ev in events:
        times.append(prev.elapsed_time(ev))
        prev = ev
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    return len(events), elapsed, times, failed


def p95(values):
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20, method='inclusive')[-1]


class Context:
    """What the per-layer readers take."""

    def __init__(self, trace, host_ms, syncs, bounds):
        self.trace, self.host_ms, self.syncs, self.bounds = (trace, host_ms,
                                                             syncs, bounds)


def host_syncs(fit, sync):
    import torch
    sync()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            fit.step()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    sync()
    return sum('called a synchronizing' in str(w.message) for w in caught)


def traced_window(cell, fit, sync, traced=True):
    """The per-layer readings' raw material: a profiled window of
    ``TRACE_STEPS`` steps dispatched ahead, the host's time to enqueue a
    step and the host syncs of a step. ``traced`` False runs
    the same steps unprofiled (the ranks other than 0)."""
    import contextlib
    from torch.profiler import ProfilerActivity, profile, record_function
    from . import trace as tr
    steps = TRACE_STEPS
    sync()
    prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            if traced else contextlib.nullcontext())
    with prof:
        with record_function(tr.WINDOW_SPAN):
            for _ in range(steps):
                fit.step()
            sync()
    kernels = {k: v[:2] for k, v in cell.kernels().items()}
    trace = tr.from_profiler(prof, steps, kernels) if traced else None
    host_ms = []
    for _ in range(steps):
        sync()
        t = time.perf_counter()
        fit.step()
        host_ms.append((time.perf_counter() - t) * 1e3)
    sync()
    return trace, host_ms, host_syncs(fit, sync)


def layer_metrics(cell, trace, host_ms, syncs, bound_inputs):
    from .bounds.common import bound_seconds
    bounds = {k: bound_seconds(*mod.work(bound_inputs))
              for k, (_, _, mod) in cell.kernels().items()}
    ctx = Context(trace, host_ms, syncs, bounds)
    out = {}
    for m in cell.per_layer:
        reader = importlib.import_module(f"portbench.metrics.{m['name']}")
        value = reader.read(ctx)
        if value is not None:
            out[m['name']] = dict(value=float(value), unit=m['unit'])
    return out


def agreed_count(fit, seconds, sync):
    """The ranks' common number of window steps: rank 0's rate over a timed
    run of warm-up steps, times ``seconds``."""
    import torch
    import torch.distributed as dist
    sync()
    t = time.perf_counter()
    for _ in range(WARMUP_STEPS):
        fit.step()
    sync()
    rate = WARMUP_STEPS / (time.perf_counter() - t)
    device = next(iter(fit.leaves.values())).device
    n = torch.tensor([max(2, round(rate * seconds))], device=device)
    dist.broadcast(n, src=0)
    return int(n)


def slice_rows(d, rows):
    return {k: v[rows] for k, v in d.items()}


def rank_rows(mesh, inp):
    """(this rank's objects, the objects it holds against the reference):
    its slice of the batch on the mesh's data axis, and the next rank's,
    which reach it only through the all-reduce."""
    batch = next(iter(inp['leaves'].values())).shape[0]
    ranks, i = mesh.size(0), mesh.get_local_rank(0)
    per = batch // ranks
    nxt = (i + 1) % ranks
    return slice(i * per, (i + 1) * per), slice(nxt * per, (nxt + 1) * per)


def held(prog, ref, start, check=None):
    """:func:`readings` of the whole batch, or on several ranks of the
    objects ``check`` with the losses summed over the ranks (each rank's
    reference follows its ``check`` objects)."""
    if check is not None:
        import torch
        import torch.distributed as dist
        device = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
        losses = torch.tensor(ref['losses'], dtype=torch.float64,
                              device=device)
        dist.all_reduce(losses)
        ref = dict(ref, losses=losses.tolist())
        prog, ref = ({**d, 'grad': slice_rows(d['grad'], check),
                      'leaves': slice_rows(d['leaves'], check)}
                     for d in (prog, ref))
        start = slice_rows(start, check)
    return readings(prog, ref, start)


def run_one(cell, seed, seconds, trace, t_start, device='cuda', fault=None,
            mesh=None):
    """One run on this process's card: the result's fields (a dict). On a
    ``mesh`` of ranks (one process a card), this rank's share."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = cell.config['tf32']
    torch.backends.cudnn.allow_tf32 = cell.config['tf32']
    cuda = device == 'cuda'
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    log(f'stage imported {time.time() - t_start:.3f} s')
    inp = cell.step.make_inputs(cell.config, cell.traffic, seed, device)
    dtype = getattr(torch, cell.config['dtype'])
    wrong = [k for k, v in inp['leaves'].items() if v.dtype != dtype]
    if wrong:
        raise SystemExit(f'leaves {wrong} are not the stated {dtype}')
    sync()
    log(f'stage scene {time.time() - t_start:.3f} s')
    fit = Fit(cell, inp, fault, mesh)
    log(f'stage optimizer {time.time() - t_start:.3f} s')
    prog = first_steps(fit)
    log(f'stage first steps {time.time() - t_start:.3f} s')
    for _ in range(WARMUP_STEPS):
        fit.step()
    count, own, check = None, None, None
    if mesh is not None:
        import torch.distributed as dist
        own, check = rank_rows(mesh, inp)
        if not trace:
            count = agreed_count(fit, seconds, sync)
        dist.barrier()
    sync()
    setup_s = time.time() - t_start
    log(f'stage warm {setup_s:.3f} s')
    out = dict(metrics={})
    if not trace:
        event = ((lambda: torch.cuda.Event(enable_timing=True)) if cuda
                 else HostEvent)
        n, elapsed, times, failed = window(fit, seconds, sync, event, count)
        out['attempted'], out['failed'] = n, failed
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        out['metrics'] = {
            'steps_per_s': dict(value=n / elapsed, unit='steps/s'),
            'step_ms_p95': dict(value=p95(times), unit='ms'),
            'peak_mem_gib': dict(value=peak / 2 ** 30, unit='GiB'),
            'setup_s': dict(value=setup_s, unit='s')}
        out['metrics'] = {m['name']: out['metrics'][m['name']]
                          for m in cell.end_to_end}
    else:
        traced = mesh is None or own.start == 0
        tr, host_ms, syncs = traced_window(cell, fit, sync, traced)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        out['attempted'], out['failed'] = TRACE_STEPS, 0
        if traced:
            leaves = {k: v.detach() for k, v in fit.leaves.items()}
            part = inp
            if own is not None:
                leaves = slice_rows(leaves, own)
                part = dict(inp, **{k: inp[k][own]
                                    for k in cell.step.BATCH_INPUTS})
            out['metrics'] = layer_metrics(
                cell, tr, host_ms, syncs, cell.step.bound_inputs(part, leaves))
            out['device_trace'] = dict(busy_s=tr.busy_s(),
                                       window_s=tr.window_s)
            out['breakdown'] = tr.breakdown()
            del leaves, part
    out['peak'] = peak
    del fit, inp
    if cuda:
        torch.cuda.empty_cache()
    inp = cell.step.make_inputs(cell.config, cell.traffic, seed, device)
    start = {k: v.cpu() for k, v in inp['leaves'].items()}
    t_ref = time.time()
    ref = reference_fit(cell, inp, rows=check)
    log(f'stage reference {time.time() - t_ref:.3f} s')
    out['readings'] = held(prog, ref, start, check)
    return out


def result_line(cell, one, name, count):
    """The contract's last line from :func:`run_one`'s fields."""
    ok, checks = verdict(one['readings'], cell.limits)
    device = dict(platform='gpu', kind=name, count=count,
                  memory_peak_bytes=int(one['peak']))
    if 'device_trace' in one:
        device.update(one['device_trace'])
    line = dict(correct=bool(ok and one['failed'] == 0),
                attempted=one['attempted'], failed=one['failed'],
                metrics=one['metrics'], device=device)
    if 'breakdown' in one:
        line['breakdown'] = one['breakdown']
    line['checks'] = checks
    return line


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start):
    args = parse(argv)
    found = forbidden_modules()
    if found:
        log('forbidden modules loaded:', ', '.join(found))
        return 3
    cell = Cell(args.workload)
    spec = importlib.util.find_spec('kaolin_tpu_torch')
    if spec is None or ROOT not in Path(spec.origin).resolve().parents:
        log('kaolin_tpu_torch is not in this checkout')
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f'{cell.name} needs {cell.chips} CUDA device(s); found '
            f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}')
        return 2
    torch.set_num_threads(1)
    log(f'stage cuda {time.time() - t_start:.3f} s')
    if cell.chips > 1:
        from . import multichip
        line = multichip.run(cell, args, t_start)
    else:
        one = run_one(cell, args.seed, args.seconds, args.trace, t_start)
        line = result_line(cell, one, torch.cuda.get_device_name(0), 1)
    log('card:', card_name())
    return emit(line)


def emit(line):
    """Prints the result line and returns 0; prints nothing and returns
    another code where a rank failed (``line`` None) or where a forbidden
    module is loaded by now, after the window and the reference."""
    found = forbidden_modules()
    if found:
        log('forbidden modules loaded:', ', '.join(found))
        return 3
    if line is None:
        return 4
    for k, c in line['checks'].items():
        log(f"check {k} {c['value']:.6e} limit {c['limit']:.6e}")
    print(json.dumps(line), flush=True)
    return 0
