"""Reduction of a ``torch.profiler`` trace of the traced window to what the
per-layer readers take: the device activities inside the window, each
attributed to a kernel call of the measured package (by the names in
``portbench/bounds/<kernel>.py``), to NCCL or to PyTorch's own tensor
ops; the device's busy time (the union of the activities' intervals);
the longest idle gaps, named by what the host was doing when each began.
"""

import re
from dataclasses import dataclass

WINDOW_SPAN = 'portbench.window'
_IDENT = re.compile(r'[A-Za-z_]\w*')


@dataclass
class DeviceOp:
    name: str
    start: int          # ns
    end: int
    kind: str           # 'kernel', 'memset' or 'memcpy'
    owner: str = ''     # the kernel call of the package, 'nccl' or ''


@dataclass
class Trace:
    window: tuple       # (start ns, end ns)
    ops: list           # DeviceOp, by start
    host: list          # (start ns, end ns, name) of the host's ops
    steps: int

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_s(self):
        """Seconds in which some activity ran on the device."""
        total, cur_s, cur_e = 0, None, None
        for op in self.ops:
            if cur_e is None or op.start > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = op.start, op.end
            else:
                cur_e = max(cur_e, op.end)
        if cur_e is not None:
            total += cur_e - cur_s
        return total * 1e-9

    def seconds(self, owner):
        return sum(op.end - op.start for op in self.ops
                   if op.owner == owner) * 1e-9

    def gaps(self):
        """Idle intervals of the device inside the window: (start, end)."""
        out, last = [], self.window[0]
        for op in self.ops:
            if op.start > last:
                out.append((last, op.start))
            last = max(last, op.end)
        if self.window[1] > last:
            out.append((last, self.window[1]))
        return out

    def host_doing(self, t):
        """The innermost host op running at ``t``, or 'host'."""
        best = None
        for s, e, name in self.host:
            if s <= t < e and (best is None or s >= best[0]):
                best = (s, name)
        return best[1] if best else 'host'

    def breakdown(self, top=10):
        by_name = {}
        for op in self.ops:
            by_name[op.name] = by_name.get(op.name, 0) + op.end - op.start
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return dict(device_ops=[[n, t * 1e-9] for n, t in ops],
                    idle_gaps=[[self.host_doing(s), (e - s) * 1e-9]
                               for s, e in gaps])


def _kind(name):
    if name.startswith('Memset'):
        return 'memset'
    if name.startswith('Memcpy'):
        return 'memcpy'
    return 'kernel'


def attribute(ops, kernels):
    """Sets each op's owner: the kernel call whose names (``kernels``: call
    -> (NAMES, MEMSET_BEFORE)) hold one of its identifiers, 'nccl' for
    NCCL's kernels; a memset belongs to the call of the next kernel when
    that kernel is named in the call's MEMSET_BEFORE."""
    by_ident, memset_next = {}, {}
    for call, (names, before) in kernels.items():
        for n in names:
            by_ident[n] = call
        for n in before:
            memset_next[n] = call
    for i, op in enumerate(ops):
        idents = _IDENT.findall(op.name)
        if op.kind == 'kernel':
            if any(t.lower().startswith('nccl') for t in idents):
                op.owner = 'nccl'
            for t in idents:
                if t in by_ident:
                    op.owner = by_ident[t]
                    break
        elif op.kind == 'memset':
            nxt = next((o for o in ops[i + 1:] if o.kind == 'kernel'), None)
            if nxt is not None:
                for t in _IDENT.findall(nxt.name):
                    if t in memset_next:
                        op.owner = memset_next[t]
                        break


def from_profiler(prof, steps, kernels):
    """A :class:`Trace` of the span ``WINDOW_SPAN`` of a finished
    ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    window, host, ops = None, [], []
    for e in events:
        name = e.name()
        if e.is_user_annotation():
            # a span (the window's, the optimizer's) and its copy on the
            # device's timeline: not an activity of the device
            if name == WINDOW_SPAN and e.device_type() == DeviceType.CPU:
                window = (e.start_ns(), e.end_ns())
        elif e.device_type() == DeviceType.CUDA:
            ops.append(DeviceOp(name, e.start_ns(), e.end_ns(), _kind(name)))
        else:
            host.append((e.start_ns(), e.end_ns(), name))
    if window is None:
        raise RuntimeError(f'the trace holds no span {WINDOW_SPAN!r}')
    ops = sorted((o for o in ops if o.end > window[0] and o.start < window[1]),
                 key=lambda o: o.start)
    for o in ops:
        o.start, o.end = max(o.start, window[0]), min(o.end, window[1])
    attribute(ops, kernels)
    host = [h for h in host if h[1] > window[0] and h[0] < window[1]]
    return Trace(window, ops, host, steps)


def roofline(ctx, call):
    """100 x (bound seconds a call x steps) / (device seconds of the call's
    activities), or None where the call did not run or has no bound."""
    bound = ctx.bounds.get(call)
    spent = ctx.trace.seconds(call)
    if bound is None or not spent:
        return None
    return 100. * bound * ctx.trace.steps / spent
