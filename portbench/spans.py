"""Device time and idle gaps of a traced window put down to the measured
package's own spans.

While a profiler records, ``kaolin_tpu_torch`` opens a
``record_function`` span named ``kaolin.<public name>`` at each render
entry point (``kaolin_tpu_torch/tracing.py``). :class:`Spans` reads the
profiler's events beside the window's :class:`trace.Trace` and gives each
device activity of the trace the innermost program span around the host
op that launched it: the activity's ``linked_correlation_id`` is that
op's ``correlation_id``. An activity launched outside every op (a kernel
wrapper's own launch under a span) goes by the runtime call that launched
it, which shares its ``correlation_id``, to the span around that call. An
op run inside an autograd node (``*Backward*``) takes the span of the
node's forward op, the op of the node's forward thread and
``sequence_nr`` (of several, the last to start: the one that made the
node). Everything else is ``outside``: the step's own code (shading, the
loss, Adam, gradient accumulation). An idle gap is named as
``Trace.breakdown`` names it, prefixed with the program span active on
the host when it began. Nothing here changes the trace or what its
readers read.

Run alone, it is ``run.py`` with the same arguments and result line, and
with ``--trace 1`` it also prints device ms a step by span, the longest
idle gaps and the three readings to standard error (rank 0's, on a cell
of several chips):

    python3 portbench/spans.py --workload car20k.textured_b64 --seed 7 \
        --seconds 10 --trace 1
"""

import time

T_START = time.time()

import bisect  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from unittest import mock  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from portbench import harness, multichip  # noqa: E402
from portbench import trace as tr  # noqa: E402

PREFIX = 'kaolin.'
OUTSIDE = 'outside'
# the spans whose work prepares the faces: cameras, projection, gathers,
# normals, forward and backward
FACE_PREP = tuple(PREFIX + n for n in (
    'CameraExtrinsics.transform', 'perspective_camera', 'prepare_vertices',
    'index_vertices_by_faces', 'face_normals'))


class _Timeline:
    """The innermost of one thread's nested intervals at a time: built
    from (start, end, label), read as (label, start of its interval)."""

    def __init__(self, items):
        self.t, self.top = [], []
        stack = []
        for s, e, label in sorted(items, key=lambda i: (i[0], -i[1])):
            while stack and stack[-1][1] <= s:
                end = stack.pop()[1]
                self._mark(end, stack)
            stack.append((s, e, label))
            self._mark(s, stack)
        while stack:
            end = stack.pop()[1]
            self._mark(end, stack)

    def _mark(self, t, stack):
        self.t.append(t)
        self.top.append((stack[-1][2], stack[-1][0]) if stack
                        else (None, None))

    def at(self, t):
        i = bisect.bisect_right(self.t, t) - 1
        return self.top[i] if i >= 0 else (None, None)


def _is_node(e):
    return e.sequence_nr() >= 0 and 'Backward' in e.name()


class Spans:
    """The program spans of a profiled window (``events``: the profiler's
    ``kineto_results.events()``) and the attribution of ``trace``'s
    activities and gaps to them."""

    def __init__(self, events, trace):
        from torch.autograd import DeviceType
        self.trace = trace
        w0, w1 = trace.window
        spans, nodes, forward, ops, runtime = {}, [], {}, {}, {}
        device = []
        for e in events:
            if e.device_type() != DeviceType.CPU:
                if (not e.is_user_annotation()
                        and e.device_type() == DeviceType.CUDA
                        and e.end_ns() > w0 and e.start_ns() < w1):
                    device.append(e)
                continue
            th, name = e.start_thread_id(), e.name()
            if name.startswith('cu') and not e.is_user_annotation():
                # a CUDA API call: cudaLaunchKernel, cuLaunchKernel, ...
                runtime[e.correlation_id()] = e.start_ns()
                continue
            ops[e.correlation_id()] = (th, e.start_ns())
            if e.is_user_annotation():
                if name.startswith(PREFIX):
                    spans.setdefault(th, []).append(
                        (e.start_ns(), e.end_ns(), name))
            elif _is_node(e):
                nodes.append((th, e))
            elif e.sequence_nr() >= 0:
                key = (th, e.sequence_nr())
                if forward.get(key, -1) < e.start_ns():
                    forward[key] = e.start_ns()
        self.found = bool(spans)
        own = {th: _Timeline(items) for th, items in spans.items()}

        def span_at(th, t):
            line = own.get(th)
            return line.at(t)[0] if line else None

        items = {th: list(v) for th, v in spans.items()}
        for th, e in nodes:
            fwd = e.fwd_thread_id() or th
            t = forward.get((fwd, e.sequence_nr()))
            label = span_at(fwd, t) if t is not None else None
            items.setdefault(th, []).append((e.start_ns(), e.end_ns(), label))
        self._lines = {th: _Timeline(v) for th, v in items.items()}
        # the activities in the trace's order (``trace.from_profiler``)
        device.sort(key=lambda e: e.start_ns())
        if [e.name() for e in device] != [op.name for op in trace.ops]:
            raise ValueError("the events are not the trace's")
        self.of_op, self.unlinked = [], 0
        for e in device:
            op = ops.get(e.linked_correlation_id())
            if op is not None:
                line = self._lines.get(op[0])
                label = line.at(op[1])[0] if line else None
            elif e.correlation_id() in runtime:
                label = self.at(runtime[e.correlation_id()])
            else:
                self.unlinked += 1
                label = None
            self.of_op.append(label or OUTSIDE)

    def at(self, t):
        """The innermost program span active on the host at ``t`` (over
        every thread, through a node to its forward op), or None."""
        best = (None, None)
        for line in self._lines.values():
            label, since = line.at(t)
            if since is not None and (best[1] is None or since > best[1]):
                best = (label, since)
        return best[0]

    def seconds(self, owner=None):
        """{span or OUTSIDE: device seconds} of the activities (of the
        kernel call ``owner`` only, where given)."""
        out = {}
        for op, label in zip(self.trace.ops, self.of_op):
            if owner is None or op.owner == owner:
                out[label] = out.get(label, 0) + (op.end - op.start) * 1e-9
        return out

    def _ms_per_step(self, seconds):
        return seconds * 1e3 / self.trace.steps if self.found else None

    def program_ops_ms(self):
        """Device ms a step of PyTorch's tensor ops (owner '') launched
        inside a program span."""
        t = self.seconds('')
        return self._ms_per_step(sum(v for k, v in t.items() if k != OUTSIDE))

    def face_prep_ms(self):
        """Device ms a step, forward and backward, of the face prep's
        spans (``FACE_PREP``)."""
        t = self.seconds()
        return self._ms_per_step(sum(t.get(k, 0.) for k in FACE_PREP))

    def program_idle_ms(self):
        """Device idle ms a step in the gaps that begin inside a program
        span."""
        return self._ms_per_step(sum(
            (e - s) * 1e-9 for s, e in self.trace.gaps() if self.at(s)))

    def readings(self):
        return dict(program_ops_ms_per_step=self.program_ops_ms(),
                    face_prep_ms_per_step=self.face_prep_ms(),
                    program_idle_ms_per_step=self.program_idle_ms())

    def gap_name(self, t):
        host = self.trace.host_doing(t)
        label = self.at(t)
        return f'{label}/{host}' if label else host

    def idle_gaps(self, top=10):
        """[name, seconds] of the longest gaps, as ``Trace.breakdown``."""
        gaps = sorted(self.trace.gaps(), key=lambda g: g[0] - g[1])[:top]
        return [[self.gap_name(s), (e - s) * 1e-9] for s, e in gaps]

    def table(self):
        """Device ms a step by span (and of them PyTorch's tensor ops), the
        longest idle gaps by name, as text."""
        steps = self.trace.steps
        every, tensor = self.seconds(), self.seconds('')
        rows = sorted(every, key=lambda k: (k == OUTSIDE, -every[k]))
        lines = [f"{'span':40s} {'ms/step':>9s} {'tensor ops':>10s}"]
        for k in rows:
            lines.append(f'{k:40s} {every[k] * 1e3 / steps:9.4f} '
                         f'{tensor.get(k, 0.) * 1e3 / steps:10.4f}')
        lines.append(f"{'total':40s} {sum(every.values()) * 1e3 / steps:9.4f}"
                     f' {sum(tensor.values()) * 1e3 / steps:10.4f}')
        lines.append(f'activities with no launching op or call: '
                     f'{self.unlinked}')
        lines += [f'idle {n}: {s * 1e3:.4f} ms' for n, s in self.idle_gaps()]
        return '\n'.join(lines)


# ---- the harness's run, with the spans ------------------------------------

@contextlib.contextmanager
def reporting():
    """While open, each window the harness traces (``trace.from_profiler``)
    is also put down to the program's spans: the table and one JSON line of
    the readings go to standard error. The trace, the readers and the
    result line stay as they are."""
    plain = tr.from_profiler

    def from_profiler(prof, steps, kernels):
        trace = plain(prof, steps, kernels)
        spans = Spans(prof.profiler.kineto_results.events(), trace)
        harness.log(spans.table())
        harness.log('spans', json.dumps(spans.readings()))
        return trace

    tr.from_profiler = from_profiler
    try:
        yield
    finally:
        tr.from_profiler = plain


def main(argv, t_start):
    """``run.py``'s run under :func:`reporting`. ``multichip.run`` starts
    its own file once a rank; pointed at this one, each rank runs
    ``multichip.rank_main`` under :func:`reporting` too."""
    with reporting():
        if '--rank' in argv:
            return multichip.rank_main(argv)
        with mock.patch.object(multichip, '__file__',
                               os.path.abspath(__file__)):
            return harness.main(argv, t_start)


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:], T_START))
