"""The attribution of a traced window to the program's spans
(``portbench/spans.py``): on a synthetic event list with no card, and on
a tiny cell's real events on the CPU."""

import importlib
import json
import time
import types
from pathlib import Path

import pytest
from torch.autograd import DeviceType

from portbench import harness, spans
from portbench import trace as tr

KERNELS = {'rasterize': (('rasterize_kernel',), ()),
           'rasterize_bwd': (('rasterize_backward_kernel',), ())}
METRICS = sorted(p.stem for p in (Path(harness.BENCH) / 'metrics')
                 .glob('*.py') if p.stem != '__init__')


class Ev:
    """What the reduction reads of a ``torch.profiler`` event."""

    def __init__(self, name, start, end, cuda=False, annotation=False,
                 corr=0, linked=0, seq=-1, thread=1, fwd=0):
        self._v = dict(name=name, start_ns=start, end_ns=end,
                       device_type=DeviceType.CUDA if cuda
                       else DeviceType.CPU,
                       is_user_annotation=annotation, correlation_id=corr,
                       linked_correlation_id=linked, sequence_nr=seq,
                       start_thread_id=thread, fwd_thread_id=fwd)

    def __getattr__(self, key):
        return lambda: self._v[key]


def span(name, start, end, corr, thread=1):
    return Ev(name, start, end, annotation=True, corr=corr, thread=thread)


def op(name, start, end, corr, seq=-1, thread=1, fwd=0):
    return Ev(name, start, end, corr=corr, seq=seq, thread=thread, fwd=fwd)


def kernel(name, start, end, linked, corr=0):
    return Ev(name, start, end, cuda=True, linked=linked, corr=corr)


# a step: the face prep and the rasterizer in spans, the loss outside;
# backward on thread 2; a kernel launched under a span but outside every
# op (found by its runtime call), a memset with no launching op or call
HOST = [
    span('portbench.window', 0, 1000, 1),
    span('kaolin.prepare_vertices', 10, 100, 2),
    span('kaolin.index_vertices_by_faces', 20, 50, 3),
    op('aten::to', 21, 24, 4, seq=7),
    op('aten::index', 25, 45, 5, seq=7),
    op('aten::mul', 60, 70, 6, seq=8),
    span('kaolin.rasterize', 110, 300, 7),
    op('_Rasterize', 120, 290, 8, seq=9),
    op('aten::abs', 310, 320, 9, seq=10),
    op('AbsBackward0', 400, 420, 10, seq=10, thread=2, fwd=1),
    op('aten::sgn', 405, 415, 11, thread=2),
    op('_RasterizeBackward', 430, 500, 12, seq=9, thread=2, fwd=1),
    op('IndexBackward0', 510, 560, 13, seq=7, thread=2, fwd=1),
    op('aten::index_put_', 515, 555, 14, thread=2),
    op('torch::autograd::AccumulateGrad', 570, 580, 15, thread=2),
    Ev('cudaLaunchKernel', 26, 30, corr=900, linked=5),
    Ev('cudaLaunchKernel', 115, 118, corr=901),
    Ev('kaolin.rasterize', 150, 250, cuda=True, annotation=True,
       linked=7),
]
DEVICE = [
    kernel('index_elementwise_kernel', 50, 80, 5),
    kernel('vectorized_elementwise_kernel', 80, 90, 6),
    kernel('rasterize_kernel', 150, 250, 8),
    kernel('abs_kernel', 330, 340, 9),
    kernel('sgn_kernel', 420, 430, 11),
    kernel('rasterize_backward_kernel', 440, 480, 12),
    kernel('indexing_backward_kernel', 520, 600, 14),
    kernel('accumulate_kernel', 600, 610, 15),
    kernel('bin_kernel', 620, 640, 0, corr=901),
    kernel('Memset (Device)', 700, 710, 0),
]
EXPECTED = ['kaolin.index_vertices_by_faces', 'kaolin.prepare_vertices',
            'kaolin.rasterize', 'outside', 'outside', 'kaolin.rasterize',
            'kaolin.index_vertices_by_faces', 'outside', 'kaolin.rasterize',
            'outside']


def reduce(events):
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    trace = tr.from_profiler(prof, 2, KERNELS)
    return trace, spans.Spans(events, trace)


def stripped(events):
    return [e for e in events
            if not (e.is_user_annotation() and e.name().startswith('kaolin.'))]


def test_activities_go_to_the_innermost_span_or_the_forward_op():
    trace, s = reduce(HOST + DEVICE)
    assert [op.name for op in trace.ops] == [e.name() for e in DEVICE]
    assert s.of_op == EXPECTED
    assert s.unlinked == 1


def test_time_by_span_adds_up_to_the_total():
    trace, s = reduce(HOST + DEVICE)
    by = s.seconds()
    assert by['outside'] == pytest.approx(40e-9)
    assert by['kaolin.index_vertices_by_faces'] == pytest.approx(110e-9)
    assert by['kaolin.rasterize'] == pytest.approx(160e-9)
    assert sum(by.values()) == pytest.approx(
        sum(op.end - op.start for op in trace.ops) * 1e-9)
    tensor = s.seconds('')
    assert sum(tensor.values()) == pytest.approx(trace.seconds(''))
    # per step (2): the index kernels forward and backward, the mul, the
    # binning
    assert s.program_ops_ms() == pytest.approx((30 + 10 + 80 + 20) * 1e-6
                                               / 2)
    assert s.face_prep_ms() == pytest.approx((30 + 10 + 80) * 1e-6 / 2)
    assert s.program_ops_ms() <= trace.seconds('') * 1e3 / 2


def test_gaps_are_named_by_the_span_they_begin_in():
    trace, s = reduce(HOST + DEVICE)
    names = {g: s.gap_name(g[0]) for g in trace.gaps()}
    assert names[(90, 150)] == 'kaolin.prepare_vertices/host'
    assert names[(250, 330)] == 'kaolin.rasterize/_Rasterize'
    assert names[(430, 440)] == 'kaolin.rasterize/_RasterizeBackward'
    assert names[(340, 420)] == 'host'
    assert names[(610, 620)] == names[(640, 700)] == 'host'
    assert names[(480, 520)] == 'kaolin.rasterize/_RasterizeBackward'
    inside = (150 - 90) + (330 - 250) + (440 - 430) + (520 - 480)
    assert s.program_idle_ms() == pytest.approx(inside * 1e-6 / 2)


def test_spans_change_no_reading_of_the_trace_and_only_gap_names():
    with_spans, s = reduce(HOST + DEVICE)
    without, plain = reduce(stripped(HOST + DEVICE))
    assert [vars(o) for o in with_spans.ops] == [vars(o) for o in without.ops]
    assert with_spans.busy_s() == without.busy_s()
    assert with_spans.gaps() == without.gaps()
    assert with_spans.breakdown() == without.breakdown()
    for m in METRICS:
        read = importlib.import_module(f'portbench.metrics.{m}').read
        assert read(harness.Context(with_spans, [1.], 0, {})) == \
            read(harness.Context(without, [1.], 0, {})), m
    named, bare = s.idle_gaps(), plain.idle_gaps()
    assert bare == with_spans.breakdown()['idle_gaps']
    assert [t for _, t in named] == [t for _, t in bare]
    assert [n.rpartition('/')[2] for n, _ in named] == [n for n, _ in bare]
    assert any(n != b for (n, _), (b, _) in zip(named, bare))
    assert plain.program_ops_ms() is None and plain.of_op == ['outside'] * 10


# nodes of a cell's step and the spans of their forward ops (None: the
# step's own code)
NODES = {
    'car20k.textured_b64': {
        'IndexBackward0': {'kaolin.index_vertices_by_faces'},
        'LinalgCrossBackward0': {'kaolin.CameraExtrinsics.transform',
                                 'kaolin.face_normals'},
        '_RasterizeBackward': {'kaolin.rasterize'},
        '_GridSampleCoordsBackward': {'kaolin.texture_mapping'},
        'ClampBackward1': {None, 'kaolin.CameraExtrinsics.transform'},
        'AbsBackward0': {None}, 'MeanBackward0': {None}},
    'icosphere81k.silhouette_b16': {
        'IndexBackward0': {'kaolin.index_vertices_by_faces'},
        'BmmBackward0': {'kaolin.prepare_vertices'},
        'DivBackward0': {'kaolin.perspective_camera', 'kaolin.mask_iou'},
        '_RasterizeBackward': {'kaolin.rasterize'},
        '_DibrSoftMaskBackward': {'kaolin.dibr_soft_mask'},
        'AbsBackward0': {None}, 'MeanBackward0': {None, 'kaolin.mask_iou'}},
}


@pytest.mark.parametrize('name', sorted(NODES))
def test_backward_nodes_take_their_forward_ops_span(name, tiny_cell):
    """A tiny cell's real events on the CPU: each backward node is put
    down to the span of the forward op it differentiates."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cell = tiny_cell(name)
    inp = cell.step.make_inputs(cell.config, cell.traffic, 11, 'cpu')
    fit = harness.Fit(cell, inp)
    fit.step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tr.WINDOW_SPAN):
            fit.step()
    events = prof.profiler.kineto_results.events()
    s = spans.Spans(events, tr.from_profiler(prof, 1, {}))
    labels = {}
    for e in events:
        if spans._is_node(e) and e.name() in NODES[name]:
            labels.setdefault(e.name(), set()).add(s.at(e.start_ns()))
    assert labels == NODES[name]


def test_the_tool_on_a_tiny_cell(tiny_cell, capsys, monkeypatch):
    """A traced run of the harness under ``reporting``: the span table and
    the readings on standard error, the run's own fields as without it
    (but the host syncs, which only a card counts)."""
    monkeypatch.setattr(harness, 'host_syncs', lambda fit, sync: 0)
    cell = tiny_cell('car20k.textured_b64')
    plain = tr.from_profiler
    with spans.reporting():
        one = harness.run_one(cell, 2 ** 31 + 7, 0.1, 1, time.time(),
                              device='cpu')
    assert tr.from_profiler is plain
    err = capsys.readouterr().err
    assert 'total' in err and 'idle host:' in err
    got = json.loads(err.split('spans ', 1)[1].splitlines()[0])
    assert got == dict(program_ops_ms_per_step=0., face_prep_ms_per_step=0.,
                       program_idle_ms_per_step=0.)
    line = harness.result_line(cell, one, 'cpu', 1)
    assert line['correct'] and 'device_idle_share' in line['metrics']
