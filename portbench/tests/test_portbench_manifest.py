"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding every file of a cell by its name."""

import json
import re
import shutil
import time
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]

MANIFEST = json.loads((Path(ROOT) / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
KEYS = {
    'configs': {'name', 'source', 'file', 'reduced', 'why'},
    'workloads': {'name', 'config', 'traffic', 'chips', 'why'},
    'end_to_end': {'name', 'unit', 'better', 'bound', 'source'},
    'per_layer': {'name', 'unit', 'better', 'source', 'layer', 'moves'},
}


def test_top_level_keys():
    assert set(MANIFEST) == {'command', 'paths', 'run_seconds', 'configs',
                             'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= MANIFEST['run_seconds'] <= 51
    for p in MANIFEST['paths']:
        assert re.fullmatch(r'[A-Za-z0-9_./-]{1,200}', p)
        assert not p.startswith('/') and '..' not in p


@pytest.mark.parametrize('section', sorted(KEYS))
def test_entries(section):
    for e in MANIFEST[section]:
        extra = set(e) - KEYS[section]
        assert extra <= ({'workloads'} if section in ('end_to_end',
                                                      'per_layer') else set())
        assert KEYS[section] <= set(e)
        assert NAME.match(e['name']), e['name']
        if 'unit' in e:
            assert UNIT.match(e['unit']), e['unit']
            assert e['better'] in ('lower', 'higher')
        for key in ('why', 'layer', 'source'):
            if key in e and section != 'end_to_end':
                assert 1 <= len(e[key]) <= 200 and '\n' not in e[key]
    names = [e['name'] for e in MANIFEST[section]]
    assert len(names) == len(set(names))


def test_metrics():
    e2e = {m['name']: m for m in MANIFEST['end_to_end']}
    assert 'setup_s' in e2e
    for m in e2e.values():
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0 < m['bound'] <= 0.25
    cells = [w['name'] for w in MANIFEST['workloads']]
    for m in MANIFEST['per_layer']:
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
        moved = e2e[m['moves']]
        for cell in m.get('workloads', cells):
            assert cell in moved.get('workloads', cells)
        if m['name'].endswith('_roofline'):
            assert m['unit'] == '%'


def test_every_cell_reports_enough():
    for w in MANIFEST['workloads']:
        cell = harness.Cell(w['name'])
        names = {m['name'] for m in cell.end_to_end}
        assert 'setup_s' in names and len(names) >= 2
        assert cell.per_layer
        assert w['chips'] in (1, 4)


def test_files_found_by_name():
    """Every file a cell needs sits under ``portbench`` at a path made from
    a name in the manifest."""
    bench = Path(ROOT) / 'portbench'
    for c in MANIFEST['configs']:
        assert c['file'].startswith('portbench/configs/')
        assert json.loads((Path(ROOT) / c['file']).read_text())
    for w in MANIFEST['workloads']:
        traffic = json.loads((bench / 'traffic'
                              / f"{w['traffic']}.json").read_text())
        assert (bench / 'steps' / f"{traffic['step']}.py").exists()
        assert (bench / 'limits' / f"{w['name']}.json").exists()
        for k in harness.Cell(w['name']).step.KERNELS:
            assert (bench / 'bounds' / f'{k}.py').exists()
    for m in MANIFEST['per_layer']:
        assert (bench / 'metrics' / f"{m['name']}.py").exists()


def test_new_cell_by_files_alone(tmp_path, monkeypatch, tiny_cell):
    """A cell added with a traffic file, a limits file and a manifest entry
    runs with no edit to a file that is there."""
    shutil.copytree(Path(ROOT) / 'portbench', tmp_path / 'portbench')
    manifest = json.loads((Path(ROOT) / 'BENCHMARK.json').read_text())
    manifest['workloads'].append(dict(
        name='car20k.textured_b2', config='car20k', traffic='textured_b2',
        chips=1, why='a test cell'))
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(manifest))
    (tmp_path / 'portbench/traffic/textured_b2.json').write_text(json.dumps(
        dict(step='textured', batch=2, reference_rows=1)))
    (tmp_path / 'portbench/limits/car20k.textured_b2.json').write_text(
        (Path(ROOT) / 'portbench/limits/car20k.textured_b64.json')
        .read_text())
    monkeypatch.setattr(harness, 'ROOT', tmp_path)
    monkeypatch.setattr(harness, 'BENCH', tmp_path / 'portbench')
    cell = harness.Cell('car20k.textured_b2')
    assert cell.traffic['batch'] == 2
    cell.config = dict(cell.config, subdiv=2, height=64, width=64,
                       texture_size=16)
    one = harness.run_one(cell, 5, 0.2, 0, time.time(), device='cpu')
    assert harness.result_line(cell, one, 'cpu', 1)['correct']
