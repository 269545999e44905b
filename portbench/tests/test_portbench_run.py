"""A whole run at a tiny size on the CPU: the last line's keys, the
controls and the planted faults reading as not correct, no forbidden
module loaded, and the exits without a card or without the package."""

import json
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from portbench import control, harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = ['car20k.textured_b64', 'icosphere81k.silhouette_b16']


@pytest.mark.parametrize('name', CELLS)
def test_sound_run_is_correct(name, tiny_cell):
    cell = tiny_cell(name)
    one = harness.run_one(cell, 2 ** 31 + 5, 0.3, 0, time.time(),
                          device='cpu')
    line = harness.result_line(cell, one, 'cpu', 1)
    assert list(line) == ['correct', 'attempted', 'failed', 'metrics',
                          'device', 'checks']
    assert line['correct'] and line['attempted'] >= 1
    assert set(line['metrics']) == {m['name'] for m in cell.end_to_end}
    assert set(line['device']) == {'platform', 'kind', 'count',
                                   'memory_peak_bytes'}
    assert set(line['checks']) == set(harness.CHECK_NAMES)
    json.dumps(line)


def test_forbidden_module_loaded_by_the_reference(tiny_cell, monkeypatch,
                                                  capsys):
    """A forbidden module that the reference loads after the window has
    closed: the run prints no result and exits with another code."""
    cell = tiny_cell(CELLS[1])
    plain = cell.step.reference_loss

    def loading(*args):
        monkeypatch.setitem(sys.modules, 'jax.numpy',
                            types.ModuleType('jax.numpy'))
        return plain(*args)

    for name in list(sys.modules):
        if name.partition('.')[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setattr(cell.step, 'reference_loss', loading)
    one = harness.run_one(cell, 4, 0.1, 0, time.time(), device='cpu')
    line = harness.result_line(cell, one, 'cpu', 1)
    assert line['correct']
    capsys.readouterr()
    assert harness.emit(line) != 0
    out = capsys.readouterr()
    assert out.out == '' and 'jax' in out.err
    monkeypatch.delitem(sys.modules, 'jax.numpy')
    assert harness.emit(line) == 0
    assert json.loads(capsys.readouterr().out) == line


@pytest.mark.parametrize('fault', ['unchanged', 'half_batch', 'altered'])
@pytest.mark.parametrize('name', CELLS)
def test_fault_is_not_correct(name, fault, tiny_cell):
    """The timed path broken underneath: the run reads not correct."""
    cell = tiny_cell(name)
    one = harness.run_one(cell, 9, 0.1, 0, time.time(), device='cpu',
                          fault=fault)
    assert not harness.result_line(cell, one, 'cpu', 1)['correct']


@pytest.mark.parametrize('name', CELLS)
def test_control_fails_the_limits(name, tiny_cell):
    """The reference in bfloat16 in the program's place fails a limit."""
    cell = tiny_cell(name)
    got = control.seed_readings(cell, 3, 'cpu', controls=True)
    assert harness.verdict(got['sound'], cell.limits)[0]
    assert not harness.verdict(got['bfloat16'], cell.limits)[0]


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', CELLS[0],
         '--seed', '1', '--seconds', '1', '--trace', '0', *extra], cwd=cwd,
        capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip('a card is here')
    done = _run(ROOT)
    assert done.returncode != 0 and done.stdout.strip() == ''


def test_bare_checkout_no_result(tmp_path):
    """With only BENCHMARK.json and the benchmark's files, a run fails and
    prints nothing."""
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(ROOT / 'portbench', tmp_path / 'portbench')
    done = _run(tmp_path)
    assert done.returncode != 0 and done.stdout.strip() == ''


@pytest.mark.cuda
def test_cells_on_the_card():
    """Every one-chip cell, one short run on the card: correct."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    manifest = json.loads((ROOT / 'BENCHMARK.json').read_text())
    for w in manifest['workloads']:
        if w['chips'] > torch.cuda.device_count():
            continue
        done = subprocess.run(
            [sys.executable, 'portbench/run.py', '--workload', w['name'],
             '--seed', '7', '--seconds', '2', '--trace', '0'], cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        assert done.returncode == 0, done.stderr[-3000:]
        assert json.loads(done.stdout.strip().splitlines()[-1])['correct']
