"""Runs every recipe of ``kaolin_tpu_torch/examples/recipes/`` on the CPU
(``--device cpu``), as ``tests/test_recipes.py`` runs the JAX ones: each
must run to its end with no ``Traceback`` in its output. The deterministic
ones print the same numbers as their JAX counterparts, run here on the
same inputs (held to 1e-3, the digits the port prints)."""

import re
import runpy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / 'kaolin_tpu_torch' / 'examples' / 'recipes'
JAX_RECIPES = ROOT / 'examples' / 'recipes'
RECIPES = sorted(p.relative_to(PORT) for p in PORT.glob('*/*.py')
                 if p.name != '__init__.py')


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _module(rel):
    return 'kaolin_tpu_torch.examples.recipes.' + '.'.join(
        rel.with_suffix('').parts)


def _run(rel, monkeypatch, capsys, *args):
    mod = _module(rel)
    monkeypatch.setattr(sys, 'argv', [mod, '--device', 'cpu', *args])
    runpy.run_module(mod, run_name='__main__', alter_sys=False)
    return capsys.readouterr().out


def test_sixteen_recipes():
    assert len(RECIPES) == 16
    assert {p.parts[0] for p in RECIPES} == {'camera', 'spc', 'dataload',
                                             'preprocess'}


@pytest.mark.parametrize('rel', RECIPES, ids=[p.stem for p in RECIPES])
def test_recipe_runs_on_cpu(rel, monkeypatch, capsys, tmp_path):
    extra = (('--cache-dir', str(tmp_path)) if rel.stem ==
             'fast_mesh_sampling' else ())
    out = _run(rel, monkeypatch, capsys, *extra)
    assert 'Traceback' not in out
    assert out.strip(), rel


def _numbers(pattern, out):
    return [float(x) for match in re.findall(pattern, out)
            for x in re.findall(r'-?\d+\.\d*(?:e[-+]?\d+)?', match)]


_JAX_OUT = {}


def _run_jax(rel, monkeypatch, capsys):
    """The JAX recipe's output, run as ``tests/test_recipes.py`` runs it."""
    if rel not in _JAX_OUT:
        path = str(JAX_RECIPES / rel)
        with monkeypatch.context() as m:
            m.setattr(sys, 'argv', [path])
            runpy.run_path(path, run_name='__main__')
        _JAX_OUT[rel] = capsys.readouterr().out
    return _JAX_OUT[rel]


@pytest.mark.parametrize('rel, pattern', [
    ('spc/spc_conv3d_example.py', r'root color:(.*)'),
    ('spc/spc_conv3d_example.py', r'leaf mean :(.*)'),
    ('spc/spc_trilinear_interp.py', r'interpolated value (\S+)'),
    ('camera/cameras_differentiable.py', r'optimized camera position:(.*)'),
], ids=['conv3d-root', 'conv3d-leaves', 'trilinear', 'differentiable'])
def test_recipe_prints_jax_numbers(rel, pattern, monkeypatch, capsys):
    expect = _numbers(pattern, _run_jax(Path(rel), monkeypatch, capsys))
    got = _numbers(pattern, _run(Path(rel), monkeypatch, capsys))
    assert expect and len(got) == len(expect), (got, expect)
    assert got == pytest.approx(expect, abs=1e-3), (got, expect)
