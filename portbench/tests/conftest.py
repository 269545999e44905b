"""Shared pieces of the benchmark's CPU tests: cells cut to a tiny size
(2 objects, 64x64, an icosphere of subdivision 2), run on the CPU
through the measured package's plain versions."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402


def tiny(cell):
    cell.config = dict(cell.config, subdiv=2, height=64, width=64,
                       texture_size=16)
    cell.traffic = dict(cell.traffic, batch=2, reference_rows=1)
    return cell


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_cell(monkeypatch):
    monkeypatch.setattr(harness, 'WARMUP_STEPS', 1)
    monkeypatch.setattr(harness, 'TRACE_STEPS', 2)
    return lambda name: tiny(harness.Cell(name))
