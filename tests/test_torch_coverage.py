"""The ``coverage`` table of ``chip_smoke.py`` (``chip_coverage.py``) on
the CPU.

Walks every module of ``kaolin_tpu_torch`` and checks that each public
function and class is called by an entry of the table or is excluded with
a reason, so that no module escapes the card's run. Then runs every
entry (its inputs and its CPU call) once, with its backward pass where
the entry has one, at the table's sizes, and checks that its outputs are
on the CPU and that :func:`chip_coverage.compare` finds them equal to
themselves. The card's side of the comparison runs only on the card
(``python3 chip_smoke.py --coverage``).
"""

import pytest
import torch

import chip_coverage as cc


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread: many small tensor ops, under the suite's
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_every_public_name_is_in_the_table_or_excluded():
    public = set(cc.public_names())
    table, excluded = cc.table_names(), set(cc.EXCLUDED)
    assert not public - table - excluded, sorted(public - table - excluded)
    assert not (table | excluded) - public, sorted((table | excluded)
                                                   - public)
    assert not table & excluded, sorted(table & excluded)


def test_exclusions_give_reasons():
    assert all(isinstance(why, str) and len(why) > 20
               for why in cc.EXCLUDED.values())
    assert all(e.why for e in cc.ENTRIES if e.tol != cc.TOL or e.runs_only)


def test_entry_ids_are_unique():
    ids = [e.id for e in cc.ENTRIES]
    assert len(ids) == len(set(ids))


@pytest.mark.parametrize('entry', cc.ENTRIES, ids=lambda e: e.id)
def test_entry_runs_on_the_cpu(entry):
    world = cc.one_rank_world() if entry.world else cc.contextlib.nullcontext()
    with world:
        out = cc.run(entry, 'cpu')
    err, faults = cc.compare(out, out, 'cpu')
    assert err == 0. and not faults, (err, faults)
    if entry.grad:
        grads = out[1]
        assert any(g is not None for g in grads)
