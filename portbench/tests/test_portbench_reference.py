"""The plain reference against the measured package's CPU path at a tiny
size, the kernels' bound arithmetic on a hand-counted case, and the
reference's independence of the measured package."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.bounds import common, rasterize, soft_mask
from portbench.reference import render as ref

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize('name', ['car20k.textured_b64',
                                  'icosphere81k.silhouette_b16'])
def test_reference_matches_the_package(name, tiny_cell):
    """Loss and every leaf's gradient of one step, the package's plain
    CPU versions against the reference, at float32."""
    cell = tiny_cell(name)
    inp = cell.step.make_inputs(cell.config, cell.traffic, 11, 'cpu')
    batch = cell.traffic['batch']
    prog = {k: v.clone().requires_grad_(True)
            for k, v in inp['leaves'].items()}
    loss = cell.step.program_loss(inp, prog)
    loss.backward()
    total = 0.
    for r in range(batch):
        sub = {k: v[r:r + 1].clone().requires_grad_(True)
               for k, v in inp['leaves'].items()}
        part = cell.step.reference_loss(inp, sub, slice(r, r + 1), batch)
        part.backward()
        total += float(part.detach())
        for k in sub:
            torch.testing.assert_close(sub[k].grad, prog[k].grad[r:r + 1],
                                       rtol=1e-4, atol=1e-7)
    assert abs(total - float(loss)) <= 1e-6 * abs(float(loss))


def test_select_faces_by_hand():
    """Two faces on a 4x4 image (centres at +-0.25, +-0.75): face 0 holds
    x + y <= 0, face 1 (nearer: larger z) holds x >= y; centres on an edge
    count as inside; two centres lie in neither."""
    img = torch.tensor([[[[-1., -1.], [1., -1.], [-1., 1.]],
                         [[-1., -1.], [1., -1.], [1., 1.]]]])
    z = torch.tensor([[[-2., -2., -2.], [-1., -1., -1.]]])
    idx = ref.select_faces(z, img, None, 4, 4)
    want = torch.tensor([[0, -1, -1, 1], [0, 0, 1, 1], [0, 1, 1, 1],
                         [1, 1, 1, 1]])
    assert torch.equal(idx[0], want)


def test_bounds_by_hand():
    """One face with the scaled box [-500, 500)^2 on a 4x4 image holds the
    centres (+-250, +-250): 4 pairs."""
    fvi = torch.tensor([[[[-0.5, -0.5], [0.5, -0.5], [0., 0.5]]]])
    face_idx = torch.full((1, 4, 4), -1)
    face_idx[0, 1, 1] = face_idx[0, 1, 2] = 0
    b = dict(face_image=fvi, valid=torch.tensor([[True]]),
             face_idx=face_idx, feat_dim=1, boxlen=0.3, knum=30)
    nbytes, ops = rasterize.work(b)
    assert ops == 4 * common.OPS_RASTER_PAIR
    assert nbytes == 4 * (1 * 1 * (13 + 3) + 16 * (4 + 1))
    # the enlarged box [-800, 800)^2 holds all 16 centres; 2 are covered
    nbytes, ops = soft_mask.work(b)
    assert ops == 14 * common.OPS_SOFT_PAIR
    assert common.bound_seconds(nbytes, ops) == max(
        nbytes / 3.35e12, ops / 67e12)


def test_readings_by_hand():
    start = {'a': torch.zeros(4), 'b': torch.zeros(2)}
    same = dict(losses=[1., 2., 3.], grad={'a': torch.ones(4),
                                          'b': torch.ones(2)},
                leaves={'a': torch.ones(4), 'b': torch.ones(2)})
    got = harness.readings(same, same, start)
    assert got == dict(loss_gap=0., grad_gap=0., change_gap=0.)
    still = dict(same, leaves=start)
    assert harness.readings(still, same, start)['change_gap'] == 1.


def test_reference_imports_nothing_of_the_package():
    code = ('import sys; import portbench.reference.render; '
            'import portbench.bounds.common; '
            'names = {m.partition(".")[0] for m in sys.modules}; '
            'bad = names & {"jax", "jaxlib", "flax", "kaolin_tpu", '
            '"kaolin_tpu_torch", "__graft_entry__"}; '
            'print(sorted(bad)); sys.exit(1 if bad else 0)')
    done = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr
