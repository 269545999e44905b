"""Runs the DMTet example's first training steps at its own sizes and rate
(grid 32, 20,000 samples, the 50,000-point torus, lr 1e-3) over several
seeds, and says at which step each run lost its surface (a loss above
0.5: with no sign crossing left the samples collapse and the Chamfer
jumps from about 0.02 to about 1).

    python tests/dmtet_lr_survey.py jax   --seeds 0-7 --iterations 6
    python tests/dmtet_lr_survey.py torch --seeds 0-5 --iterations 6 \\
        [--device cpu|cuda]

``jax`` runs ``examples/dmtet_train.py`` on the CPU in float32 (x64 off);
``torch`` runs ``kaolin_tpu_torch/examples/dmtet_train.py`` on the device
given. Each run prints one line: the package, device, seed, seconds,
the step that lost the surface (or -1) and the losses.
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOST = 0.5


def _seeds(text):
    lo, _, hi = text.partition('-')
    return range(int(lo), int(hi or lo) + 1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('package', choices=('jax', 'torch'))
    ap.add_argument('--seeds', type=_seeds, default=_seeds('0-7'))
    ap.add_argument('--iterations', type=int, default=6)
    ap.add_argument('--device', default='cpu')
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.package == 'jax':
        import jax
        jax.config.update('jax_platforms', 'cpu')
        from examples import dmtet_train
        run = dmtet_train.train_dmtet
    else:
        from kaolin_tpu_torch.examples import dmtet_train

        def run(*a, **k):
            return dmtet_train.train_dmtet(*a, device=args.device, **k)
    from kaolin_tpu_torch.examples.dmtet_train import torus_points
    points = torus_points()
    device = args.device if args.package == 'torch' else 'cpu'
    for seed in args.seeds:
        t0 = time.perf_counter()
        _, hist = run(points, iterations=args.iterations, seed=seed)
        lost = next((i for i, h in enumerate(hist) if h > LOST), -1)
        print(f'{args.package} {device} seed {seed} '
              f'{time.perf_counter() - t0:.1f} s lost at step {lost}: '
              + ' '.join(f'{h:.4f}' for h in hist), flush=True)


if __name__ == '__main__':
    main()
