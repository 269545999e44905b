"""The applications of ``kaolin_tpu_torch``: the fish photo fit, the DIB-R,
NGLOD and DMTet trainers, the Timelapse demo and the recipes.

Each entry point runs on the card by default and raises when none is
visible; pass ``device='cpu'`` (``--device cpu`` on the command line) to
run it on the CPU::

    python -m kaolin_tpu_torch.examples.fish
    python -m kaolin_tpu_torch.examples.dibr_train --steps 150
    python -m kaolin_tpu_torch.examples.nglod_train --device cpu

Importing a module of this package builds nothing and needs no card.
"""
