"""Short, self-contained recipes, one API each, mirroring the reference's
``examples/recipes/`` catalogue (camera, dataload, preprocess, spc). Each
runs on the card by default, or on the CPU with ``--device cpu``::

    python -m kaolin_tpu_torch.examples.recipes.spc.spc_basics
    python -m kaolin_tpu_torch.examples.recipes.camera.camera_init_simple --device cpu

Cameras, as in ``kaolin_tpu``, are immutable: methods like ``rotate``,
``zoom`` and ``move_forward`` return a new camera. Importing a recipe runs
nothing; its ``main(argv)`` does.
"""
