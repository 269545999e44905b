"""kaolin_tpu_torch: the PyTorch/CUDA port of ``kaolin_tpu``.

The same public functions as ``kaolin_tpu``, with its shapes, dtypes and
semantics, on ``torch.Tensor``s. Kernel-backed functions follow their
inputs: a CUDA tensor runs a hand-written Hopper kernel (built from
``csrc/`` with ``nvcc`` at first use), a CPU tensor runs the plain PyTorch
version beside it. Scene preprocessing (octree builds, voxelization, OBJ
parsing) runs on the host in ``native``'s library, built from
``csrc/core.cpp`` with ``g++`` at first use. Importing the package needs
no GPU, compiler, ``triton``, PIL or tornado (the dash3d viewer's
server, ``experimental.dash3d``, imports it when it starts).
"""

from . import io
from . import kernels
from . import metrics
from . import native
from . import ops
from . import parallel
from . import render
from . import rep
from . import utils
from . import visualize

__version__ = '0.1.0'
