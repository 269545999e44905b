"""3D file I/O: OBJ, OFF, USD (usda and usdc), materials, synthetic views
and datasets. Port of ``kaolin_tpu/io``. Loaders return tensors on
``device='cuda'`` unless the caller names another device; PIL is imported
only where an image is read or written."""

from . import dataset
from . import materials
from . import modelnet
from . import obj
from . import off
from . import render
from . import shapenet
from . import shrec
from . import usd
from . import utils
