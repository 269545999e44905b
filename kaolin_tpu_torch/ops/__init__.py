from . import batch
from . import coords
from . import gcn
from . import random
from . import reduction
from . import mesh
from . import spc
from . import conversions
from . import voxelgrid
from .batch import *  # noqa: F401,F403
from .coords import *  # noqa: F401,F403
from .reduction import *  # noqa: F401,F403
