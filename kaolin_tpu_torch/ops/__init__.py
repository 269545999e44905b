from . import batch
from . import conversions
from . import mesh
from . import reduction
from .batch import *  # noqa: F401,F403
from .reduction import *  # noqa: F401,F403
