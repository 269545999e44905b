from .rasterization import *  # noqa: F401,F403
from .dibr import *  # noqa: F401,F403
from .utils import *  # noqa: F401,F403
from .deftet import *  # noqa: F401,F403
