from .uint8 import *  # noqa: F401,F403
from .points import *  # noqa: F401,F403
from .spc import *  # noqa: F401,F403
from .convolution import *  # noqa: F401,F403
