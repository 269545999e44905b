from .sh import *  # noqa: F401,F403
from .sg import *  # noqa: F401,F403
