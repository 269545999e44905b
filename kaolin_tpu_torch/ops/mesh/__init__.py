from .check_sign import *  # noqa: F401,F403
from .mesh import *  # noqa: F401,F403
from .trianglemesh import *  # noqa: F401,F403
