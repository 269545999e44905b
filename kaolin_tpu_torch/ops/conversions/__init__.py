from .sdf import *  # noqa: F401,F403
from .tetmesh import *  # noqa: F401,F403
