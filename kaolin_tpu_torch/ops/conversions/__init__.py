from .sdf import *  # noqa: F401,F403
