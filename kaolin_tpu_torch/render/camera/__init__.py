from .legacy import *  # noqa: F401,F403
