from .spc import Spc  # noqa: F401
