from . import interop
