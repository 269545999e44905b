from . import checkpoint
from . import interop
from . import testing
