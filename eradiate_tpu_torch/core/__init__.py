# Host-code copy of eradiate_tpu/core/__init__.py; regenerate with tools/copy_host_code.py, do not edit.
from . import frame, modes, quad, rng, units, warp  # noqa: F401
from .modes import mode, set_mode  # noqa: F401
from .units import ureg  # noqa: F401
