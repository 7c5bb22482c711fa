# Host-code copy of eradiate_tpu/physics/__init__.py; regenerate with tools/copy_host_code.py, do not edit.
from . import absorption, radprofile, rayleigh, thermoprops, zgrid  # noqa: F401
from .radprofile import ArrayRadProfile, AtmosphereRadProfile, RadProfile  # noqa: F401
from .zgrid import ZGrid  # noqa: F401
