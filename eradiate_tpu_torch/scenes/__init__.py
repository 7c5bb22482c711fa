# Host-code copy of eradiate_tpu/scenes/__init__.py; regenerate with tools/copy_host_code.py, do not edit.
from . import (  # noqa: F401
    atmosphere,
    bsdfs,
    geometry,
    illumination,
    integrators,
    measure,
    phase,
    spectra,
    surface,
)
from .core import Factory, SceneElement  # noqa: F401
