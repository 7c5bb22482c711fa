from ._core import EarthObservationExperiment, run  # noqa: F401
from ._atmosphere import AtmosphereExperiment  # noqa: F401
from ._canopy import CanopyAtmosphereExperiment, CanopyExperiment  # noqa: F401
from ._dem import DEMExperiment  # noqa: F401
