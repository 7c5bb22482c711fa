# Host-code copy of eradiate_tpu/spectral/__init__.py; regenerate with tools/copy_host_code.py, do not edit.
from . import ckd_quad, grid, index, response  # noqa: F401
from .ckd_quad import CKDQuadConfig, CKDQuadPolicy  # noqa: F401
from .grid import CKDSpectralGrid, MonoSpectralGrid, SpectralGrid  # noqa: F401
from .index import CKDSpectralIndex, MonoSpectralIndex, SpectralIndex  # noqa: F401
from .response import BandSRF, DeltaSRF, UniformSRF, srf_converter  # noqa: F401
