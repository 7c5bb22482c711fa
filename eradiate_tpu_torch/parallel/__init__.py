"""Sharded rendering over ``torch.distributed`` ranks (port of
``eradiate_tpu/parallel``).

``render.py`` holds a sharded twin of every tracer family over a
("spectral", "sample") :class:`~torch.distributed.device_mesh.DeviceMesh`,
with global sample-id slicing making sharded estimates equal single-device
ones up to float summation order; ``multihost.py`` starts the process group;
``dryrun.py`` renders every family sharded and unsharded in spawned ranks.
"""

from .multihost import initialize  # noqa: F401
from .render import (  # noqa: F401
    make_render_mesh,
    render_canopy_polarized_sharded,
    render_canopy_sharded,
    render_dem_sharded,
    render_polarized_sharded,
    render_sharded,
    render_spherical_polarized_sharded,
    render_spherical_sharded,
)
