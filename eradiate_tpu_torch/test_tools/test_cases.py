# Host-code copy of eradiate_tpu/test_tools/test_cases.py; regenerate with tools/copy_host_code.py, do not edit.
"""Canonical scene factories shared by the tests and the smoke script.

The factories of ``eradiate_tpu/test_tools/test_cases.py`` that the port's
paths use, copied unchanged.
"""

from __future__ import annotations

import numpy as np

from ..experiments import AtmosphereExperiment, CanopyExperiment

__all__ = ["create_rpv_afgl1986_continental_brfpp", "create_het01_brfpp"]


def create_rpv_afgl1986_continental_brfpp(spp=1000, n_vza=76, absorption_data=None):
    """Adds a continental aerosol layer (mirror of
    ``test_cases/atmospheres.py:83``)."""
    molecular = {"type": "molecular"}
    if absorption_data is not None:
        molecular["absorption_data"] = absorption_data
    return AtmosphereExperiment(
        illumination={"type": "directional", "zenith": 30.0, "azimuth": 0.0},
        measures={
            "type": "mdistant",
            "construct": "hplane",
            "zeniths": np.linspace(-75, 75, n_vza),
            "azimuth": 0.0,
            "spp": spp,
            "id": "brfpp",
        },
        surface={"type": "rpv"},
        atmosphere={
            "type": "heterogeneous",
            "molecular_atmosphere": molecular,
            "particle_layers": [
                {
                    "type": "particle_layer",
                    "bottom": 0.0,
                    "top": 2.0,
                    "tau_ref": 0.2,
                    "dataset": "govaerts_2021-continental",
                }
            ],
        },
    )


def create_het01_brfpp(spp=256, n_vza=19, n_leaves=2000, seed=5):
    """ROMC HET01-like floating-spheres canopy scene (mirror of
    ``test_cases/romc.py:31``): sphere leaf clouds on a lambertian floor."""
    from ..scenes.biosphere import DiscreteCanopy, LeafCloud

    rng = np.random.default_rng(seed)
    cloud = LeafCloud.sphere(
        n_leaves=n_leaves,
        leaf_radius=0.1,
        radius=5.0,
        center=(0.0, 0.0, 10.0),
        leaf_reflectance=0.4957,
        leaf_transmittance=0.4409,
    )
    positions_m = rng.uniform(-40.0, 40.0, (15, 2))
    positions = np.concatenate(
        [positions_m, np.zeros((15, 1))], axis=1
    ) * 1e-3  # m -> km
    return CanopyExperiment(
        canopy=DiscreteCanopy(
            size=(100.0, 100.0, 15.0),
            instanced_canopy_elements=[
                {
                    "type": "instanced",
                    "canopy_element": cloud,
                    "instance_positions": positions,
                }
            ],
        ),
        illumination={"type": "directional", "zenith": 20.0, "azimuth": 0.0},
        measures={
            "type": "mdistant",
            "construct": "hplane",
            "zeniths": np.linspace(-75, 75, n_vza),
            "azimuth": 0.0,
            "spp": spp,
            "id": "brfpp",
        },
        surface={"type": "lambertian", "reflectance": 0.159},
    )
