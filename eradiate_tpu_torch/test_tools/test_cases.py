# Host-code copy of eradiate_tpu/test_tools/test_cases.py; regenerate with tools/copy_host_code.py, do not edit.
"""Canonical scene factories for regression tests and benchmarks.

Mirror of ``src/eradiate/test_tools/test_cases/`` (``atmospheres.py:31,83``,
``romc.py:31-241``): standard experiment configurations reused across the
regression tier and the benchmark suite.
"""

from __future__ import annotations

import numpy as np

from ..experiments import AtmosphereExperiment, CanopyExperiment

__all__ = [
    "create_rpv_afgl1986_brfpp",
    "create_rpv_afgl1986_continental_brfpp",
    "create_het01_brfpp",
    "create_het04a1_brfpp",
    "create_het06_brfpp",
    "create_ocean_grasp_coastal_no_atm",
    "create_ocean_grasp_open_no_atm",
    "create_rami4atm_toa_brfpp",
    "create_spherical_rpv_brfpp",
]


def create_rpv_afgl1986_brfpp(spp=1000, n_vza=76, absorption_data=None):
    """RPV surface + AFGL 1986 US-standard atmosphere, principal-plane BRF
    (mirror of ``test_cases/atmospheres.py:31``)."""
    atmosphere = {"type": "molecular"}
    if absorption_data is not None:
        atmosphere["absorption_data"] = absorption_data
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
        atmosphere=atmosphere,
    )


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


def create_het04a1_brfpp(spp=256, n_vza=19, seed=7):
    """ROMC HET04a1-like scene (mirror of ``test_cases/romc.py:131``):
    floating spheres (rho=0.49, tau=0.41) + floating cylinders
    (rho=0.45, tau=0.3) over a lambertian floor (0.15), sun at 20 deg."""
    from ..scenes.biosphere import DiscreteCanopy, LeafCloud

    rng = np.random.default_rng(seed)
    spheres = LeafCloud.sphere(
        n_leaves=1500, leaf_radius=0.1, radius=5.0, center=(0.0, 0.0, 10.0),
        leaf_reflectance=0.49, leaf_transmittance=0.41,
    )
    cylinders = LeafCloud.cylinder(
        n_leaves=1500, leaf_radius=0.1, radius=5.0, l_vertical=10.0,
        center=(0.0, 0.0, 0.0),
        leaf_reflectance=0.45, leaf_transmittance=0.3,
    )
    sphere_pos = np.concatenate(
        [rng.uniform(-40.0, 40.0, (8, 2)), np.zeros((8, 1))], axis=1
    ) * 1e-3
    cyl_pos = np.concatenate(
        [rng.uniform(-40.0, 40.0, (7, 2)), np.zeros((7, 1))], axis=1
    ) * 1e-3
    return CanopyExperiment(
        canopy=DiscreteCanopy(
            size=(100.0, 100.0, 16.0),
            instanced_canopy_elements=[
                {
                    "type": "instanced",
                    "canopy_element": spheres,
                    "instance_positions": sphere_pos,
                },
                {
                    "type": "instanced",
                    "canopy_element": cylinders,
                    "instance_positions": cyl_pos,
                },
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
        surface={"type": "lambertian", "reflectance": 0.15},
    )


def create_het06_brfpp(spp=256, n_vza=19, n_trees=6, seed=11):
    """ROMC HET06-like coniferous stand (mirror of ``test_cases/romc.py:241``):
    cone-crown trees with cylindrical trunks (crown rho=0.08, tau=0.03;
    trunk rho=0.14) on a bright lambertian floor (0.86), sun at 40 deg."""
    from ..scenes.biosphere import AbstractTree, DiscreteCanopy, LeafCloud

    rng = np.random.default_rng(seed)
    tree = AbstractTree(
        trunk_height=1.5,
        trunk_radius=0.15,
        trunk_reflectance=0.14,
        leaf_cloud={
            "type": "leaf_cloud",
            "construct": "cone",
            "n_leaves": 648,
            "leaf_radius": 0.05,
            "radius": 1.8,
            "l_vertical": 6.0,
            "leaf_reflectance": 0.08,
            "leaf_transmittance": 0.03,
        },
    )
    positions = np.concatenate(
        [rng.uniform(-10.0, 10.0, (n_trees, 2)), np.zeros((n_trees, 1))],
        axis=1,
    ) * 1e-3
    return CanopyExperiment(
        canopy=DiscreteCanopy(
            size=(25.0, 25.0, 8.0),
            instanced_canopy_elements=[
                {
                    "type": "instanced",
                    "canopy_element": tree,
                    "instance_positions": positions,
                }
            ],
        ),
        illumination={"type": "directional", "zenith": 40.0, "azimuth": 0.0},
        measures={
            "type": "mdistant",
            "construct": "hplane",
            "zeniths": np.linspace(-75, 75, n_vza),
            "azimuth": 0.0,
            "spp": spp,
            "id": "brfpp",
        },
        surface={"type": "lambertian", "reflectance": 0.86},
    )


# 3DREAMS GRASP ocean scenarios (mirror of ``test_cases/ocean.py:7-185``)
OCEAN_GRASP_WAVELENGTHS = [412, 443, 550, 670, 865, 1020, 1600, 2200]
_OCEAN_ETA = [
    1.349303, 1.346833, 1.341266, 1.337636,
    1.336949, 1.336949, 1.336949, 1.336949,
]
_OCEAN_WB_COASTAL = [
    3.4678e-02, 4.1939e-02, 6.0228e-02, 5.7141e-02, 0.0, 0.0, 0.0, 0.0,
]
_OCEAN_WB_OPEN = [
    6.7215e-02, 6.5480e-02, 4.4756e-02, 1.7900e-02, 0.0, 0.0, 0.0, 0.0,
]


def _create_ocean_grasp(water_body_reflectance, wind_speed, spp):
    return AtmosphereExperiment(
        surface={
            "type": "ocean_grasp",
            "wind_speed": wind_speed,
            "eta": {
                "type": "interpolated",
                "wavelengths": OCEAN_GRASP_WAVELENGTHS,
                "values": _OCEAN_ETA,
            },
            "water_body_reflectance": {
                "type": "interpolated",
                "wavelengths": OCEAN_GRASP_WAVELENGTHS,
                "values": water_body_reflectance,
            },
        },
        illumination={"type": "directional", "zenith": 20.0, "azimuth": 0.0},
        measures={
            "type": "mdistant",
            "construct": "hplane",
            "zeniths": np.arange(-60, 61, 5),
            "azimuth": 0.0,
            "srf": {
                "type": "multi_delta",
                "wavelengths": OCEAN_GRASP_WAVELENGTHS,
            },
            "spp": spp,
            "id": "brfpp",
        },
        atmosphere=None,
    )


def create_ocean_grasp_coastal_no_atm(spp=64):
    """GRASP coastal ocean, no atmosphere (``test_cases/ocean.py:147``)."""
    return _create_ocean_grasp(_OCEAN_WB_COASTAL, 2.0, spp)


def create_ocean_grasp_open_no_atm(spp=64):
    """GRASP open ocean, no atmosphere (``test_cases/ocean.py:166``)."""
    return _create_ocean_grasp(_OCEAN_WB_OPEN, 10.0, spp)


def create_rami4atm_toa_brfpp(spp=256, n_vza=19):
    """RAMI4ATM hom00_lam_sc2s-like case (mirror of
    ``test_cases/rami4atm.py:12``): no canopy, lambertian surface,
    Rayleigh-scattering molecular atmosphere + continental aerosol
    (AOT 0.2), TOA BRF in the principal plane, sun at 30 deg."""
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
        surface={"type": "lambertian", "reflectance": 0.2},
        atmosphere={
            "type": "heterogeneous",
            "molecular_atmosphere": {
                "type": "molecular",
                "has_absorption": False,
            },
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


def create_spherical_rpv_brfpp(spp=100, absorption_data=None):
    """Spherical-shell RPV case (mirror of
    ``tests/03_regression/spherical/test_spherical.py:15-60``): dark RPV
    surface, US-standard molecular atmosphere on a spherical shell, sun at
    30 deg, hplane zeniths -85..64 deg."""
    from ..scenes.geometry import EARTH_RADIUS_KM

    atmosphere = {"type": "molecular"}
    if absorption_data is not None:
        atmosphere["absorption_data"] = absorption_data
    return AtmosphereExperiment(
        geometry="spherical_shell",
        surface={
            "type": "rpv",
            "rho_0": 0.017051,
            "k": 0.95,
            "g": -0.1,
            "rho_c": 0.017051,
        },
        atmosphere=atmosphere,
        illumination={"type": "directional", "zenith": 30.0, "azimuth": 0.0},
        measures={
            "type": "mdistant",
            "construct": "hplane",
            "zeniths": np.arange(-85.0, 65.0, 10.0),
            "azimuth": 0.0,
            "spp": spp,
            "target": [0.0, 0.0, EARTH_RADIUS_KM],
            "id": "brfpp",
        },
    )
