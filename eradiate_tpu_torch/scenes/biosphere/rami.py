# Host-code copy of eradiate_tpu/scenes/biosphere/rami.py; regenerate with tools/copy_host_code.py, do not edit.
"""RAMI-V scenario catalog and loader.

Mirror of ``src/eradiate/scenes/biosphere/_rami_scenarios.py`` (scenario
enums, name generation) and ``_canopy_loader.py`` (scenario.json parsing).
Scenario IDs follow the public RAMI-V benchmark nomenclature.

Differences from the reference: scenario archives are **not** downloaded
(this build has no network access policy baked in) — the loader reads an
already-unpacked scenario folder, and raises a clear error pointing at the
expected location otherwise.
"""

from __future__ import annotations

import itertools
import json
import os
from enum import Enum

import numpy as np

__all__ = [
    "RAMIActualCanopies",
    "RAMIHeterogeneousAbstractCanopies",
    "RAMIHomogeneousAbstractCanopies",
    "RAMIScenarioVariant",
    "generate_name",
    "load_rami_scenario",
    "load_scenario",
]


class RAMIActualCanopies(Enum):
    """RAMI-V actual canopies."""

    JARVSELJA_PINE_STAND = "HET07_JPS_SUM"
    OFENPASS_PINE_STAND = "HET08_OPS_WIN"
    JARVSELJA_BIRCH_STAND_SUMMER = "HET09_JBS_SUM"
    WELLINGTON_CITRUS_ORCHARD = "HET14_WCO_UND"
    JARVSELJA_BIRCH_STAND_WINTER = "HET15_JBS_WIN"
    AGRICULTURAL_CROPS = "HET16_SRF_UND"
    SAVANNA_PRE_FIRE = "HET50_SAV_PRE"
    WYTHAM_WOOD = "HET51_WWO_TLS"


class RAMIHeterogeneousAbstractCanopies(Enum):
    """RAMI-V heterogeneous abstract canopies."""

    ANISOTROPIC_BACKGROUND_OVERSTOREY_SPARSE_BRF_MODEL_A = "HET10_DIS_S1A"
    ANISOTROPIC_BACKGROUND_OVERSTOREY_SPARSE_BRF_MODEL_B = "HET11_DIS_S1B"
    ANISOTROPIC_BACKGROUND_OVERSTOREY_SPARSE_BRF_MODEL_C = "HET12_DIS_S1C"
    ANISOTROPIC_BACKGROUND_OVERSTOREY_DENSE_BRF_MODEL_A = "HET20_DIS_D1A"
    ANISOTROPIC_BACKGROUND_OVERSTOREY_DENSE_BRF_MODEL_B = "HET21_DIS_D1B"
    ANISOTROPIC_BACKGROUND_OVERSTOREY_DENSE_BRF_MODEL_C = "HET22_DIS_D1C"
    TWO_LAYER_CANOPY_OVERSTORIES_SPARSE_UNDERSTORIES_SPARSE = "HET16_DIS_S2S"
    TWO_LAYER_CANOPY_OVERSTORIES_MEDIUM_UNDERSTORIES_SPARSE = "HET17_DIS_M2S"
    TWO_LAYER_CANOPY_OVERSTORIES_DENSE_UNDERSTORIES_SPARSE = "HET18_DIS_D2S"
    TWO_LAYER_CANOPY_OVERSTORIES_SPARSE_UNDERSTORIES_DENSE = "HET26_DIS_S2D"
    TWO_LAYER_CANOPY_OVERSTORIES_MEDIUM_UNDERSTORIES_DENSE = "HET27_DIS_M2D"
    TWO_LAYER_CANOPY_OVERSTORIES_DENSE_UNDERSTORIES_DENSE = "HET28_DIS_D2D"
    CONSTANT_SLOPE_DISTRIBUTION_SPARSE_INCLINATION_15 = "HET23_DIS_S15"
    CONSTANT_SLOPE_DISTRIBUTION_DENSE_INCLINATION_15 = "HET24_DIS_D15"
    CONSTANT_SLOPE_DISTRIBUTION_SPARSE_INCLINATION_30 = "HET33_DIS_S30"
    CONSTANT_SLOPE_DISTRIBUTION_DENSE_INCLINATION_30 = "HET34_DIS_D30"


class RAMIHomogeneousAbstractCanopies(Enum):
    """RAMI-V homogeneous abstract canopies."""

    ANISOTROPIC_BACKGROUND_PLANOPHILE_A = "HOM23_DIS_P1A"
    ANISOTROPIC_BACKGROUND_PLANOPHILE_B = "HOM24_DIS_P1B"
    ANISOTROPIC_BACKGROUND_PLANOPHILE_C = "HOM25_DIS_P1C"
    ANISOTROPIC_BACKGROUND_ERECTOPHILE_B = "HOM34_DIS_E1B"
    ANISOTROPIC_BACKGROUND_ERECTOPHILE_C = "HOM35_DIS_E1C"
    TWO_LAYER_CANOPY_ERECTOPHILE_SPARSE_PLANOPHILE_DENSE = "HOM26_DIS_EPD"
    TWO_LAYER_CANOPY_ERECTOPHILE_SPARSE_PLANOPHILE_MEDIUM = "HOM27_DIS_EPM"
    TWO_LAYER_CANOPY_ERECTOPHILE_SPARSE_PLANOPHILE_SPARSE = "HOM28_DIS_EPS"
    TWO_LAYER_CANOPY_PLANOPHILE_SPARSE_ERECTOPHILE_DENSE = "HOM36_DIS_PED"
    TWO_LAYER_CANOPY_PLANOPHILE_SPARSE_ERECTOPHILE_MEDIUM = "HOM37_DIS_PEM"
    TWO_LAYER_CANOPY_PLANOPHILE_SPARSE_ERECTOPHILE_SPARSE = "HOM38_DIS_PES"
    ADJACENT_CANOPIES_SPARSE_ERECTOPHILE_DENSE_PLANOPHILE = "HOM29_DIS_EM0"
    ADJACENT_CANOPIES_MEDIUM_ERECTOPHILE_SPARSE_PLANOPHILE = "HOM30_DIS_ED0"


class RAMIScenarioVariant(Enum):
    ORIGINAL = "original"
    SIMPLIFIED = "simplified"


_ALL_ENUMS = (
    RAMIActualCanopies,
    RAMIHeterogeneousAbstractCanopies,
    RAMIHomogeneousAbstractCanopies,
)


def _convert_to_enum(scenario_name):
    if isinstance(scenario_name, str):
        for member in itertools.chain.from_iterable(_ALL_ENUMS):
            if scenario_name == member.value:
                return member
        raise ValueError(f"Scenario {scenario_name} not found")
    return scenario_name


def generate_name(scenario_name, variant=RAMIScenarioVariant.ORIGINAL) -> str:
    """Scenario folder name: ``<ID>`` or ``<ID>-simplified``."""
    scenario_name = _convert_to_enum(scenario_name)
    return (
        f"{scenario_name.value}-{variant.value}"
        if variant == RAMIScenarioVariant.SIMPLIFIED
        else scenario_name.value
    )


def _apply_transformation(transf, center):
    """Instance position from a 4x4 transform: transformed origin shifted
    by the scenario center (reference ``_canopy_loader.py:133-152``)."""
    transf = np.asarray(transf, dtype=np.float64)
    origin = np.array([0.0, 0.0, 0.0, 1.0])
    return (transf @ origin)[:3] - center


def _update_material(elem, canopy_name, spectral_data):
    """Override material entries from user-supplied spectral data
    (reference ``_canopy_loader.py:12-55`` semantics)."""
    if spectral_data is None or canopy_name not in spectral_data:
        return elem
    if canopy_name != "ground" and elem.get("id") not in spectral_data[canopy_name]:
        return elem
    out = {k: v for k, v in elem.items() if k not in ("reflectance", "transmittance")}
    override = (
        spectral_data["ground"]
        if canopy_name == "ground"
        else spectral_data[canopy_name][elem["id"]]
    )
    return {**out, **override}


def load_scenario(scenario_folder, padding: int = 0, spectral_data=None) -> dict:
    """Parse a RAMI ``scenario.json`` folder into experiment kwargs:
    {"surface": <bsdf dict>, "canopy": <DiscreteCanopy-compatible dict>,
    "padding": int}.

    Mesh filenames are resolved relative to the scenario folder; instance
    positions come from 4x4 transforms re-centered on the canopy cell
    (reference ``load_scenario``, ``_canopy_loader.py:155-242``).
    """
    path = os.path.join(str(scenario_folder), "scenario.json")
    with open(path) as fh:
        scenario = json.load(fh)

    surface = dict(scenario["surface"])
    surface = _update_material(surface, "ground", spectral_data)

    size = scenario["canopy"]["size"]
    center = np.array([size[0], size[1], 0.0]) / 2.0

    elements = []
    for elem in scenario["canopy"]["instanced_canopy_elements"]:
        ce = dict(elem["canopy_element"])
        trees = []
        for tree in ce.get("mesh_tree_elements", []):
            tree = dict(tree)
            tree["mesh_filename"] = os.path.join(
                str(scenario_folder), str(tree["mesh_filename"])
            )
            trees.append(_update_material(tree, ce.get("id", ""), spectral_data))
        ce["mesh_tree_elements"] = trees
        ce.setdefault("type", "mesh_tree")
        ce.pop("id", None)
        elements.append(
            {
                "type": "instanced",
                "canopy_element": ce,
                "instance_positions": [
                    _apply_transformation(t, center)
                    for t in elem["instance_positions"]
                ],
            }
        )

    canopy = {
        "type": "discrete_canopy",
        # scenario sizes are meters; DiscreteCanopy converts m -> km
        "size": tuple(size),
        "instanced_canopy_elements": elements,
    }
    return {"surface": surface, "canopy": canopy, "padding": padding}


def load_rami_scenario(
    scenario_name,
    variant=RAMIScenarioVariant.ORIGINAL,
    padding: int = 0,
    unpack_folder=None,
    spectral_data=None,
) -> dict:
    """Load a RAMI-V scenario by name from an unpacked scenario folder.

    The reference downloads missing archives from the Eradiate data store
    (``_rami_scenarios.py:140-195``); this build requires the data to be
    present locally (``<unpack_folder>/<name>/scenario.json``).
    """
    unpack_folder = os.getcwd() if unpack_folder is None else str(unpack_folder)
    name = generate_name(_convert_to_enum(scenario_name), variant)
    scenario_folder = os.path.join(unpack_folder, name)
    if not os.path.exists(os.path.join(scenario_folder, "scenario.json")):
        raise FileNotFoundError(
            f"RAMI scenario data not found at {scenario_folder!r}. Download "
            f"and unpack the '{name}' archive from the Eradiate data store "
            f"(scenarios/rami5/{name}.zip) into {unpack_folder!r} first — "
            "this build performs no network access."
        )
    return load_scenario(scenario_folder, padding, spectral_data=spectral_data)
