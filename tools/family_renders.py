#!/usr/bin/env python3
"""Render every tracer family small on the CPU and compare two trees bit for bit.

A refactor of the renders that must not move a single-device result (the
lane hooks, the row renderers) is held by rendering the same small scenes
at one seed with two checkouts of the port and comparing every raw array's
bit pattern::

    git archive <parent> | tar -x -C build/parent
    python3 tools/family_renders.py build/parent . # prints the arrays that differ

Each tree renders in a process of its own (one CPU thread), with that tree
first on ``sys.path``: the plane-parallel and spherical atmospheres, the
small canopy and the DEM hill, in ``mono_single`` and
``mono_polarized_single``, and the plane-parallel one with the
``stratified`` sampler.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

RENDER = r'''
import sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
torch.set_num_threads(1)
import eradiate_tpu_torch as etp
from eradiate_tpu_torch.experiments import DEMExperiment
from eradiate_tpu_torch.scenes import biosphere as bio
from eradiate_tpu_torch.scenes.surface import DEMSurface

out = {}
def atm(**kw):
    base = dict(illumination={"type": "directional", "zenith": 30.0, "azimuth": 0.0},
                measures={"type": "mdistant", "construct": "hplane", "id": "m",
                          "zeniths": [-60.0, 0.0, 60.0], "azimuth": 0.0,
                          "srf": {"type": "multi_delta", "wavelengths": [500.0, 600.0]}},
                surface={"type": "lambertian", "reflectance": 0.5},
                atmosphere={"type": "molecular"})
    base.update(kw)
    return base

def raw(exp, name, spp):
    etp.run(exp, spp=spp, seed_state=etp.SeedState(5), device="cpu")
    for k, v in exp.measures[0].results["raw"].items():
        out[f"{name}/{k}"] = np.asarray(v)

for mode in ("mono_single", "mono_polarized_single"):
    etp.set_mode(mode)
    stokes = {"type": "volpath", "stokes": "polarized" in mode}
    raw(etp.AtmosphereExperiment(**atm(integrator=stokes)), f"pp_{mode}", 40)
    sph = atm(geometry="spherical_shell", surface={"type": "hapke"}, integrator=stokes)
    sph["measures"] = {**sph["measures"], "target": [0.0, 0.0, 6378.1]}
    raw(etp.AtmosphereExperiment(**sph), f"sph_{mode}", 24)
    cloud = bio.LeafCloud.sphere(n_leaves=60, leaf_radius=0.4, radius=5.0,
                                 center=(0.0, 0.0, 10.0), leaf_reflectance=0.4957,
                                 leaf_transmittance=0.4409)
    canopy = bio.DiscreteCanopy(size=(30.0, 30.0, 15.0), instanced_canopy_elements=[
        {"type": "instanced", "canopy_element": cloud,
         "instance_positions": np.zeros((1, 3))}])
    raw(etp.CanopyAtmosphereExperiment(
        canopy=canopy, illumination={"type": "directional", "zenith": 20.0},
        measures={"type": "mdistant", "construct": "hplane", "zeniths": [-30.0, 30.0],
                  "id": "m"},
        surface={"type": "lambertian", "reflectance": 0.159},
        atmosphere={"type": "molecular", "has_absorption": False}, integrator=stokes),
        f"canopy_{mode}", 16)
etp.set_mode("mono_single")
strat = atm()
strat["measures"] = {**strat["measures"], "sampler": "stratified"}
raw(etp.AtmosphereExperiment(**strat), "pp_stratified", 33)
hill = DEMSurface.gaussian_hill(height_km=1.0, sigma_km=1.0, extent_km=10.0, n=17,
                                bsdf={"type": "lambertian", "reflectance": 0.5})
raw(DEMExperiment(illumination={"type": "directional", "zenith": 60.0},
                  measures={"type": "mdistant", "construct": "hplane",
                            "zeniths": [-45.0, 0.0, 45.0], "id": "m"},
                  surface=hill, atmosphere={"type": "molecular"}), "dem", 24)
np.savez(sys.argv[2], **out)
'''


def render(tree, out):
    subprocess.run([sys.executable, "-c", RENDER, str(Path(tree).resolve()), str(out)],
                   check=True)
    return np.load(out)


def _bits(x):
    return x.view(np.uint8) if x.dtype.kind == "f" else x


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        a, b = (render(tree, Path(tmp) / f"{i}.npz") for i, tree in enumerate(argv))
        differ = [k for k in a.files if k not in b.files or a[k].shape != b[k].shape
                  or not np.array_equal(_bits(a[k]), _bits(b[k]))]
        print(f"{len(a.files)} arrays, {len(differ)} differ: {differ}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
