#!/usr/bin/env python3
"""Copy the JAX-free host code of ``eradiate_tpu`` into ``eradiate_tpu_torch``.

The PyTorch port imports nothing of the JAX package, so it keeps its own copy
of the host-side modules it needs (mode registry, seed streams, units, scene
elements, spectral and physics data, post-processing). The copy is
mechanical: each module in :data:`MODULES` is written to the same relative
path under ``eradiate_tpu_torch/`` with its content unchanged except for

* the places that touch JAX or name the JAX package (:data:`PATCHES`): the
  mode's device dtype (torch), the array-namespace switch (numpy, and torch
  in ``core/warp``), the JAX compilation cache (dropped), the DEM arrays
  (the port's), the native helper's library path (under ``build/``) and
  the aerosol generator's absolute import;
* a phrase of the docstrings (:data:`WORDING`).

The files of :data:`DATA` (the packaged data store and the native helper's
C++ source) are copied byte for byte.

Relative imports need no rewriting: they resolve inside the port.

Usage, from the repository root::

    python tools/copy_host_code.py           # (re)write the copies
    python tools/copy_host_code.py --check   # exit 1 if a copy is stale

After writing, every relative import of every copy is resolved against the
port's tree, and the script fails if one points at a module that is absent.
"""

from __future__ import annotations

import argparse
import ast
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "eradiate_tpu"
DST = ROOT / "eradiate_tpu_torch"

MODULES = [
    "checkpoint.py",
    "config.py",
    "xr.py",
    "core/__init__.py",
    "core/frame.py",
    "core/modes.py",
    "core/quad.py",
    "core/rng.py",
    "core/units.py",
    "core/warp.py",
    "data/__init__.py",
    "data/absorption_io.py",
    "data/asset_manager.py",
    "data/io.py",
    "data/netcdf.py",
    "data/validation.py",
    "data/store/aerosol/make_continental.py",
    "data/store/srf/make_srf.py",
    "native/__init__.py",
    "physics/__init__.py",
    "physics/absorption.py",
    "physics/afgl1986_data.py",
    "physics/mie.py",
    "physics/ocean_data.py",
    "physics/radprofile.py",
    "physics/rayleigh.py",
    "physics/shell_merge.py",
    "physics/solar_data.py",
    "physics/thermoprops.py",
    "physics/vector_doubling.py",
    "physics/vector_sos.py",
    "physics/zgrid.py",
    "pipelines/__init__.py",
    "pipelines/logic.py",
    "scenes/__init__.py",
    "scenes/core.py",
    "scenes/geometry.py",
    "scenes/atmosphere/__init__.py",
    "scenes/atmosphere/aerosols.py",
    "scenes/atmosphere/particle_dist.py",
    "scenes/biosphere/__init__.py",
    "scenes/biosphere/rami.py",
    "scenes/bsdfs/__init__.py",
    "scenes/illumination/__init__.py",
    "scenes/integrators/__init__.py",
    "scenes/measure/__init__.py",
    "scenes/phase/__init__.py",
    "scenes/shapes/__init__.py",
    "scenes/spectra/__init__.py",
    "scenes/surface/__init__.py",
    "spectral/__init__.py",
    "spectral/ckd_quad.py",
    "spectral/grid.py",
    "spectral/index.py",
    "spectral/response.py",
    "srf_tools.py",
    "test_tools/__init__.py",
    "test_tools/regression.py",
    "test_tools/test_cases.py",
    "xarray_utils.py",
    "plot.py",
]

#: non-Python files copied byte for byte: the packaged data store and the
#: native helper's source
DATA = [
    "native/src/eradiate_native.cpp",
    "data/store/aerosol/govaerts_2021-continental.npz",
    "data/store/aerosol/govaerts_2021-desert.npz",
    "data/store/srf/README.md",
    *[f"data/store/srf/sentinel_2a-msi-{band}.npz"
      for band in ("1", "2", "3", "4", "5", "6", "7", "8", "8a", "9", "10", "11", "12")],
]

_MODES_DTYPES = '''    @property
    def device_dtype(self):
        """Path-state dtype for device code, as a torch dtype: float64 in a
        double mode (on every device, without an x64 switch), float32 in a
        single one. Random uniforms stay float32 in every mode."""
        import torch

        return torch.float64 if self.is_double_precision else torch.float32

    @property
    def host_dtype(self):
        """The numpy dtype of :attr:`device_dtype`, for host-side leaves."""
        return np.float64 if self.is_double_precision else np.float32

    @property
    def accumulator_dtype(self):
        """Dtype for radiance / second-moment accumulators."""
        return self.device_dtype

'''

_WARP_NAMESPACE = '''import torch


class _TorchNamespace:
    """The numpy spellings this module uses, on torch tensors."""

    sqrt = staticmethod(torch.sqrt)
    abs = staticmethod(torch.abs)
    where = staticmethod(torch.where)
    clip = staticmethod(torch.clip)
    arctan2 = staticmethod(torch.arctan2)

    @staticmethod
    def stack(arrays, axis=0):
        return torch.stack(arrays, dim=axis)


def _np(x):
    """Return the array namespace for x: torch for tensors (the tracers),
    numpy otherwise (the host code)."""
    return _TorchNamespace if isinstance(x, torch.Tensor) else np
'''

#: path -> [(pattern, replacement)]; each pattern must match exactly once
PATCHES = {
    "core/modes.py": [
        (
            r"    @property\n    def device_dtype\(self\):.*?(?=    def check\()",
            _MODES_DTYPES,
        ),
        (r"call eradiate_tpu\.set_mode\(\)", "call eradiate_tpu_torch.set_mode()"),
    ],
    "core/frame.py": [
        (
            r'    """Return the array namespace for x \(numpy or jax\.numpy\)\."""\n'
            r'    if type\(x\)\.__module__\.startswith\("jax"\):\n'
            r"        import jax\.numpy as jnp\n\n        return jnp\n",
            '    """Return the array namespace for x (numpy: host code only)."""\n',
        ),
    ],
    "core/warp.py": [
        (r"written for JAX tracing \(works on\nnumpy arrays too\)",
         "written once for torch tensors\n(the tracers) and numpy arrays (the host code)"),
        (r"from \.frame import _np\n", _WARP_NAMESPACE),
    ],
    "config.py": [
        (r"Apply settings to the runtime \(seed, data path, compile cache\)",
         "Apply settings to the runtime (seed, data path)"),
        (r"    _enable_compilation_cache\(\)\n", ""),
        (r"\n\ndef _host_fingerprint\(\).*\Z", "\n"),
    ],
    "native/__init__.py": [
        (r'_LIB_PATH = Path\(__file__\)\.parent / "_eradiate_native\.so"',
         '_LIB_PATH = Path(__file__).resolve().parents[2] / "build" / "native" / '
         '"_eradiate_native.so"'),
        (r"def _build\(\) -> bool:\n    try:\n",
         "def _build() -> bool:\n    try:\n        _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)\n"),
        (r"eradiate_tpu\.native: build failed", "eradiate_tpu_torch.native: build failed"),
    ],
    "data/store/aerosol/make_continental.py": [
        (r"from eradiate_tpu\.physics\.mie import", "from eradiate_tpu_torch.physics.mie import"),
    ],
    "scenes/surface/__init__.py": [
        (
            r"        import jax\.numpy as jnp\n\n"
            r"        from \.\.\.ops\.dem import DemArrays\n\n"
            r"        return DemArrays\(.*?\n        \)\n",
            "        from ...ops.scene_state import dem_from_reference\n\n"
            "        return dem_from_reference(\n"
            "            self.elevation, self.x0, self.y0, self.dx, self.dy, \"cpu\", dtype\n"
            "        )\n",
        ),
    ],
}

#: Wording changed in every copy: the port has one spectral loop, on the
#: host, and no layer of that other name.
WORDING = {r"spectral d[r]iver": "spectral loop"}  # a regular expression


def _banner(rel):
    return (
        f"# Host-code copy of eradiate_tpu/{rel}; regenerate with "
        "tools/copy_host_code.py, do not edit.\n"
    )


def transform(rel: str) -> str:
    text = (SRC / rel).read_text()
    for pattern, repl in PATCHES.get(rel, []):
        text, n = re.subn(pattern, lambda _m, r=repl: r, text, flags=re.DOTALL)
        if n != 1:
            raise SystemExit(f"{rel}: pattern matched {n} times, expected 1: {pattern!r}")
    for old, new in WORDING.items():
        text = re.sub(old, new, text)
    return _banner(rel) + text


def outputs() -> dict[str, str | bytes]:
    """Every file the script writes, by path under the port: module copies
    as text, data files as bytes."""
    out = {rel: transform(rel) for rel in MODULES}
    out.update({rel: (SRC / rel).read_bytes() for rel in DATA})
    return out


def check_imports(files) -> list[str]:
    """Relative imports of the copies that do not resolve inside the port,
    and any import of jax."""
    bad = []
    for rel in files:
        path = DST / rel
        if not path.is_file():  # reported as stale
            continue
        pkg = path.parent.relative_to(DST).parts
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            if any(n.split(".")[0] in ("jax", "eradiate_tpu") for n in names):
                bad.append(f"{rel}:{node.lineno}: imports {names}")
            if isinstance(node, ast.ImportFrom) and node.level > 0:
                base = pkg[: len(pkg) - (node.level - 1)]
                target = DST.joinpath(*base, *(node.module or "").split("."))
                if not (target.with_suffix(".py").is_file() or (target / "__init__.py").is_file()):
                    bad.append(f"{rel}:{node.lineno}: {'.' * node.level}{node.module} is absent")
    return bad


def _bytes(data):
    return data.encode() if isinstance(data, str) else data


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--check", action="store_true",
                        help="compare the copies on disk with a fresh copy; write nothing")
    args = parser.parse_args(argv)
    out = outputs()
    if args.check:
        stale = [rel for rel, data in out.items()
                 if not (DST / rel).is_file() or (DST / rel).read_bytes() != _bytes(data)]
        for rel in stale:
            print(f"stale: eradiate_tpu_torch/{rel}")
    else:
        stale = []
        for rel, data in out.items():
            (DST / rel).parent.mkdir(parents=True, exist_ok=True)
            (DST / rel).write_bytes(_bytes(data))
        print(f"wrote {len(out)} files under {DST.relative_to(ROOT)}/")
    bad = check_imports([rel for rel in out if rel.endswith(".py")])
    for line in bad:
        print(f"unresolved: {line}")
    return 1 if stale or bad else 0


if __name__ == "__main__":
    sys.exit(main())
