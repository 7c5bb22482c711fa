#!/usr/bin/env python3
"""Copy the JAX-free host code of ``eradiate_tpu`` into ``eradiate_tpu_torch``.

The PyTorch port imports nothing of the JAX package, so it keeps its own copy
of the host-side modules it needs (mode registry, seed streams, units, scene
elements, spectral and physics data, post-processing). The copy is
mechanical: each module in :data:`MODULES` is written to the same relative
path under ``eradiate_tpu_torch/`` with its content unchanged except for

* the places that touch JAX (:data:`PATCHES`): the mode's device dtype
  (torch), the array-namespace switch (numpy, and torch in ``core/warp``),
  the JAX compilation cache (dropped) and the DEM arrays (not ported);
* lazy imports of modules the port does not have yet (:data:`NOT_PORTED`),
  which become ``NotImplementedError`` naming the feature;
* a phrase of the docstrings (:data:`WORDING`).

The data files of :data:`DATA` are copied byte for byte into the port's
``data/store``.

Relative imports need no rewriting: they resolve inside the port. From
``test_tools/test_cases.py`` only the scene factories in :data:`TEST_CASE_FACTORIES`
are taken.

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
]

#: scene factories taken from test_tools/test_cases.py
TEST_CASE_FACTORIES = ["create_rpv_afgl1986_continental_brfpp", "create_het01_brfpp"]

#: packaged data files the port's paths read (the c3 band's spectral response
#: and the c2 aerosol), copied byte for byte
DATA = [
    "data/store/aerosol/govaerts_2021-continental.npz",
    "data/store/srf/sentinel_2a-msi-4.npz",
]
TEST_CASES_HEADER = '''"""Canonical scene factories shared by the tests and the smoke script.

The factories of ``eradiate_tpu/test_tools/test_cases.py`` that the port's
paths use, copied unchanged.
"""

from __future__ import annotations

import numpy as np

from ..experiments import AtmosphereExperiment, CanopyExperiment

__all__ = [{names}]
'''

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

#: path -> {lazy import line (stripped): feature named by the error}
NOT_PORTED = {
    "physics/absorption.py": {
        "from ..data.absorption_io import load_absorption_netcdf":
            "NetCDF absorption databases",
    },
}


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
    for line, feature in NOT_PORTED.get(rel, {}).items():
        pattern = rf"^([ \t]+){re.escape(line)}$"
        repl = rf'\1raise NotImplementedError("not ported yet: {feature}")'
        text, n = re.subn(pattern, repl, text, flags=re.MULTILINE)
        if n < 1:
            raise SystemExit(f"{rel}: lazy import not found: {line!r}")
    return _banner(rel) + text


def test_cases() -> str:
    rel = "test_tools/test_cases.py"
    source = (SRC / rel).read_text()
    tree = ast.parse(source)
    parts = [
        _banner(rel),
        TEST_CASES_HEADER.format(names=", ".join(f'"{n}"' for n in TEST_CASE_FACTORIES)),
    ]
    for name in TEST_CASE_FACTORIES:
        node = next(
            n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name
        )
        parts.append("\n\n" + ast.get_source_segment(source, node) + "\n")
    return "".join(parts)


def outputs() -> dict[str, str | bytes]:
    """Every file the script writes, by path under the port: module copies
    as text, data files as bytes."""
    out = {rel: transform(rel) for rel in MODULES}
    out["test_tools/__init__.py"] = _banner("test_tools/__init__.py") + (
        '"""Scene factories for tests and smoke runs."""\n'
    )
    out["test_tools/test_cases.py"] = test_cases()
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
