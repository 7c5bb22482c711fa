# Host-code copy of eradiate_tpu/data/__init__.py; regenerate with tools/copy_host_code.py, do not edit.
"""Data store and file resolution.

Much-simplified equivalent of the reference's asset manager + file resolver
(``src/eradiate/data/_asset_manager.py``, ``_file_resolver.py``): a search
path of data directories (``ERADIATE_TPU_DATA_PATH`` env var, the packaged
``store/`` directory, and any registered paths). This environment has no
network egress, so there is no downloader; datasets are user-installed
files in native ``.npz`` formats.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

__all__ = ["resolve_data", "register_data_path", "load_srf", "data_paths"]

_PACKAGED = Path(__file__).parent / "store"
_EXTRA_PATHS: list[Path] = []


def data_paths() -> list[Path]:
    paths = []
    env = os.environ.get("ERADIATE_TPU_DATA_PATH", "")
    for p in env.split(os.pathsep):
        if p:
            paths.append(Path(p))
    paths.extend(_EXTRA_PATHS)
    paths.append(_PACKAGED)
    return paths


def register_data_path(path) -> None:
    _EXTRA_PATHS.insert(0, Path(path))


def resolve_data(relpath: str) -> str | None:
    """Return the first existing file matching ``relpath`` on the search
    path, or None."""
    for base in data_paths():
        cand = base / relpath
        if cand.exists():
            return str(cand)
    return None


def load_srf(identifier: str):
    """Load a band SRF by dataset id (e.g. ``sentinel_2a-msi-4``).

    Looks for ``srf/<id>.npz`` with arrays ``w`` [nm] and ``srf``; mirror of
    ``BandSRF.from_id`` (``spectral/response.py``). Falls back to packaged
    synthetic SRFs where shipped.
    """
    from ..spectral.response import BandSRF

    path = resolve_data(f"srf/{identifier}.npz")
    if path is None:
        raise FileNotFoundError(
            f"SRF dataset '{identifier}' not found on the data path; "
            f"install it under srf/{identifier}.npz or pass a BandSRF directly"
        )
    d = np.load(path)
    return BandSRF(d["w"], d["srf"], id=identifier)
