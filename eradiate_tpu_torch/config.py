# Host-code copy of eradiate_tpu/config.py; regenerate with tools/copy_host_code.py, do not edit.
"""Settings system.

Mirror of ``src/eradiate/config/_settings.py:146-198`` (Dynaconf-based in
the reference; dependency-free here): values resolve, in priority order,
from (1) ``ERADIATE_TPU_*`` environment variables, (2) an
``eradiate.toml`` file in the working directory or ``$HOME``, (3) defaults.

Supported keys (mirroring the reference's):
- ``DATA_PATH``: extra data-store search paths (os.pathsep-separated)
- ``OFFLINE``: bool (informational; this build has no downloader)
- ``PROGRESS``: ``NONE`` | ``SPECTRAL_LOOP`` | ``KERNEL``
- ``RNG_SEED``: int root seed for :data:`eradiate_tpu.root_seed_state`
- ``AZIMUTH_CONVENTION``: default azimuth convention name
- ``ABSORPTION_DATABASE_ERROR_HANDLING``: 'raise' | 'clamp' | 'zero'
"""

from __future__ import annotations

import enum
import logging
import os
from pathlib import Path

__all__ = ["settings", "ProgressLevel"]


class ProgressLevel(enum.IntEnum):
    """Mirror of ``config/_settings.py:14-61``."""

    NONE = 0
    SPECTRAL_LOOP = 1
    KERNEL = 2


_DEFAULTS = {
    "DATA_PATH": "",
    "OFFLINE": True,
    "PROGRESS": "SPECTRAL_LOOP",
    "RNG_SEED": 0,
    "AZIMUTH_CONVENTION": "EAST_RIGHT",
    "ABSORPTION_DATABASE_ERROR_HANDLING": "clamp",
}

_ENV_PREFIX = "ERADIATE_TPU_"


def _load_file_settings() -> dict:
    import tomllib

    for base in (Path.cwd(), Path.home()):
        path = base / "eradiate.toml"
        if path.exists():
            try:
                with open(path, "rb") as f:
                    data = tomllib.load(f)
                return {k.upper(): v for k, v in data.items()}
            except Exception:
                return {}
    return {}


class Settings:
    def __init__(self):
        self._file = None

    def _file_settings(self):
        if self._file is None:
            self._file = _load_file_settings()
        return self._file

    def get(self, key: str, default=None):
        key = key.upper().replace(".", "_")
        env = os.environ.get(_ENV_PREFIX + key)
        if env is not None:
            return self._coerce(key, env)
        if key in self._file_settings():
            return self._file_settings()[key]
        if key in _DEFAULTS:
            return _DEFAULTS[key]
        return default

    def _coerce(self, key, value):
        ref = _DEFAULTS.get(key)
        if isinstance(ref, bool):
            return value.lower() in ("1", "true", "yes", "on")
        if isinstance(ref, int):
            return int(value)
        return value

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.get(name)

    @property
    def progress(self) -> ProgressLevel:
        return ProgressLevel[str(self.get("PROGRESS", "SPECTRAL_LOOP")).upper()]

    def reload(self):
        self._file = None


#: Global settings object (mirror of ``eradiate.config.settings``)
settings = Settings()


def apply_settings():
    """Apply settings to the runtime (seed, data path)."""
    from .core.rng import root_seed_state
    from .data import register_data_path

    seed = settings.get("RNG_SEED")
    if seed:
        root_seed_state.reset(int(seed))
    for p in str(settings.get("DATA_PATH", "")).split(os.pathsep):
        if p:
            register_data_path(p)

