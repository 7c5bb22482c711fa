# Host-code copy of eradiate_tpu/data/asset_manager.py; regenerate with tools/copy_host_code.py, do not edit.
"""Offline asset manager.

The reference's ``AssetManager`` (``src/eradiate/data/_asset_manager.py:61``)
is manifest-driven with pooch downloads; this environment has no egress,
so the TPU build manages a **user data directory** with archive/directory
installs, sha256 verification, listing and removal — the same lifecycle
(`install` / `list` / `remove`) minus the network fetch. Reference-format
NetCDF payloads (absorption DB directories, SRF/solar/aerosol files)
become loadable immediately after install through the importers in
:mod:`eradiate_tpu.data.netcdf` / :mod:`eradiate_tpu.data.absorption_io`
(``open_database`` resolves ``absorption_mono/<name>`` directories
directly).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tarfile
import zipfile
from pathlib import Path

from . import data_paths, register_data_path

__all__ = [
    "user_data_dir",
    "install",
    "list_installed",
    "remove",
]

_MANIFEST = "installed_assets.json"


def user_data_dir() -> Path:
    """The writable data directory: first ``ERADIATE_TPU_DATA_PATH`` entry
    when set, else ``~/.eradiate_tpu/data`` (created + registered on the
    search path)."""
    env = os.environ.get("ERADIATE_TPU_DATA_PATH", "")
    for p in env.split(os.pathsep):
        if p:
            d = Path(p)
            d.mkdir(parents=True, exist_ok=True)
            return d
    d = Path.home() / ".eradiate_tpu" / "data"
    d.mkdir(parents=True, exist_ok=True)
    if d not in data_paths():
        register_data_path(d)
    return d


def _load_manifest(base: Path) -> dict:
    f = base / _MANIFEST
    if f.exists():
        return json.loads(f.read_text())
    return {}


def _save_manifest(base: Path, manifest: dict) -> None:
    (base / _MANIFEST).write_text(json.dumps(manifest, indent=2, sort_keys=True))


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def install(source, name: str | None = None, sha256: str | None = None) -> Path:
    """Install a dataset from a local archive (.zip/.tar[.gz|.bz2]) or
    directory into the user data dir.

    ``name``: install subdirectory (defaults to the archive stem).
    ``sha256``: optional checksum verified before unpacking (the offline
    analog of the reference manifest's pooch hashes).
    Returns the install path. Archive members are checked against path
    traversal before extraction.
    """
    src = Path(source)
    if not src.exists():
        raise FileNotFoundError(src)
    base = user_data_dir()

    if sha256 is not None and src.is_file():
        got = _sha256(src)
        if got != sha256:
            raise ValueError(
                f"checksum mismatch for {src}: expected {sha256}, got {got}"
            )

    if name is None:
        name = src.name
        for ext in (".tar.gz", ".tar.bz2", ".tgz", ".tar", ".zip"):
            if name.endswith(ext):
                name = name[: -len(ext)]
                break
    dest = base / name

    def _check_member(name):
        # prefix check with a trailing separator: plain startswith lets
        # '../<dest-name>-sibling/...' escape when the sibling shares the
        # install dir's name as a prefix
        target = (dest / name).resolve()
        root = dest.resolve()
        if target != root and not str(target).startswith(str(root) + os.sep):
            raise ValueError(f"unsafe archive member path: {name}")

    if src.is_dir():
        if dest.exists():
            shutil.rmtree(dest)
        shutil.copytree(src, dest)
    elif zipfile.is_zipfile(src):
        with zipfile.ZipFile(src) as zf:
            for m in zf.namelist():
                _check_member(m)
            zf.extractall(dest)
    elif tarfile.is_tarfile(src):
        with tarfile.open(src) as tf:
            for m in tf.getmembers():
                _check_member(m.name)
                if m.issym() or m.islnk():
                    # a link target outside the install dir would let a
                    # later member write through it
                    raise ValueError(
                        f"archive contains link member {m.name!r}; links "
                        "are not allowed in data archives"
                    )
            tf.extractall(dest)
    else:
        # single data file: copy into the root of the data dir
        dest = base / src.name
        shutil.copy2(src, dest)

    manifest = _load_manifest(base)
    manifest[name] = {
        "source": str(src),
        "path": str(dest),
        "sha256": sha256 or (_sha256(src) if src.is_file() else None),
    }
    _save_manifest(base, manifest)
    return dest


def list_installed() -> dict:
    """Manifest of installed assets in the user data dir."""
    return _load_manifest(user_data_dir())


def remove(name: str) -> bool:
    """Remove an installed asset by name; returns True when removed."""
    base = user_data_dir()
    manifest = _load_manifest(base)
    entry = manifest.pop(name, None)
    if entry is None:
        return False
    path = Path(entry["path"])
    if path.exists():
        if path.is_dir():
            shutil.rmtree(path)
        else:
            path.unlink()
    _save_manifest(base, manifest)
    return True
