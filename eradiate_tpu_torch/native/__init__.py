# Host-code copy of eradiate_tpu/native/__init__.py; regenerate with tools/copy_host_code.py, do not edit.
"""Native (C++) runtime support, loaded via ctypes.

Compiles ``src/eradiate_native.cpp`` on first use (g++, cached next to the
source); every entry point has a pure-numpy fallback so the package works
without a toolchain. See the .cpp header for scope rationale.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

__all__ = [
    "available",
    "vol_read",
    "vol_write",
    "absorption_interp",
    "generate_leaf_cloud",
]

_SRC = Path(__file__).parent / "src" / "eradiate_native.cpp"
_LIB_PATH = Path(__file__).resolve().parents[2] / "build" / "native" / "_eradiate_native.so"
_lib = None
_load_failed = False


def _build() -> bool:
    try:
        _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            [
                "g++",
                "-O3",
                "-march=native",
                "-shared",
                "-fPIC",
                "-std=c++17",
                "-pthread",
                str(_SRC),
                "-o",
                str(_LIB_PATH),
            ],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except Exception as e:  # toolchain absent or compile error
        print(f"eradiate_tpu_torch.native: build failed ({e}); using numpy fallbacks", file=sys.stderr)
        return False


def _load():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if not _LIB_PATH.exists() or _LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime:
        if not _build():
            _load_failed = True
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        _load_failed = True
        return None

    lib.vol_read_header.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.vol_read_header.restype = ctypes.c_int
    lib.vol_read_data.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64]
    lib.vol_read_data.restype = ctypes.c_int
    lib.vol_write.argtypes = [
        ctypes.c_char_p,
        ctypes.c_void_p,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_void_p,
    ]
    lib.vol_write.restype = ctypes.c_int
    lib.absorption_interp.argtypes = [ctypes.c_void_p] + [ctypes.c_int64] * 3 + [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_int32,
    ]
    lib.absorption_interp.restype = None
    lib.generate_leaf_cloud.argtypes = [
        ctypes.c_int64,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_uint64,
        ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.generate_leaf_cloud.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


class _VolHeader(ctypes.Structure):
    _fields_ = [
        ("nx", ctypes.c_int32),
        ("ny", ctypes.c_int32),
        ("nz", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("bbox", ctypes.c_float * 6),
    ]


def vol_read(path):
    """Read a Mitsuba .vol grid -> (data [nz, ny, nx, channels], bbox [6]).

    Mirror of ``kernel/gridvolume.py:15-60``.
    """
    lib = _load()
    if lib is not None:
        hdr = _VolHeader()
        rc = lib.vol_read_header(str(path).encode(), ctypes.byref(hdr))
        if rc != 0:
            raise ValueError(f"invalid .vol file {path} (code {rc})")
        n = hdr.nx * hdr.ny * hdr.nz * hdr.channels
        data = np.empty(n, dtype=np.float32)
        rc = lib.vol_read_data(str(path).encode(), data.ctypes.data, n)
        if rc != 0:
            raise ValueError(f"truncated .vol file {path}")
        return (
            data.reshape(hdr.nz, hdr.ny, hdr.nx, hdr.channels),
            np.asarray(hdr.bbox, dtype=np.float32),
        )
    # numpy fallback
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:3] != b"VOL" or raw[3] != 3:
        raise ValueError(f"invalid .vol file {path}")
    dtype = np.frombuffer(raw, np.int32, 1, 4)[0]
    if dtype != 1:
        raise ValueError(".vol dtype must be float32")
    nx, ny, nz, ch = np.frombuffer(raw, np.int32, 4, 8)
    bbox = np.frombuffer(raw, np.float32, 6, 24)
    data = np.frombuffer(raw, np.float32, nx * ny * nz * ch, 48)
    return data.reshape(nz, ny, nx, ch).copy(), bbox.copy()


def vol_write(path, data, bbox=(-1, -1, -1, 1, 1, 1)):
    """Write a Mitsuba .vol grid; data [nz, ny, nx(, channels)]."""
    data = np.ascontiguousarray(np.asarray(data, dtype=np.float32))
    if data.ndim == 3:
        data = data[..., None]
    nz, ny, nx, ch = data.shape
    bbox = np.asarray(bbox, dtype=np.float32)
    lib = _load()
    if lib is not None:
        rc = lib.vol_write(
            str(path).encode(), data.ctypes.data, nx, ny, nz, ch, bbox.ctypes.data
        )
        if rc != 0:
            raise OSError(f"cannot write {path}")
        return
    with open(path, "wb") as f:
        f.write(b"VOL")
        f.write(bytes([3]))
        f.write(np.int32(1).tobytes())
        f.write(np.asarray([nx, ny, nz, ch], np.int32).tobytes())
        f.write(bbox.tobytes())
        f.write(data.tobytes())


def absorption_interp(table, iw, fw, ip, fp, it, ft, n_threads=None):
    """Threaded (w, p, T) interpolation: table [W, P, T] f32; iw/fw [S];
    ip/fp/it/ft [L] -> sigma [S, L] f32."""
    table = np.ascontiguousarray(table, dtype=np.float32)
    iw = np.ascontiguousarray(iw, dtype=np.int32)
    fw = np.ascontiguousarray(fw, dtype=np.float32)
    ip = np.ascontiguousarray(ip, dtype=np.int32)
    fp = np.ascontiguousarray(fp, dtype=np.float32)
    it = np.ascontiguousarray(it, dtype=np.int32)
    ft = np.ascontiguousarray(ft, dtype=np.float32)
    W, P, T = table.shape
    S = iw.shape[0]
    L = ip.shape[0]
    lib = _load()
    if lib is not None:
        out = np.empty((S, L), dtype=np.float32)
        if n_threads is None:
            n_threads = min(os.cpu_count() or 1, 16)
        lib.absorption_interp(
            table.ctypes.data, W, P, T,
            iw.ctypes.data, fw.ctypes.data, S,
            ip.ctypes.data, fp.ctypes.data, it.ctypes.data, ft.ctypes.data, L,
            out.ctypes.data, int(n_threads),
        )
        return out
    # numpy fallback
    lo = table[iw]  # [S, P, T]
    hi = table[np.minimum(iw + 1, W - 1)]
    def bil(t):
        c00 = t[:, ip, it]
        c01 = t[:, ip, it + 1]
        c10 = t[:, ip + 1, it]
        c11 = t[:, ip + 1, it + 1]
        return (
            c00 * (1 - fp) * (1 - ft)
            + c01 * (1 - fp) * ft
            + c10 * fp * (1 - ft)
            + c11 * fp * ft
        )
    return (bil(lo) * (1 - fw[:, None]) + bil(hi) * fw[:, None]).astype(np.float32)


def generate_leaf_cloud(n, l_horizontal_km, l_vertical_km, mu=1.066, nu=1.853, seed=1):
    """Fast leaf-cloud generation -> (positions [n,3] f32, normals [n,3] f32)."""
    lib = _load()
    if lib is not None:
        pos = np.empty((n, 3), dtype=np.float32)
        nrm = np.empty((n, 3), dtype=np.float32)
        lib.generate_leaf_cloud(
            n, float(l_horizontal_km), float(l_vertical_km), mu, nu,
            np.uint64(seed), pos.ctypes.data, nrm.ctypes.data,
        )
        return pos, nrm
    rng = np.random.default_rng(seed)
    pos = rng.uniform(
        [-l_horizontal_km / 2, -l_horizontal_km / 2, 0],
        [l_horizontal_km / 2, l_horizontal_km / 2, l_vertical_km],
        (n, 3),
    ).astype(np.float32)
    theta = rng.beta(mu, nu, n) * np.pi / 2
    phi = rng.uniform(0, 2 * np.pi, n)
    nrm = np.stack(
        [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)],
        axis=-1,
    ).astype(np.float32)
    return pos, nrm
