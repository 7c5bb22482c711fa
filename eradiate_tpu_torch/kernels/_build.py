"""Build ``csrc/*.cu`` into one shared library and load it with ctypes.

The library exposes plain C launchers (no PyTorch headers), so a build takes
seconds: one ``nvcc -c`` per source, all started together, then one link. It
is written to ``build/kernels/`` at the repository root under a name keyed
by the hash of the flags, the sources and the headers they include
(``csrc/*.cuh``, found beside the source), and built at most once per
process. A missing ``nvcc`` or a failed build raises.

``-fmad=false`` keeps nvcc from contracting a product and a sum into one
fused multiply-add: every float operation then rounds as the plain twins'
separate PyTorch operations do, so the kernels can be held against them bit
for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["library", "source_tag", "BUILD_DIR", "CSRC_DIR"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.is_file():
            path = str(cand)
    if path is None:
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME/bin): the "
            "CUDA kernels of eradiate_tpu_torch are built from csrc/ at first use"
        )
    return path


def source_tag(csrc: Path = CSRC_DIR) -> str:
    """The library's tag: a hash of the compiler flags and of every source
    and header under ``csrc`` (``*.cu``, ``*.cuh``), names and contents, so
    that a changed header gives a new library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/*.cu`` on first call.

    The compiler's report (``-Xptxas -v``: registers, shared memory, spills
    per kernel) is kept beside the library as ``<name>.log``.
    """
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    out = BUILD_DIR / f"liberadiate_kernels_{source_tag()}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{out.stem}.{os.getpid()}"
        nvcc = _nvcc()
        objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
        procs = [
            (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True))
            for cmd in (
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources, objs)
            )
        ]
        logs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in procs]
        tmp = out.with_name(f"{tag}.tmp")
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]
        if all(rc == 0 for _, _, rc in logs):
            proc = subprocess.run(link, capture_output=True, text=True)
            logs.append((link, proc.stdout + proc.stderr, proc.returncode))
        for obj in objs:
            obj.unlink(missing_ok=True)
        for cmd, log, rc in logs:
            if rc != 0:
                raise RuntimeError(
                    f"nvcc failed with exit code {rc}:\n{' '.join(cmd)}\n{log}"
                )
        out.with_suffix(".log").write_text("".join(log for _, log, _ in logs))
        os.replace(tmp, out)
    _lib = ctypes.CDLL(str(out))
    return _lib
