#!/usr/bin/env python3
"""Count the instructions of the loops of the port's CUDA kernels.

Builds (or finds) the kernel library with ``eradiate_tpu_torch.kernels._build``,
disassembles it with ``cuobjdump -sass`` and, for each kernel whose name
contains one of the given words, prints every loop (a backward branch and
the instructions from its target to it) with its length and its opcodes
counted by class: the MUFU square roots and reciprocals, float <-> double
conversions (F2F), float64 operations (D*), shared-memory loads (LDS), and
the rest. The full listing goes to ``build/sass/<kernel>.sass``.

Usage, from the repository root on a machine with ``nvcc``::

    python3 tools/sass_census.py slant_tau_kernel shell_event_kernel
"""

from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
FUNC = re.compile(r"Function : (\S+)")


def _cuobjdump():
    path = shutil.which("cuobjdump")
    if path is None:
        path = str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    return path


def kernels(sass):
    """{mangled kernel name: [(address, instruction text)]}."""
    out, name = {}, None
    for line in sass.splitlines():
        m = FUNC.search(line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = LINE.search(line)
        if m and name:
            out[name].append((int(m.group(1), 16), m.group(2).strip()))
    return out


def opcode(text):
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0] if words else ""


def census(instrs):
    c = collections.Counter()
    for _, text in instrs:
        op = opcode(text)
        base = op.split(".")[0]
        if base == "MUFU":
            c[op] += 1
        elif base in ("F2F", "LDS", "BRA", "CALL", "SHFL", "REDUX", "BSSY", "BSYNC"):
            c[base] += 1
        elif base.startswith("D"):
            c["D* (" + base + ")"] += 1
        else:
            c["other"] += 1
    return c


def loops(instrs):
    """[(start, end, instructions)] for each backward branch."""
    found = []
    for addr, text in instrs:
        if opcode(text).split(".")[0] != "BRA":
            continue
        m = re.search(r"0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) <= addr:
            start = int(m.group(1), 16)
            found.append((start, addr, [(a, t) for a, t in instrs if start <= a <= addr]))
    return found


def main(words):
    from eradiate_tpu_torch.kernels import _build

    lib = _build.library()
    sass = subprocess.run([_cuobjdump(), "-sass", lib._name], capture_output=True, text=True,
                          check=True).stdout
    outdir = Path(__file__).resolve().parents[1] / "build" / "sass"
    outdir.mkdir(parents=True, exist_ok=True)
    for name, instrs in kernels(sass).items():
        if not any(w in name for w in words):
            continue
        (outdir / f"{name}.sass").write_text("\n".join(f"{a:06x} {t}" for a, t in instrs))
        print(f"{name}: {len(instrs)} instructions; {dict(census(instrs))}", flush=True)
        for start, end, body in loops(instrs):
            print(f"  loop {start:#06x}-{end:#06x}: {len(body)} instructions; "
                  f"{dict(census(body))}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["slant_tau_kernel", "shell_event_kernel"]))
