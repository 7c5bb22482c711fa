#!/usr/bin/env python3
"""Run a command and keep the time of every line it prints.

The command's standard output and error pass through unchanged; each line
is also written to ``TIMELINE`` with the seconds since the start in front,
so the time a phase of ``chip_smoke.py`` takes is the difference between
the stamps of its first line and of the next phase's. The exit code is the
command's.

Usage, from the repository root on a machine with a card::

    python3 tools/chip_smoke_timeline.py build/timeline.txt -- python3 chip_smoke.py
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3 or argv[1] != "--":
        print(__doc__, file=sys.stderr)
        return 2
    out, command = Path(argv[0]), argv[2:]
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with out.open("w") as log, subprocess.Popen(
        command, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, bufsize=1
    ) as proc:
        for line in proc.stdout:
            sys.stdout.write(line)
            sys.stdout.flush()
            log.write(f"{time.perf_counter() - t0:9.1f} {line[:160].rstrip()}\n")
            log.flush()
        rc = proc.wait()
        log.write(f"{time.perf_counter() - t0:9.1f} exit {rc}\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
