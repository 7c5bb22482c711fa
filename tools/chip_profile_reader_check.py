#!/usr/bin/env python3
"""Hold ``chip_smoke.window_records`` against ``torch.profiler``'s own parse.

Profiles a window of 16 event iterations of polarized c4 (SZA 75, 15 view
zeniths, 4096 spp, ``chip_smoke._c4``) on the card as ``chip_smoke.py``'s
full-width phases do, then reads the window twice: from the profiler's raw
records (``window_records``) and through ``prof.events()`` and
``prof.key_averages()``. Prints the time each read takes and fails unless
both give the same CUDA records (names and durations), the same device
time an operator launched itself, and so the same ``window_device``,
``top_ops`` and K2 records.

Usage, from the repository root on a machine with a card::

    python3 tools/chip_profile_reader_check.py
"""

from __future__ import annotations

import math
import re
import sys
import time
from pathlib import Path


def main():
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import torch
    from torch.autograd import DeviceType

    import chip_smoke as cs
    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.ops import tracer_spherical

    if not torch.cuda.is_available():
        print("a CUDA device is required", file=sys.stderr)
        return 1
    print(torch.__version__, torch.cuda.get_device_name(0), flush=True)
    etp.set_mode("mono_polarized_single")
    exp = cs._c4(75.0, stokes=True)

    def run():
        return etp.run(exp, spp=4096, seed_state=etp.SeedState(cs.SEED), device="cuda")

    run()
    prof = cs.profile_window(run, tracer_spherical, "shell_flight", 4, 16)
    t0 = time.perf_counter()
    kernels, own = cs.window_records(prof)
    raw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    events = prof.events()
    averages = prof.key_averages()
    parse_s = time.perf_counter() - t0
    print(f"raw records read in {raw_s:.2f} s, prof.events() and key_averages() in "
          f"{parse_s:.2f} s; {len(kernels)} CUDA records", flush=True)

    old_kernels = [(e.name, e.device_time / 1e3) for e in events
                   if e.device_type == DeviceType.CUDA]
    old_own = {e.key: e.self_device_time_total / 1e3 for e in averages
               if e.key.startswith("aten::") and e.self_device_time_total > 0}
    new_own = {k: ms for k, ms in own.items() if ms > 0}
    k2 = re.compile(rf"(?<![A-Za-z_]){cs.KERNELS['shell_flight']}(?![a-z_])")
    checks = {
        "CUDA record names": sorted(n for n, _ in old_kernels) == sorted(n for n, _ in kernels),
        "CUDA record durations": all(
            math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-12)
            for a, b in zip(sorted(m for _, m in old_kernels), sorted(m for _, m in kernels))),
        "operators": set(old_own) == set(new_own),
        "operators' own device time": all(
            math.isclose(old_own[k], new_own[k], rel_tol=1e-9, abs_tol=1e-12) for k in old_own
            if k in new_own),
        "K2 records": len([n for n, _ in old_kernels if k2.search(n)])
        == len(cs._kernel_records(prof, cs.KERNELS["shell_flight"])),
    }
    per_it, dev_ms, _ = cs.window_device(prof, 16)
    print(f"window: {per_it:.1f} CUDA kernels and {dev_ms:.3f} ms of device time an iteration; "
          f"top operators {cs.top_ops(prof)}", flush=True)
    for what, same in checks.items():
        print(f"  {what}: {'same' if same else 'DIFFERENT'}", flush=True)
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
