#!/usr/bin/env python3
"""What sets the pace of the slant-depth loop: the K4 kernel with one cost
of its loop taken out at a time, timed on one NVIDIA GPU.

Each variant is ``eradiate_tpu_torch/csrc/shell_flight.cu`` with one text
substitution in the loop of ``slant_tau``, built by ``nvcc`` with the
library's flags into ``build/slant_variants/``, and launched through its
``slant_tau_launch`` on the lanes of ``chip_smoke.py`` phase 7 (the c4
column at c4's lane count, seed 10, K4 on the event points of K2's flight).
The variants are not exact: they say how much of the time each cost takes,
and the largest differences from the kernel as built are printed beside the
times (CUDA events, median of 25):

* ``as built``: no substitution;
* ``float radicand``: the radicand of the root at hi as one float32 fused
  multiply-add instead of a float64 difference and a conversion;
* ``float sum``: the terms summed in float32, without the conversion to
  float64 and the float64 add;
* ``fast division``: ``__fdividef`` instead of the IEEE division;
* ``fast root``: ``x * rsqrtf(x)`` instead of the IEEE square root;
* ``all four``: every substitution above;
* ``IEEE division``: the IEEE division (``/``, with its FCHK range check
  and slow path) instead of ``div_rn``, as the loop had it before.

Usage, from the repository root on a machine with a card::

    python3 tools/chip_slant_variants.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SUBS = {
    "float radicand": [(
        "const float f_hi = loop_root(s_r2[l + 1], b2d);",
        "const float f_hi = sqrtf(fmaxf(fmaf(hi, hi, -b2), 0x1p-100f));",
    )],
    "float sum": [
        ("  double acc = 0.0;\n  for (int l = l_start;", "  float acc = 0.0f;\n  for (int l = l_start;"),
        ("acc += static_cast<double>((down + up) * s_sig[l]);", "acc += (down + up) * s_sig[l];"),
    ],
    "fast division": [(
        "const float q = div_rn(empty ? 1.0f : (hi - a) * (hi + a), empty ? 1.0f : f_a + f_hi);",
        "const float q = __fdividef(empty ? 1.0f : (hi - a) * (hi + a), empty ? 1.0f : f_a + f_hi);",
    )],
    "fast root": [(
        "  return sqrtf(fmaxf(static_cast<float>(r2 - b2), 0x1p-100f));",
        "  const float x = fmaxf(static_cast<float>(r2 - b2), 0x1p-100f);\n  return x * rsqrtf(x);",
    )],
}
SUBS["all four"] = [s for subs in SUBS.values() for s in subs]
SUBS["IEEE division"] = [(
    "const float q = div_rn(empty ? 1.0f : (hi - a) * (hi + a), empty ? 1.0f : f_a + f_hi);",
    "const float q = (empty ? 1.0f : (hi - a) * (hi + a)) / (empty ? 1.0f : f_a + f_hi);",
)]


def build(name, subs, out_dir):
    from eradiate_tpu_torch.kernels import _build

    src = (ROOT / "eradiate_tpu_torch" / "csrc" / "shell_flight.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"{name}: the kernel no longer holds {old!r}")
        src = src.replace(old, new)
    stem = name.replace(" ", "_")
    cu = out_dir / f"{stem}.cu"
    cu.write_text(src)
    so = out_dir / f"{stem}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:-2], "-shared", "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(so)).slant_tau_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main():
    import torch

    import chip_smoke as cs
    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.kernels import shell_flight as sf
    from eradiate_tpu_torch.ops.spherical import fma
    from eradiate_tpu_torch.ops.tracer import lane_partition
    from eradiate_tpu_torch.ops.tracer_spherical import spherical_lanes_target

    if not torch.cuda.is_available():
        print("chip_slant_variants: a CUDA device is required", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    etp.set_mode("mono_single")
    lp = lane_partition(cs.N_VZA_C4, cs.SPP_C4,
                        spherical_lanes_target(cs.N_VZA_C4, cs.SPP_C4, "cuda"), "cpu")[0]
    args = cs._shell_inputs(cs._c4(), cs.N_VZA_C4 * lp, seed=10)
    p, d, t_max, radii, sigma, _, w = args
    collide, t_col, _ = sf.shell_flight(*args[:6])
    p_event = fma(d, torch.where(collide, t_col, t_max)[:, None], p).contiguous()
    B, L = p_event.shape[0], sigma.shape[0]
    want = sf.slant_tau(p_event, w, radii, sigma)

    out_dir = ROOT / "build" / "slant_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, subs in [("as built", []), *SUBS.items()]:
        fn = build(name, subs, out_dir)
        tau = torch.empty_like(want)

        def launch():
            rc = fn(p_event.data_ptr(), w.data_ptr(), radii.data_ptr(), sigma.data_ptr(),
                    tau.data_ptr(), B, L, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")

        ms = cs._time_ms(launch)
        ok = want < 1e9
        rel = ((tau[ok] - want[ok]).abs() / want[ok].abs().clamp(min=1e-30)).max().item()
        print(f"{name:16s} {ms:.4f} ms; max relative difference from the kernel as built "
              f"{rel:.3e}", flush=True)
    print(f"card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
