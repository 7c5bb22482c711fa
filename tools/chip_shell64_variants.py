#!/usr/bin/env python3
"""What sets the pace of the float64 shell kernels: the float64 builds of K2,
K3 and K4 of this tree and of another one, each as built and with one
change, timed on one NVIDIA GPU.

Each variant is a ``csrc/shell_flight.cu`` (this tree's, or the one under
``--parent``) with text substitutions, built by ``nvcc`` with the library's
flags into ``build/shell64_variants/`` and launched through its
``shell_flight_f64_launch``, ``shell_event_f64_launch`` and
``slant_tau_f64_launch`` on the lanes of ``chip_smoke.py`` phase 33 (the c4
column compiled in ``mono_double`` at c4's lane count, seed 10; K4 on the
event points of K2's flight). Every variant is exact: its outputs are
compared with this tree's kernels bit for bit and the lanes that differ
printed beside the device times (``chip_smoke._device_ms``, median of 25)
and the ptxas report (registers, spills) of its float64 kernels:

* ``parent``: the other tree's float64 builds;
* ``as built``: this tree; also with other checkpoint counts
  (``--checkpoints``: ``kCheckpoints64`` replaced, the stride ceil(L / C));
* ``root of max(rad, 0)``: ``root64`` as ``__dsqrt_rn(fmax(rad, 0))``,
  without the select that keeps the root on its fast path;
* ``unrolled by 2``: both flight loops unrolled by 2.

Usage, from the repository root on a machine with a card (the other tree
unpacked into the git-ignored ``build/``; without ``--parent`` the parent
is left out)::

    python3 tools/chip_shell64_variants.py --parent build/parent
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CHECKPOINTS = "constexpr int kCheckpoints64 = 8;"
ROOT64 = """  const bool pos = rad > 0.0;
  const double s = __dsqrt_rn(pos ? rad : 1.0);
  return pos ? s : 0.0;"""

#: name -> (tree, substitutions)
VARIANTS = {
    "parent": ("parent", []),
    "as built": ("here", []),
    "root of max(rad, 0)": ("here", [(ROOT64, "  return __dsqrt_rn(fmax(rad, 0.0));")]),
    "unrolled by 2": ("here", [
        ("      for (; k < stop; ++k) {\n        if (Xk <= y_lo) { k_lo = k; acc_lo = acc;",
         "#pragma unroll 2\n      for (; k < stop; ++k) {\n        if (Xk <= y_lo) { k_lo = k; "
         "acc_lo = acc;"),
        ("  double G = prefix_value(acc);\n  while (k + 1 < L) {",
         "  double G = prefix_value(acc);\n#pragma unroll 2\n  while (k + 1 < L) {")]),
}
KERNELS = {"shell_flight": 9, "shell_event": 11, "slant_tau": 5}  # pointer operands


def build(name, src_path, subs, out_dir):
    """Build one variant; returns ({kernel: its float64 launcher}, {kernel:
    its ptxas report})."""
    from eradiate_tpu_torch.kernels import _build

    src = src_path.read_text()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"{name}: the kernel no longer holds {old!r}")
        src = src.replace(old, new)  # every occurrence
    stem = name.replace(" ", "_").replace(",", "").replace("(", "").replace(")", "")
    cu = out_dir / f"{stem}.cu"
    cu.write_text(src)
    so = out_dir / f"{stem}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu),
                           "-I", str(src_path.parent)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    blocks = (proc.stdout + proc.stderr).split("Compiling entry function ")
    lib = ctypes.CDLL(str(so))
    fns, regs = {}, {}
    for k, n_ptr in KERNELS.items():
        fn = getattr(lib, f"{k}_f64_launch")
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[k] = fn
        regs[k] = "; ".join(ln.strip().removeprefix("ptxas info    : ") for b in blocks
                            if f"{k}_f64_kernel" in b.split("\n")[0]
                            for ln in b.splitlines() if "registers" in ln or "spill" in ln)
    return fns, regs


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of the other tree")
    ap.add_argument("--checkpoints", type=int, nargs="*", default=[4, 16])
    a = ap.parse_args()

    import chip_smoke as cs
    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.kernels import shell_flight as sf
    from eradiate_tpu_torch.ops.spherical import fma
    from eradiate_tpu_torch.ops.tracer import lane_partition
    from eradiate_tpu_torch.ops.tracer_spherical import spherical_lanes_target

    if not torch.cuda.is_available():
        print("chip_shell64_variants: a CUDA device is required", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    etp.set_mode("mono_double")
    lp = lane_partition(cs.N_VZA_C4, cs.SPP_C4,
                        spherical_lanes_target(cs.N_VZA_C4, cs.SPP_C4, "cuda"), "cpu")[0]
    p, d, t_max, radii, sigma, tau_s, w = cs._shell_inputs_f64(cs._c4(), cs.N_VZA_C4 * lp, 10)
    B, L = p.shape[0], sigma.shape[0]
    want = {"shell_flight": sf.shell_flight(p, d, t_max, radii, sigma, tau_s),
            "shell_event": sf.shell_event(p, d, t_max, radii, sigma, tau_s, w)}
    collide, t_col, _ = want["shell_flight"]
    p_event = fma(d, torch.where(collide, t_col, t_max)[:, None], p).contiguous()
    want["slant_tau"] = (sf.slant_tau(p_event, w, radii, sigma),)
    # the launchers' operand order
    ins = {"shell_flight": (p, d, t_max, tau_s, radii, sigma),
           "shell_event": (p, d, t_max, tau_s, radii, sigma, w),
           "slant_tau": (p_event, w, radii, sigma)}
    dtypes = {"shell_flight": (torch.bool, torch.float64, torch.int32),
              "shell_event": (torch.bool, torch.float64, torch.int32, torch.float64),
              "slant_tau": (torch.float64,)}

    out_dir = ROOT / "build" / "shell64_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    trees = {"here": ROOT, "parent": Path(a.parent).resolve() if a.parent else None}
    runs = [(name, tree, subs) for name, (tree, subs) in VARIANTS.items() if trees[tree]]
    runs[2:2] = [(f"as built, {c} checkpoints", "here",
                  [(CHECKPOINTS, CHECKPOINTS.replace("= 8;", f"= {c};"))]) for c in a.checkpoints]
    for name, tree, subs in runs:
        fns, regs = build(name, trees[tree] / "eradiate_tpu_torch" / "csrc" / "shell_flight.cu",
                          subs, out_dir)
        line = []
        for k, fn in fns.items():
            outs = tuple(torch.empty(B, dtype=dt, device="cuda") for dt in dtypes[k])

            def launch(fn=fn, k=k, outs=outs):
                rc = fn(*[t.data_ptr() for t in ins[k] + outs], B, L,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: {k}_f64: CUDA error {rc}")

            ms, by = cs._device_ms(launch, f"{k}_f64_kernel")
            differ = sum(int((cs._bits(g) != cs._bits(w_)).sum()) for g, w_ in zip(outs, want[k]))
            line.append(f"{k}_f64 {ms:.4f} ms ({by}), {differ} lanes differ [{regs[k]}]")
        print(f"{name}: " + "; ".join(line), flush=True)
    print(f"card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
