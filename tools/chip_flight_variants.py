#!/usr/bin/env python3
"""What sets the pace of the shell flight: the K2 kernel of this tree and of
another one, each as built and with one change, timed on one NVIDIA GPU.

Each variant is a ``csrc/shell_flight.cu`` (this tree's, or the one under
``--parent``) with text substitutions, built by ``nvcc`` with the library's
flags into ``build/flight_variants/`` and launched through its
``shell_flight_launch`` on the lanes of ``chip_smoke.py`` phase 7 (the c4
column at c4's lane count, seed 10). Every variant but ``fast root`` and
``counted`` is exact: the outputs are compared with this tree's kernel and
the lanes that differ printed beside the times (CUDA events, median of 25):

* ``parent``: the other tree's flight (two sweeps from level 0, the IEEE
  root of radicands <= 0 below a lane's tangent);
* ``parent, clamped root``: the same with the radicand clamped to 2^-100
  and +0 selected below the tangent (``sqrtf`` still): the clamp alone;
* ``as built``: this tree (one sweep with checkpoints, the bounded resume,
  the clamped radicand, ``root_rn``); also with other checkpoint counts
  (``--checkpoints``: ``kCheckpoints`` replaced, the stride ceil(L / C));
* ``IEEE root``: this tree with ``sqrtf(max(r2 - b2, 0))``: the sweep and
  the checkpoints alone;
* ``clamped sqrtf``: this tree with ``sqrtf`` of the clamped radicand
  instead of ``root_rn``: what dropping the range check gives;
* ``fast root``: this tree with ``x * rsqrtf(x)`` (not exact): the cost of
  the exact root's fix-up;
* ``unrolled by 2``: this tree with both loops unrolled by 2;
* ``counted``: this tree with a count of the passes of both loops' bodies
  (each reads one level) written into ``t_col``'s bits: the kernel's own
  level passes a lane, held lane for lane against the emulation's
  (``test_tools.shells.shell_flight_checkpointed``, ``sweep + walk``),
  with the mean a lane and the slowest lane of a warp printed.

Usage, from the repository root on a machine with a card (the other tree
unpacked into the git-ignored ``build/``; without ``--parent`` the parent's
variants are left out)::

    python3 tools/chip_flight_variants.py --parent build/parent
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BUILT_ROOT = """  const float root = root_rn(fmaxf(rad, 0x1p-100f));
  return rad > 0.0f ? root : 0.0f;"""
PARENT_ROOT = "return sqrtf(fmaxf(r * r - b2, 0.0f));"
CLAMPED_SQRTF = "return rad > 0.0f ? sqrtf(fmaxf(rad, 0x1p-100f)) : 0.0f;"

#: name -> (tree, substitutions)
VARIANTS = {
    "parent": ("parent", []),
    "parent, clamped root": ("parent", [(
        PARENT_ROOT, f"const float rad = r * r - b2;\n  {CLAMPED_SQRTF}")]),
    "as built": ("here", []),
    "IEEE root": ("here", [(BUILT_ROOT, "  return sqrtf(fmaxf(rad, 0.0f));")]),
    "clamped sqrtf": ("here", [(BUILT_ROOT, "  " + CLAMPED_SQRTF)]),
    "fast root": ("here", [(
        BUILT_ROOT,
        "  const float x = fmaxf(rad, 0x1p-100f);\n  return rad > 0.0f ? x * rsqrtf(x) : 0.0f;")]),
    "unrolled by 2": ("here", [
        ("      for (; k < stop; ++k) {", "#pragma unroll 2\n      for (; k < stop; ++k) {"),
        ("  while (k + 1 < L) {", "#pragma unroll 2\n  while (k + 1 < L) {")]),
    "counted": ("here", [
        ("  const float b2 = cross_norm2(p, d);\n",
         "  const float b2 = cross_norm2(p, d);\n  int visits = 0;\n"),
        ("const float2 s = step[k + 1];", "const float2 s = step[k + 1];\n    ++visits;"),
        ("  out.t_col = fminf(fmaxf(x_col - x0, 0.0f), t_max);",
         "  out.t_col = __int_as_float(visits);")]),
}
CHECKPOINTS = "constexpr int kCheckpoints = 16;"


def build(name, src_path, subs, out_dir):
    """Build one variant; returns (its shell_flight_launch, the ptxas report
    of its shell_flight_kernel)."""
    from eradiate_tpu_torch.kernels import _build

    src = src_path.read_text()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"{name}: the kernel no longer holds {old!r}")
        src = src.replace(old, new)  # every occurrence
    stem = name.replace(" ", "_").replace(",", "")
    cu = out_dir / f"{stem}.cu"
    cu.write_text(src)
    so = out_dir / f"{stem}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu),
                           "-I", str(src_path.parent)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    blocks = (proc.stdout + proc.stderr).split("Compiling entry function ")
    regs = [ln.split("Used ")[1] for b in blocks if "shell_flight_kernel" in b.split("\n")[0]
            for ln in b.splitlines() if "Used" in ln and "registers" in ln]
    fn = ctypes.CDLL(str(so)).shell_flight_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, regs


def counted(outs, want, flight, S):
    """Print the counted variant's level passes (``t_col``'s bits) beside
    the emulation's, lane for lane; fails where collide or layer differ
    from this tree's kernel or a lane's count from the emulation's."""
    import torch

    from eradiate_tpu_torch.test_tools import shells

    if not (torch.equal(outs[0], want[0]) and torch.equal(outs[2], want[2])):
        raise AssertionError("counted: collide or layer differ from this tree's kernel")
    *_, tr = shells.shell_flight_checkpointed(*flight, S)
    kernel = outs[1].view(torch.int32).long()
    emulated = tr["sweep"] + tr["walk"]
    differ = int((kernel != emulated).sum())
    slowest = shells.warp_max(kernel)
    L = flight[4].shape[0]
    print(f"    the kernel's own level passes: {float(kernel.double().mean()):.2f} a lane, slowest "
          f"lane of a warp {float(slowest.double().mean()):.2f}, at most {int(slowest.max())} "
          f"(L + S = {L + S}); lanes whose count differs from the emulation's {differ}",
          flush=True)
    if differ:
        raise AssertionError(f"counted: {differ} lanes pass another number of levels "
                             "than the emulation")


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of the other tree")
    ap.add_argument("--checkpoints", type=int, nargs="*", default=[4, 8, 32, 64])
    a = ap.parse_args()

    import chip_smoke as cs
    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.kernels import shell_flight as sf
    from eradiate_tpu_torch.ops.tracer import lane_partition
    from eradiate_tpu_torch.ops.tracer_spherical import spherical_lanes_target

    if not torch.cuda.is_available():
        print("chip_flight_variants: a CUDA device is required", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    etp.set_mode("mono_single")
    lp = lane_partition(cs.N_VZA_C4, cs.SPP_C4,
                        spherical_lanes_target(cs.N_VZA_C4, cs.SPP_C4, "cuda"), "cpu")[0]
    p, d, t_max, radii, sigma, tau_s, _ = cs._shell_inputs(cs._c4(), cs.N_VZA_C4 * lp, seed=10)
    B, L = p.shape[0], sigma.shape[0]
    want = sf.shell_flight(p, d, t_max, radii, sigma, tau_s)
    ins = (p, d, t_max, tau_s, radii, sigma)  # the launchers' order

    out_dir = ROOT / "build" / "flight_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    trees = {"here": ROOT, "parent": Path(a.parent).resolve() if a.parent else None}
    runs = [(name, tree, subs) for name, (tree, subs) in VARIANTS.items() if trees[tree]]
    runs += [(f"as built, {c} checkpoints", "here",
              [(CHECKPOINTS, CHECKPOINTS.replace("16", str(c)))]) for c in a.checkpoints]
    for name, tree, subs in runs:
        fn, regs = build(name, trees[tree] / "eradiate_tpu_torch" / "csrc" / "shell_flight.cu",
                         subs, out_dir)
        outs = tuple(torch.empty(B, dtype=dt, device="cuda")
                     for dt in (torch.bool, torch.float32, torch.int32))

        def launch():
            rc = fn(*[t.data_ptr() for t in ins + outs], B, L,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")

        ms = cs._time_ms(launch)
        differ = sum(int((g.view(torch.int32) != w.view(torch.int32)).sum())
                     if g.dtype == torch.float32 else int((g != w).sum())
                     for g, w in zip(outs, want))
        print(f"{name:32s} {ms:.4f} ms; lanes differing from this tree's kernel (any "
              f"output) {differ}; ptxas: {'; '.join(regs)}", flush=True)
        if name == "counted":
            counted(outs, want, (p, d, t_max, radii, sigma, tau_s), sf.flight_stride(L))
    print(f"card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
