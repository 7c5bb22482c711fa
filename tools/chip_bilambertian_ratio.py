#!/usr/bin/env python3
"""The canopy loop's cost of the bilambertian side choice's likelihood-ratio
weight, on one NVIDIA GPU.

The instanced c5 scene (``chip_smoke._c5``, 19 view zeniths) renders at
``--spp`` on the card twice in one process: with the port's
``bsdf_ops.bilambertian_sample_from_uniforms`` (the side chosen on the
detached ``rho / (rho + tau)`` and the weight ``(rho + tau) * p / p_ref``)
and with the side choice as the port made it before that weight (the weight
``rho + tau`` alone, :func:`side_choice_without_ratio`). For each it prints
the CUDA kernels and device ms an iteration (a profiler window of 16
iterations after 8, ``chip_smoke.profile_window``), and whether the two
radiances are equal bit for bit (the weight's primal is 1), then the card's
name and power limit.

Usage, from the repository root on a machine with a card::

    python3 tools/chip_bilambertian_ratio.py [--spp 65536]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def side_choice_without_ratio(params, wo, u_side, u):
    """The bilambertian side choice without its likelihood-ratio weight."""
    import torch

    from eradiate_tpu_torch.core.warp import square_to_cosine_hemisphere
    from eradiate_tpu_torch.ops.fastmath import cosine_hemisphere_xla

    rho = params["reflectance"]
    total = rho + params["transmittance"]
    reflect = u_side < rho / torch.clamp(total, min=1e-12)
    if wo.dtype == torch.float64 and u.dtype == torch.float32:
        w_new = cosine_hemisphere_xla(u)
    else:
        w_new = square_to_cosine_hemisphere(u)
    flip = torch.tensor([1.0, 1.0, -1.0], dtype=w_new.dtype, device=w_new.device)
    w_new = torch.where(reflect[..., None], w_new, w_new * flip)
    return w_new, torch.where(total > 0, total, 0.0).expand(w_new.shape[:-1])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=2**16)
    args = ap.parse_args(argv)

    import numpy as np

    import chip_smoke as cs
    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.ops import tracer_canopy

    etp.set_mode("mono_single")
    exp = cs._c5("instanced")

    def render():
        return etp.run(exp, spp=args.spp, seed_state=etp.SeedState(cs.SEED), device="cuda")

    saved = tracer_canopy.bilambertian_sample_from_uniforms
    out = {}
    for label, fn in (("with the ratio weight", saved),
                      ("without it", side_choice_without_ratio)):
        tracer_canopy.bilambertian_sample_from_uniforms = fn
        try:
            radiance = np.asarray(render()["radiance"])
            n, ms, _ = cs.window_device(cs.profile_window(
                render, tracer_canopy, "leaf_nearest", 8, 16), 16)
        finally:
            tracer_canopy.bilambertian_sample_from_uniforms = saved
        out[label] = radiance
        print(f"c5 instanced, {cs.N_VZA_C5} VZA x {args.spp} spp, {label}: {n:.1f} CUDA "
              f"kernels and {ms:.3f} device ms an iteration", flush=True)
    same = np.array_equal(*out.values())
    print(f"radiance equal bit for bit: {same}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
