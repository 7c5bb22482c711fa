#!/usr/bin/env python3
"""Read how far the port's shell depths lie from the reference's tangents.

On K2's stress lanes (``test_tools/shells.flight_stress_inputs``, 2004
lanes) of each of the flight's six stress columns, ``shell_depths_plain``
launched on a tangent of sigma is held against ``jax.jvp`` of the
reference's ``shell_flight_lr`` (the tangents of ``g_col`` and
``tau_max_att``, x64 for float64), at the reference's own flights, as
``tests/test_torch_forward_rules.py`` holds it: a lane's deviation over its
depth scale. Each column prints the largest and the median deviation and
the lanes above the float32 gate (1e-5), for

- ``port``: the port as it is;
- ``fused``: the port's formula with ``r^2 - b^2`` formed as one fused
  multiply-add (float32 only);
- ``folded``: the reference jitted with its operands closed over as
  constants, so that XLA folds x0, b^2 and the shell coordinates at compile
  time (how the test called it before).

Run from the repository root on the CPU::

    JAX_PLATFORMS=cpu python3 tools/shell_depth_lanes.py [--dtype float64]
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    args = ap.parse_args(argv)
    dtype = np.dtype(args.dtype).type

    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", dtype == np.float64)
    from eradiate_tpu.ops import spherical as ref
    from eradiate_tpu_torch.ops import spherical as sph
    from eradiate_tpu_torch.ops.fastmath import fma32
    from eradiate_tpu_torch.test_tools import shells

    def reference(ops, folded):
        def tangents(p, d, t_max, radii, sigma, tau_s, sig_t):
            return jax.jvp(lambda s: ref.shell_flight_lr(p, d, t_max, radii, s, tau_s),
                           (sigma,), (sig_t,))

        ops = [jnp.asarray(a) for a in ops]
        (collide, t_col, layer, _, _), (_, _, _, g_t, tmax_t) = (
            jax.jit(lambda: tangents(*ops))() if folded else jax.jit(tangents)(*ops))
        return [np.asarray(a) for a in (collide, t_col, layer, g_t, tmax_t)]

    def fused_depths(p, d, t_col, layer, t_max, radii, v):
        # shell_depths_plain with X = sqrt(fma(r, r, -b^2))
        real = sph.sqrt_rn

        def root(x):
            b2 = sph.cross_norm2(p, d)
            r = radii[:, None].expand(-1, b2.shape[0])
            return real(torch.clamp(fma32(r, radii[:, None], -b2), min=0.0))

        sph.sqrt_rn = lambda x: root(x) if x.ndim == 2 else real(x)
        try:
            return sph.shell_depths_plain(p, d, t_col, layer, t_max, radii, v)
        finally:
            sph.sqrt_rn = real

    print(f"{args.dtype}: deviation over the lane's depth scale: max, median, lanes > 1e-5")
    for name, (r_c, s_c) in shells.flight_columns(np.random.default_rng(8)).items():
        radii, sigma = (np.asarray(a, dtype) for a in (r_c, s_c))
        p, d, t_max, tau_s = shells.flight_stress_inputs(np.random.default_rng(9), radii, sigma,
                                                         2004, dtype=dtype)
        sig_t = (sigma * np.random.default_rng(14).uniform(0.5, 1.5, sigma.shape[0])
                 ).astype(dtype)
        p64, d64 = np.asarray(p, np.float64), np.asarray(d, np.float64)
        b2 = (np.cross(p64, d64) ** 2).sum(-1)
        X = np.sqrt(np.maximum(radii.astype(np.float64)[:, None] ** 2 - b2, 0.0))
        scale = np.maximum((np.abs(sig_t)[:, None] * np.diff(X, axis=0)).sum(0), 1e-30)
        ops = [np.asarray(a) for a in (p, d, t_max, radii, sigma, tau_s, sig_t)]
        row = []
        for label, folded, depths in (("port", False, sph.shell_depths_plain),
                                      ("fused", False, fused_depths),
                                      ("folded", True, sph.shell_depths_plain)):
            if label == "fused" and dtype == np.float64:
                continue
            collide, t_col, layer, g_t, tmax_t = reference(ops, folded)
            dep_col, dep_max = depths(p, d, torch.tensor(t_col),
                                      torch.tensor(layer.astype(np.int32)), t_max,
                                      torch.tensor(radii), torch.tensor(sig_t))
            s_at = sigma[layer]
            ratio = np.where(s_at > 1e-30, sig_t[layer] / np.where(s_at > 0, s_at, 1.0), 0.0)
            dev = np.concatenate([
                np.abs(dep_max.numpy() - tmax_t) / scale,
                (np.abs(ratio - dep_col.numpy() - g_t) / (scale + np.abs(ratio)))[collide]])
            row.append(f"{label} {dev.max():.3e} {np.median(dev):.3e} "
                       f"{int((dev > 1e-5).sum())}/{dev.size}")
        print(f"  {name}: " + "; ".join(row), flush=True)


if __name__ == "__main__":
    main()
