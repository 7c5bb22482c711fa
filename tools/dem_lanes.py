#!/usr/bin/env python3
"""Count the lanes on which the port's DEM trace leaves the reference's.

The 33 x 33 hill of ``tests/test_torch_dem_experiment.py`` (Rayleigh
column, sun at 60 degrees, three view zeniths over a 4 km x 4 km target) is
traced lane by lane by the reference's jitted ``trace_paths_dem_regen`` and
by the port's, at the same keys (``fold_in(fold_in(key(seed), 0), chunk)``),
with ``spp`` samples a pixel in the reference's lane plan; a lane leaves
where its sum differs by more than 1e-5 relative. ``--z-fused`` rounds the
hit and offset points' z as one fused multiply-add too (the port fuses x and
y only, as XLA:CPU does). Run from the repository root on the CPU::

    JAX_PLATFORMS=cpu python3 tools/dem_lanes.py --spp 1024 [--z-fused]
    JAX_PLATFORMS=cpu python3 tools/dem_lanes.py --spp 16 --chunk 1
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--chunk", type=int, default=0)
    ap.add_argument("--triangulate", action="store_true")
    ap.add_argument("--z-fused", action="store_true")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    import eradiate_tpu
    import eradiate_tpu_torch
    from eradiate_tpu.experiments import DEMExperiment
    from eradiate_tpu.ops import dem as ref_dem
    from eradiate_tpu.ops import scene_state as ref_state
    from eradiate_tpu.ops import tracer as ref_tracer
    from eradiate_tpu.ops import tracer_dem as ref_tracer_dem
    from eradiate_tpu.scenes.surface import DEMSurface
    from eradiate_tpu_torch.kernels.leaf_intersect import fma
    from eradiate_tpu_torch.ops import tracer, tracer_canopy, tracer_dem
    from eradiate_tpu_torch.ops.dem import mesh_from_dem
    from eradiate_tpu_torch.ops.mesh import tri_accel
    from eradiate_tpu_torch.ops.scene_state import dem_from_reference, from_reference

    eradiate_tpu.set_mode("mono_single")
    eradiate_tpu_torch.set_mode("mono_single")
    s = DEMSurface.gaussian_hill(height_km=1.0, sigma_km=1.0, extent_km=10.0, n=33,
                                 bsdf={"type": "lambertian", "reflectance": 0.5})
    exp = DEMExperiment(
        illumination={"type": "directional", "zenith": 60.0, "azimuth": 0.0},
        measures={"type": "mdistant", "construct": "hplane", "zeniths": [-45.0, 0.0, 45.0],
                  "azimuth": 0.0, "spp": args.spp, "id": "m",
                  "target": {"type": "rectangle", "xmin": -2.0, "xmax": 2.0, "ymin": -2.0,
                             "ymax": 2.0, "z": 1.1}},
        surface=s, atmosphere={"type": "molecular"})
    m = exp.measures[0]
    scene, sensor, config = exp.compile_scene(m, exp.spectral_context(m))
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(args.seed), 0), args.chunk)
    n_pix = 3
    _, pix, _, lane_first, quota = ref_tracer.lane_partition(n_pix, args.spp)
    med, il = scene.medium, scene.illumination
    mr = ref_state.MediumArrays(
        z_levels=med.z_levels, tau_levels=med.tau_levels[0], albedo=med.albedo[0],
        phase_weights=med.phase_weights[0],
        phase_params=jax.tree.map(lambda x: x[0], med.phase_params))
    sr = jax.tree.map(lambda x: x[0] if getattr(x, "ndim", 0) else x, scene.surface)
    ir = ref_state.IlluminationArrays(
        direction=il.direction, irradiance=il.irradiance[0], cos_cutoff=il.cos_cutoff,
        sky_radiance=il.sky_radiance[0] if il.sky_radiance.ndim else il.sky_radiance)
    w_v = jnp.asarray(sensor.directions)[pix]
    B = pix.shape[0]
    tgt = jnp.broadcast_to(jnp.asarray(sensor.target), (B, 3))
    ext = jnp.broadcast_to(jnp.asarray(sensor.target_extent), (B, 2))
    init_pos = tgt + w_v * ((mr.z_levels[-1] - tgt[:, 2]) / jnp.maximum(w_v[:, 2], 1e-6))[:, None]
    ref_tris = (ref_dem.mesh_from_dem(s.elevation, s.x0, s.y0, s.dx, s.dy, dtype=jnp.float32)
                if args.triangulate else None)
    want = np.asarray(jax.jit(ref_tracer_dem.trace_paths_dem_regen, static_argnums=(0,))(
        config, mr, sr, s.dem_arrays(np.float32), ir, init_pos, -w_v, key, lane_first, quota,
        ext=ext, tris=ref_tris)[0])

    if args.z_fused:
        tracer_dem._advance = lambda pos, d, t: fma(d, t.expand(-1, 3), pos)
    sc, se, cf = from_reference(scene, sensor, config, "cpu")
    medium_row, surface_row, illum_row = tracer.row_arrays(sc, 0)
    _, p_pix, _, p_first, p_quota = tracer.lane_partition(n_pix, args.spp, 2**14, "cpu")
    p_pos, p_d, p_ext = tracer_canopy.lane_rays(medium_row, se.directions, se.target,
                                                se.ray_offset, se.target_extent, p_pix)
    tris = accel = None
    if args.triangulate:
        tris = mesh_from_dem(s.elevation, s.x0, s.y0, s.dx, s.dy)
        accel = tri_accel(tris)
    got = tracer_dem.trace_paths_dem_regen(
        cf, medium_row, surface_row, dem_from_reference(s.elevation, s.x0, s.y0, s.dx, s.dy,
                                                        "cpu"),
        illum_row, p_pos, p_d, torch.as_tensor(np.asarray(jax.random.key_data(key)).astype(
            np.int64)), p_first, p_quota, ext=p_ext, tris=tris, accel=accel)[0].numpy()
    off = np.nonzero(np.abs(got - want) > 1e-5 * np.abs(want) + 1e-12)[0]
    print(f"{off.size} of {want.size} lanes leave the reference's path: {off.tolist()[:20]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
