"""Wavefront path tracer for terrain (DEM) surfaces under a 1D atmosphere,
plane-parallel geometry.

Port of ``eradiate_tpu/ops/tracer_dem.py`` (``render_dem``). Every
candidate free-flight segment is tested against the terrain, and next-event
estimation casts terrain-occlusion shadow rays toward the sun (self-shadowing
at low sun) at the collision point and at the terrain point, two a bounce.
With ``config.lr_flight`` (the sensitivity renders) the flight is the
reference's likelihood-ratio one, terrain hits carrying a weight of their
own; its weights' primal is exactly 1.
The terrain is the marched bilinear heightfield of :mod:`.dem` or, with
``tris``, its triangulation (:func:`.dem.mesh_from_dem`) through the
triangle sweeps of :mod:`.mesh` (K8: the nearest-hit sweep once an
iteration, the any-hit sweep twice). The tracer has no Mueller step: a
polarized config renders the scalar result, as the reference does.

The reference's ``while_loop`` is an eager Python loop here, as in
:mod:`.tracer`: every update is gated by ``active``, ``path_end`` or
``regen``, so the all-lanes-done flag is read on the host only every
``check_every`` iterations. Lanes that are done, and shadow rays whose
answer the bounce does not read, are not marched (the any-hit sweep gets
them with a zero flight): they change nothing the estimate reads.

Random numbers follow the reference bit for bit (threefry row and chunk keys
on the host, pcg4d or threefry per-sample keys and per-bounce uniforms on
the device). The chunk plan is the reference's DEM rule on the CPU
(:data:`DEM_PATHS_PER_DISPATCH`), so same-seed runs agree with it.
"""

from __future__ import annotations

import torch

from ..core.device import resolve_device
from ..kernels.leaf_intersect import fma
from .bsdf_ops import bsdf_eval, bsdf_sample_from_uniforms, check_kind
from .dem import DemArrays, dem_intersect, dem_normal, dem_occluded
from .fastmath import depth_sample
from .fastrng import bounce_uniforms, derive_keys, origin_uniforms
from .medium import clamp_mu, take_1d, tau_at_z, z_at_tau
from .mesh import TriangleMeshArrays, tri_accel, tri_nearest, tri_occluded
from .phase_ops import (
    check_phase_kinds,
    layer_param_slots,
    phase_eval_at,
    phase_sample_at,
    rebuild_fetched,
)
from .scene_state import from_reference
from .tracer import (
    CHECK_EVERY,
    MAX_PATHS_PER_DISPATCH,
    RowRenderer,
    chunk_plan,
    lane_partition,
    row_arrays,
    row_key,
)
from .tracer_canopy import LANES_TARGET, _to_local, _to_world, lane_rays

__all__ = ["render_dem", "row_renderer", "trace_paths_dem_regen", "DEM_PATHS_PER_DISPATCH"]

#: Paths of one dispatch per device type. The CPU keeps the reference's DEM
#: rule (``MAX_PATHS_PER_DISPATCH // 16``, not the plane-parallel tracer's),
#: so that CPU runs decompose like the reference's and same-seed tests hold;
#: a card takes a full-width render (19 pixels x 2097152 samples) in one
#: dispatch, since such renders are held to the reference by statistics, not
#: by stream. Renders of fewer than ``cap / 16`` paths a row chunk alike on
#: both.
DEM_PATHS_PER_DISPATCH = {"cpu": MAX_PATHS_PER_DISPATCH // 16, "cuda": 2**26}

#: Offset of the terrain point along the normal, and the least flight.
EPS = 1e-5


def _advance(pos, d, t):
    """``pos + d t`` [B, 3] for distances ``t`` [B, 1] or [B, 3], rounded as
    XLA:CPU rounds the reference's: x and y one fused multiply-add each (the
    vectorised pair of a 3-wide row), z a product and a sum. A terrain hit
    point is rounded so, and the shading, the offset point's shadow ray and
    the next flight start from it; with z fused too, 64 of 384 lanes of
    the tests' 33 x 33 hill at 1024 spp leave the reference's path
    (``tools/dem_lanes.py --z-fused``)."""
    t = t.expand(-1, 3)
    xy = fma(d[:, :2], t[:, :2], pos[:, :2])
    return torch.cat([xy, pos[:, 2:] + d[:, 2:] * t[:, 2:]], dim=1)


def _make_bounce_dem(config, medium_row, surface_row, dem, illum_row, B, tris=None,
                     accel=None, n_march=128, n_bisect=16):
    """Per-bounce transition: returns ``bounce(depth, pos, d, beta, keys,
    live) -> (L_add, pos', d', beta', alive')``; updates are unconditional
    (the caller masks finished lanes), and lanes outside ``live`` [B] bool
    may come back with any state. ``tris``/``accel``: the triangulated
    terrain and its :func:`.mesh.tri_accel`, in place of the marched
    heightfield ``dem``."""
    z_levels = medium_row.z_levels
    tau_levels = medium_row.tau_levels
    tau_top = tau_levels[-1]
    z_bottom, z_top = z_levels[0], z_levels[-1]
    dtype = z_levels.dtype

    d_sun = illum_row.direction
    mu_sun = clamp_mu(-d_sun[2])
    w_sun = (-d_sun).expand(B, 3).contiguous()
    E_sun = illum_row.irradiance
    shadow_range = (2.0 * (z_top - z_bottom) / torch.clamp(mu_sun, min=0.05)).expand(B)

    C = len(config.phase_kinds)
    phase_params = medium_row.phase_params
    param_tables, param_slots = layer_param_slots(config.phase_kinds, phase_params)
    fetch_tables = torch.stack(
        [medium_row.phase_weights[c] for c in range(C)] + param_tables
    )

    # the likelihood-ratio flight (reference ops/tracer_dem.py): sampling
    # from the detached medium, the attached one re-entering through weights
    # whose primal is exactly 1; a terrain hit at depth tau_path has
    # probability exp(-tau_path), its weight exp(-(tau_path - sg(tau_path)))
    lr = config.lr_flight
    tau_levels_s = tau_levels.detach() if lr else tau_levels
    tau_top_s = tau_top.detach() if lr else tau_top
    dtau_layers = torch.diff(tau_levels) if lr else None

    def tau_z(z):
        return tau_at_z(z, z_levels, tau_levels)

    def sun_T(pos, lanes):
        """Sun transmittance at ``pos``, terrain shadow included, read only
        on ``lanes``."""
        T_atm = torch.exp(-(tau_top - tau_z(pos[:, 2].contiguous())) / mu_sun)
        if tris is not None:
            t_max = torch.where(lanes, shadow_range, 0.0)
            hit = tri_occluded(pos, w_sun, t_max, tris, accel)
        else:
            hit = dem_occluded(dem, pos, w_sun, shadow_range, n_march, lanes=lanes)
        return T_atm * torch.where(hit, 0.0, 1.0)

    def bounce(depth_b, pos, d, beta, keys, live):
        U = bounce_uniforms(keys, depth_b, 8, config.rng)
        u_dist = U[:, 0]
        u_sel, u_cos, u_phi = U[:, 1], U[:, 2:4], U[:, 4]
        u_srf = U[:, 5:7]
        u_rr = U[:, 7]

        z = pos[:, 2].contiguous()
        mu = clamp_mu(d[:, 2])
        tau_here = tau_z(z)
        tau_here_s = tau_here.detach() if lr else tau_here
        tau_exit = torch.where(mu > 0.0, (tau_top_s - tau_here_s) / mu, tau_here_s / (-mu))
        tau_s = depth_sample(u_dist, exact=dtype == torch.float64)
        collide_med = tau_s < tau_exit

        tau_new = torch.minimum(torch.clamp(tau_here_s + mu * tau_s, min=0.0), tau_top_s)
        z_med, layer = z_at_tau(tau_new, z_levels, tau_levels_s)
        z_edge = torch.where(mu > 0.0, z_top, z_bottom)
        t_cand = torch.where(collide_med, (z_med - z) / mu, (z_edge - z) / mu)
        t_cand = torch.clamp(t_cand, min=EPS)

        if tris is not None:
            # the marcher's overshoot: the candidate endpoint can land
            # marginally short of a grazed or boundary-coincident surface
            t_seg = fma(t_cand, torch.full_like(t_cand, 1.02), torch.full_like(t_cand, 1e-4))
            t_dem, n_tri, hit_dem = tri_nearest(pos, d, torch.where(live, t_seg, 0.0), tris, accel)
        else:
            t_dem, hit_dem = dem_intersect(dem, pos, d, t_cand, n_march, n_bisect, lanes=live)

        event_dem = hit_dem & config.has_surface
        event_med = collide_med & ~event_dem

        pos_dem = _advance(pos, d, t_dem[:, None])
        pos_med = _advance(pos, d, t_cand[:, None])

        beta_med = beta_dem = beta
        if lr:
            # the weights of a collision (density dtau exp(-tau_path) at the
            # fixed altitude) and of a terrain hit (exp(-tau_path)), on the
            # attached tau(z) at the detached geometry; primal exactly 1
            abs_mu = torch.abs(mu)
            tau_path_col = torch.abs(tau_z(z_med) - tau_here) / abs_mu
            g_col = torch.log(torch.clamp(take_1d(dtau_layers, layer), min=1e-30)) - tau_path_col
            tau_path_dem = torch.abs(tau_z(pos_dem[:, 2].contiguous()) - tau_here) / abs_mu
            beta_med = beta * torch.exp(g_col - g_col.detach())
            beta_dem = beta * torch.exp(-(tau_path_dem - tau_path_dem.detach()))

        # ---- medium collision -------------------------------------------
        albedo_col = take_1d(medium_row.albedo, layer)
        fetched = fetch_tables[:, layer]
        weights_at = fetched[:C].T
        params_at = rebuild_fetched(config.phase_kinds, param_slots, fetched[C:])
        cos_nee = (w_sun * d).sum(-1)
        p_nee = phase_eval_at(config.phase_kinds, phase_params, weights_at, params_at, cos_nee)
        L_med = beta_med * albedo_col * p_nee * sun_T(pos_med, live & event_med) * E_sun
        d_med = phase_sample_at(
            config.phase_kinds, phase_params, weights_at, params_at, d, u_sel, u_cos, u_phi
        )
        beta_med = beta_med * albedo_col

        # ---- terrain hit ------------------------------------------------
        if tris is not None:
            # the triangle's normal turned toward the incoming ray (the
            # terrain is single-sided, seen from above)
            flip = (n_tri * d).sum(-1) > 0.0
            n_srf = torch.where(flip[:, None], -n_tri, n_tri)
        else:
            n_srf = dem_normal(dem, pos_dem[:, 0], pos_dem[:, 1])
        wo_l = _to_local(n_srf, -d)
        wi_sun_l = _to_local(n_srf, w_sun)
        xy_dem = pos_dem[:, :2]
        f_nee = bsdf_eval(config.surface_kind, surface_row.params, wi_sun_l, wo_l, xy_dem)
        cos_sun = torch.clamp((n_srf * w_sun).sum(-1), min=0.0)
        pos_dem_off = _advance(pos_dem, n_srf, torch.full_like(n_srf, EPS))
        L_dem = beta_dem * f_nee * cos_sun * sun_T(pos_dem_off, live & event_dem) * E_sun
        d_srf_l, w_srf = bsdf_sample_from_uniforms(
            config.surface_kind, surface_row.params, wo_l, u_srf, xy_dem
        )
        d_srf = _to_world(n_srf, d_srf_l)
        beta_srf = beta_dem * w_srf

        # ---- combine ----------------------------------------------------
        L_add = torch.where(event_dem, L_dem, torch.where(event_med, L_med, 0.0))
        pos2 = torch.where(event_dem[:, None], pos_dem_off, pos_med)
        d2 = torch.where(
            event_dem[:, None], d_srf, torch.where(event_med[:, None], d_med, d)
        )
        beta2 = torch.where(event_dem, beta_srf, torch.where(event_med, beta_med, 0.0))
        alive2 = (event_dem | event_med) & (beta2 > 0.0)

        do_rr = depth_b >= config.rr_depth
        q = torch.clamp(beta2, 0.0, 0.95)
        survive = u_rr < q
        beta2 = torch.where(do_rr & alive2 & survive, beta2 / q, beta2)
        alive2 = alive2 & (survive | ~do_rr)
        return L_add, pos2, d2, beta2, alive2

    return bounce


def trace_paths_dem_regen(
    config, medium_row, surface_row, dem, illum_row, init_pos, init_d, row_key,
    lane_first, quota, ext=None, tris=None, accel=None, n_march=128, n_bisect=16,
):
    """Regenerative DEM trace (see :func:`.tracer.trace_paths_regen`): lane
    ``l`` renders samples ``lane_first[l] .. lane_first[l] + quota[l] - 1``;
    ``ext`` [B, 2] jitters each sample's origin. Returns ``(L_sum, m2_sum,
    iterations)``."""
    B = init_pos.shape[0]
    dev, dtype = init_pos.device, init_pos.dtype
    bounce = _make_bounce_dem(config, medium_row, surface_row, dem, illum_row, B, tris,
                              accel, n_march, n_bisect)

    def origin(keys):
        if ext is None:
            return init_pos
        jit = (origin_uniforms(keys, 2, config.rng, dtype) - 0.5) * ext
        return init_pos + torch.cat([jit, jit.new_zeros(B, 1)], dim=-1)

    s_local = torch.zeros(B, dtype=torch.int64, device=dev)
    depth = torch.zeros(B, dtype=torch.int64, device=dev)
    keys = derive_keys(row_key, lane_first, config.rng)
    pos, d = origin(keys), init_d
    beta = torch.ones(B, dtype=dtype, device=dev)
    L_cur = torch.zeros(B, dtype=dtype, device=dev)
    L_sum = torch.zeros(B, dtype=dtype, device=dev)
    m2_sum = torch.zeros(B, dtype=dtype, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)

    iterations = 0
    while True:
        active = ~done
        L_add, pos2, d2, beta2, alive2 = bounce(depth, pos, d, beta, keys, active)
        L_cur = L_cur + torch.where(active, L_add, 0.0)
        depth = depth + 1
        path_end = active & (~alive2 | (depth >= config.max_depth))

        L_sum = L_sum + torch.where(path_end, L_cur, 0.0)
        m2_sum = m2_sum + torch.where(path_end, L_cur * L_cur, 0.0)
        s_local = s_local + path_end
        done = done | (s_local >= quota)

        regen = path_end & ~done
        keys_new = derive_keys(row_key, lane_first + s_local, config.rng)
        keys = torch.where(regen[:, None], keys_new, keys)
        pos = torch.where(regen[:, None], origin(keys_new), pos2)
        d = torch.where(regen[:, None], init_d, d2)
        beta = torch.where(regen, 1.0, beta2)
        L_cur = torch.where(path_end, 0.0, L_cur)
        depth = torch.where(regen, 0, depth)

        iterations += 1
        if iterations % CHECK_EVERY == 0 and bool(done.all()):
            return L_sum, m2_sum, iterations


def _check_supported(config):
    """Raise ``NotImplementedError`` for what the DEM tracer does not
    render; ``ValueError`` for an unknown surface kind. Like the
    reference's, it renders any sampler as ``independent``, reads no
    constant sky and takes a spot for a sun along its axis."""
    if config.geometry != "plane_parallel":
        raise NotImplementedError(f"geometry {config.geometry!r} for DEM scenes")
    check_kind(config.surface_kind)
    check_phase_kinds(config.phase_kinds)


def row_renderer(scene, dem, sensor, config, tris=None, n_march=128, n_bisect=16, *,
                 device="cuda"):
    """:class:`.tracer.RowRenderer` of a terrain scene (arguments as
    :func:`render_dem`): the scene, the heightfield and the triangles moved
    to ``device``, the triangles' acceleration data built once."""
    _check_supported(config)
    dev = resolve_device(device)
    scene, sensor, config = from_reference(scene, sensor, config, dev)
    dtype = scene.medium.tau_levels.dtype
    dem = DemArrays(*(x.to(dev, dtype) for x in (dem.heights, dem.x0, dem.y0, dem.dx, dem.dy)))
    accel = None
    if tris is not None:
        tris = TriangleMeshArrays(*(x.to(dev, dtype).contiguous()
                                    for x in (tris.v0, tris.e1, tris.e2)))
        accel = tri_accel(tris)
    n_pix = sensor.directions.shape[0]

    def render_row(s, key, n, sample_offset=None, spp_stride=None):
        medium_row, surface_row, illum_row = row_arrays(scene, s)
        lp, pix, _, lane_first, quota = lane_partition(
            n_pix, n, LANES_TARGET[dev.type], dev, spp_stride, sample_offset or 0
        )
        init_pos, init_d, ext = lane_rays(
            medium_row, sensor.directions, sensor.target, sensor.ray_offset,
            sensor.target_extent, pix,
        )
        L_sum, m2, it = trace_paths_dem_regen(
            config, medium_row, surface_row, dem, illum_row, init_pos, init_d, key,
            lane_first, quota, ext=ext, tris=tris, accel=accel, n_march=n_march,
            n_bisect=n_bisect,
        )
        return L_sum.reshape(n_pix, lp).sum(dim=1) / n, m2.reshape(n_pix, lp).sum(dim=1) / n, it

    return RowRenderer(scene.medium.tau_levels.shape[0], n_pix, dtype, dev, False, render_row)


def render_dem(
    scene, dem, sensor, config, spp, seed=0, spp_chunk=None, tris=None, n_march=128,
    n_bisect=16, *, device="cuda",
):
    """Render a 1D atmosphere over a terrain.

    ``scene``/``sensor``/``config`` are a compiled plane-parallel scene, the
    reference's or the port's, moved to ``device`` first; ``dem`` a
    :class:`.dem.DemArrays` (:func:`.scene_state.dem_from_reference`),
    ``tris`` None or the triangulated terrain
    (:func:`.dem.mesh_from_dem`), which then replaces the marcher;
    ``n_march``/``n_bisect`` the marcher's steps. ``spp_chunk`` (default:
    what :data:`DEM_PATHS_PER_DISPATCH` allows) splits the samples into
    chunks with their own keys; the lanes are
    :data:`.tracer_canopy.LANES_TARGET`'s.

    Returns a dict with ``radiance`` [S, N], ``m2`` [S, N], ``spp`` and
    ``iterations`` (bounce iterations, summed over chunks and rows; with
    ``tris`` each launches the nearest-hit sweep once and the any-hit sweep
    twice). The triangles' acceleration data is built once a render.
    """
    rr = row_renderer(scene, dem, sensor, config, tris, n_march, n_bisect, device=device)
    S, n_pix, dev = rr.rows, rr.n_pix, rr.device
    chunks = chunk_plan(spp, spp_chunk, S, n_pix, DEM_PATHS_PER_DISPATCH[dev.type])

    rad_sum = torch.zeros((S, n_pix), dtype=rr.dtype, device=dev)
    m2_sum = torch.zeros((S, n_pix), dtype=rr.dtype, device=dev)
    iterations = 0
    for chunk_id, n in enumerate(chunks):
        for s in range(S):
            rad, m2, it = rr.render(s, row_key(seed, s, chunk_id, dev), n)
            # the chunk's estimate, weighted by its samples, as the reference sums
            rad_sum[s] += rad * n
            m2_sum[s] += m2 * n
            iterations += it
    traced = sum(chunks)
    return {
        "radiance": rad_sum / traced,
        "m2": m2_sum / traced,
        "spp": traced,
        "iterations": iterations,
    }
