"""Wavefront path tracer, plane-parallel geometry.

Port of ``eradiate_tpu/ops/tracer.py``: exact free-flight sampling by
inverting the cumulative vertical optical depth (one collision fetch per
bounce), next-event estimation toward the directional emitter, a uniform sky
collected by escaping paths, and Russian roulette. With ``config.lr_flight``
(the sensitivity renders) the flight is the reference's likelihood-ratio
one: sampled from the detached medium, with weights whose primal is exactly
1, so that the render equals the production one bit for bit. The ``independent``
sampler renders through the regenerative loop (:func:`trace_paths_regen`: a
lane starts its next sample the moment one ends); the structured samplers
(:mod:`.samplers`) through the one-shot loop (:func:`trace_paths`: one sample
a lane, a loop over depth), whose first flight draws the sampler's point set
and whose other dimensions draw Owen-scrambled points, in chunks of the
reference's size.

The reference's ``while_loop`` is an eager Python loop here. Every update in
the loop body is gated by ``active``, ``path_end`` or ``regen`` (one-shot:
``alive``), so a lane whose quota is done is left unchanged by further
iterations; the loop therefore reads ``done`` on the host only every
``check_every`` iterations (one device sync each) without changing the
result.

Random numbers follow the reference bit for bit: threefry row and chunk keys
on the host (:mod:`..core.threefry`), pcg4d (or, with ``config.rng``
``"threefry"``, threefry) per-sample keys and per-bounce uniforms on the
device (:mod:`.fastrng`). Each sample's stream depends only on (seed,
spectral row, pixel, global sample id, depth), so the estimate does not
depend on the lane count.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..core import threefry
from ..core.threefry import bits_t, fold_in_t, uniform_t
from ..core.device import resolve_device
from ..core.warp import square_to_uniform_cone
from ..kernels.leaf_intersect import fma
from .bsdf_ops import bsdf_eval, bsdf_sample_from_uniforms, check_kind, uses_position
from .fastmath import depth_sample, uniform_cone_xla
from .fastrng import bounce_uniforms, derive_keys, origin_uniforms
from .medium import clamp_mu, collision_fetch, tau_at_z
from .samplers import padded_bounce_uniforms, primary_samples
from .phase_ops import (
    check_phase_kinds,
    layer_param_slots,
    ortho_frame,
    phase_eval_at,
    phase_sample_at,
    rebuild_fetched,
)
from .scene_state import (
    IlluminationArrays,
    MediumArrays,
    SurfaceArrays,
    from_reference,
)

__all__ = ["render", "trace_paths", "trace_paths_regen", "lane_partition", "row_arrays",
           "RowRenderer", "row_renderer",
           "row_key", "chunk_plan", "one_shot_chunks", "MAX_PATHS_PER_DISPATCH",
           "CANOPY_PATHS_PER_DISPATCH"]

#: Lane-count target per device type. CPU keeps the reference's 2^14 so that
#: CPU runs decompose like the reference's. On CUDA the eager loop costs
#: about 9 ms of host time per iteration whatever the lane count, so lanes
#: are added until the device time per iteration matches it: 2^21 was the
#: fastest of 2^16..2^23 for c1 on an H100 (PERF.md, "Layers").
REGEN_LANES_TARGET = {"cpu": 2**14, "cuda": 2**21}

#: Minimum samples per lane before extra lanes stop paying (reference
#: ``_QUOTA_FLOOR``).
_QUOTA_FLOOR = 8

#: Loop iterations between host reads of the all-lanes-done flag.
CHECK_EVERY = 16


def _make_bounce(config, medium_row, surface_row, illum_row):
    """Per-bounce transition shared by every lane: returns
    ``bounce(depth, z, tau_here, xy, d, beta, keys, u0_dist=None, ld=None)``
    -> ``(contribution, z', tau', xy', d', beta', alive')``; updates are
    unconditional (the caller masks finished lanes). ``u0_dist`` [B]
    replaces the distance uniform of the first flight (a structured
    sampler's primary dimension); ``ld = (slot, pix_seed)`` draws every
    dimension from Owen-scrambled points (:func:`.samplers.padded_bounce_uniforms`)."""
    z_levels = medium_row.z_levels
    tau_levels = medium_row.tau_levels
    tau_top = tau_levels[-1]
    z_bottom = z_levels[0]
    fused = uses_position(config.surface_kind)

    w_sun = -illum_row.direction  # unit vector toward the sun
    E_sun = illum_row.irradiance
    L_sky = illum_row.sky_radiance
    cos_cutoff = illum_row.cos_cutoff
    t1_sun, t2_sun = ortho_frame(w_sun)
    # float64 path state: the float32 steps on the uniforms round as the
    # jitted reference's (ops/fastmath)
    exact = tau_levels.dtype == torch.float64
    cone = uniform_cone_xla if exact else square_to_uniform_cone

    C = len(config.phase_kinds)
    phase_params = medium_row.phase_params
    param_tables, param_slots = layer_param_slots(config.phase_kinds, phase_params)
    # albedo, blend weights and layer-indexed phase parameters, fetched in
    # one kernel launch per bounce; under the likelihood-ratio flight first
    # the layers' optical thicknesses, attached (their tangent carries the
    # extinction's)
    lr = config.lr_flight
    fetch_tables = torch.stack(
        ([torch.diff(tau_levels)] if lr else [])
        + [medium_row.albedo]
        + [medium_row.phase_weights[c] for c in range(C)]
        + param_tables
    ).contiguous()
    off = 1 if lr else 0
    # the likelihood-ratio flight samples from the detached medium
    tau_levels_s = tau_levels.detach() if lr else tau_levels
    tau_top_s = tau_top.detach() if lr else tau_top

    def bounce(depth, z, tau_here, xy, d, beta, keys, u0_dist=None, ld=None):
        if ld is not None:
            U = padded_bounce_uniforms(ld[0], ld[1], depth)
        else:
            U = bounce_uniforms(keys, depth, 10, config.rng)
        u_dist = U[:, 0]
        u_sun = U[:, 1:3]
        u_ph_sel, u_ph_cos, u_ph_phi = U[:, 3], U[:, 4:6], U[:, 6]
        u_srf = U[:, 7:9]
        u_rr = U[:, 9]

        # cone-sampled directions toward the (possibly finite) sun
        local = cone(u_sun, cos_cutoff)
        w_nee = (
            t1_sun[None, :] * local[:, 0:1]
            + t2_sun[None, :] * local[:, 1:2]
            + w_sun[None, :] * local[:, 2:3]
        )
        mu_nee = clamp_mu(w_nee[:, 2])

        mu = clamp_mu(d[:, 2])
        tau_exit = torch.where(mu > 0.0, (tau_top - tau_here) / mu, tau_here / (-mu))
        if u0_dist is not None:
            u_dist = torch.where(depth == 0, u0_dist, u_dist)
        tau_s = depth_sample(u_dist, exact)
        collide = tau_s < tau_exit

        # ---- volume collision ------------------------------------------
        tau_here_s = tau_here.detach() if lr else tau_here
        tau_new = torch.minimum(torch.clamp(tau_here_s + mu * tau_s, min=0.0), tau_top_s)
        z_col, _, fetched = collision_fetch(tau_new, z_levels, tau_levels_s, fetch_tables)
        albedo_col = fetched[off]
        weights_at = fetched[off + 1 : off + 1 + C].T  # [B, C]
        params_at = rebuild_fetched(config.phase_kinds, param_slots, fetched[off + 1 + C :])
        r_col = r_bnd = None
        if lr:
            # likelihood-ratio flight (reference ops/tracer.py): the
            # collision altitude and the event are the detached medium's;
            # the attached medium re-enters through weights whose primal is
            # exactly 1 (exp(g - g.detach()), g finite) and through tau at
            # the fixed altitude (primal: tau_new + 0)
            tau_att = tau_at_z(z_col, z_levels, tau_levels)
            tau_new = tau_new + (tau_att - tau_att.detach())
            tau_path = torch.abs(tau_new - tau_here) / torch.abs(mu)
            g_col = torch.log(torch.clamp(fetched[0], min=1e-30)) - tau_path
            r_col = torch.exp(g_col - g_col.detach())
            r_bnd = torch.exp(-(tau_exit - tau_exit.detach()))
        s_col = (z_col - z) / mu
        xy_col = advance_xy(xy, d, s_col, fused)

        # NEE: the collision's vertical tau is tau_new, so the sun-path
        # transmittance is closed form
        cos_nee = w_nee[:, 0] * d[:, 0] + w_nee[:, 1] * d[:, 1] + w_nee[:, 2] * d[:, 2]
        p_nee = phase_eval_at(config.phase_kinds, phase_params, weights_at, params_at, cos_nee)
        T_sun_col = torch.exp(-(tau_top - tau_new) / mu_nee)
        beta_w = beta if r_col is None else beta * r_col  # r_col: primal 1
        L_col = beta_w * albedo_col * p_nee * T_sun_col * E_sun
        d_col = phase_sample_at(
            config.phase_kinds, phase_params, weights_at, params_at, d, u_ph_sel, u_ph_cos,
            u_ph_phi,
        )
        beta_col = beta_w * albedo_col

        # ---- surface hit ------------------------------------------------
        hit_surface = (~collide) & (mu < 0.0) & config.has_surface
        s_surf = (z_bottom - z) / mu
        xy_surf = advance_xy(xy, d, s_surf, fused)
        wo = -d
        T_sun_bottom = torch.exp(-tau_top / mu_nee)
        f_nee = bsdf_eval(config.surface_kind, surface_row.params, w_nee, wo, xy_surf)
        beta_b = beta if r_bnd is None else beta * r_bnd  # r_bnd: primal 1
        L_surf = beta_b * f_nee * mu_nee * T_sun_bottom * E_sun
        d_surf, w_surf = bsdf_sample_from_uniforms(
            config.surface_kind, surface_row.params, wo, u_srf, xy_surf
        )
        beta_surf = beta_b * w_surf

        # ---- combine ----------------------------------------------------
        contribution = torch.where(
            collide, L_col, torch.where(hit_surface, L_surf, beta_b * L_sky)
        )
        z2 = torch.where(collide, z_col, z_bottom)
        tau2 = torch.where(collide, tau_new, 0.0)
        xy2 = torch.where(collide[:, None], xy_col, xy_surf)
        d2 = torch.where(collide[:, None], d_col, d_surf)
        beta2 = torch.where(collide, beta_col, torch.where(hit_surface, beta_surf, 0.0))
        alive2 = (collide | hit_surface) & (beta2 > 0.0)

        # ---- Russian roulette ------------------------------------------
        do_rr = depth >= config.rr_depth
        q = torch.clamp(beta2, 0.0, 0.95)
        survive = u_rr < q
        beta2 = torch.where(do_rr & alive2 & survive, beta2 / q, beta2)
        alive2 = alive2 & (survive | ~do_rr)
        return contribution, z2, tau2, xy2, d2, beta2, alive2

    return bounce


def trace_paths_regen(
    config, medium_row, surface_row, illum_row, init_z, init_xy, init_d,
    row_key, lane_first, quota, ext=None, check_every=CHECK_EVERY,
):
    """Regenerative trace: lane ``l`` renders samples ``lane_first[l] ..
    lane_first[l] + quota[l] - 1`` of its pixel.

    ``init_z``/``init_xy``/``init_d`` are per-lane ray anchors, ``row_key``
    the row's chunk key ``[2]``, ``ext`` [B, 2] an optional per-sample
    origin jitter rectangle. Returns ``(L_sum, m2_sum, iterations)``: the
    per-lane sums of sample contributions and of their squares, and the
    number of bounce iterations run.
    """
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    B = init_z.shape[0]
    dev = init_z.device
    bounce = _make_bounce(config, medium_row, surface_row, illum_row)
    tau0 = tau_at_z(init_z, medium_row.z_levels, medium_row.tau_levels)

    def origin_xy(keys):
        if ext is None:
            return init_xy
        u = origin_uniforms(keys, 2, config.rng, init_xy.dtype)
        return init_xy + (u - 0.5) * ext

    s_local = torch.zeros(B, dtype=torch.int64, device=dev)
    depth = torch.zeros(B, dtype=torch.int64, device=dev)
    keys = derive_keys(row_key, lane_first, config.rng)
    z, tau_here, xy, d = init_z, tau0, origin_xy(keys), init_d
    beta = torch.ones_like(init_z)
    L_cur = torch.zeros_like(init_z)
    L_sum = torch.zeros_like(init_z)
    m2_sum = torch.zeros_like(init_z)
    done = torch.zeros(B, dtype=torch.bool, device=dev)

    iterations = 0
    while True:
        contribution, z2, tau2, xy2, d2, beta2, alive2 = bounce(
            depth, z, tau_here, xy, d, beta, keys
        )
        active = ~done
        L_cur = L_cur + torch.where(active, contribution, 0.0)
        depth = depth + 1
        # a path ends on absorption, escape, roulette or the depth cap
        path_end = active & (~alive2 | (depth >= config.max_depth))

        L_sum = L_sum + torch.where(path_end, L_cur, 0.0)
        m2_sum = m2_sum + torch.where(path_end, L_cur * L_cur, 0.0)
        s_local = s_local + path_end
        done = done | (s_local >= quota)

        # regenerate: fresh path for the lane's next sample
        regen = path_end & ~done
        keys_new = derive_keys(row_key, lane_first + s_local, config.rng)
        keys = torch.where(regen[:, None], keys_new, keys)
        z = torch.where(regen, init_z, z2)
        tau_here = torch.where(regen, tau0, tau2)
        xy = torch.where(regen[:, None], origin_xy(keys_new), xy2)
        d = torch.where(regen[:, None], init_d, d2)
        beta = torch.where(regen, 1.0, beta2)
        L_cur = torch.where(path_end, 0.0, L_cur)
        depth = torch.where(regen, 0, depth)

        iterations += 1
        if iterations % check_every == 0 and bool(done.all()):
            return L_sum, m2_sum, iterations


def trace_paths(
    config, medium_row, surface_row, illum_row, init_z, init_xy, init_d, keys,
    u0_dist=None, ld=None, check_every=CHECK_EVERY,
):
    """One-shot trace, one sample a lane: the loop runs over depth until no
    path is alive or ``config.max_depth``. ``u0_dist`` [B] and ``ld`` as in
    :func:`_make_bounce`. Returns ``(L [B], iterations)``: each lane's
    sample contribution and the number of bounce iterations run."""
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    B = init_z.shape[0]
    bounce = _make_bounce(config, medium_row, surface_row, illum_row)
    z, xy, d = init_z, init_xy, init_d
    tau_here = tau_at_z(init_z, medium_row.z_levels, medium_row.tau_levels)
    beta = torch.ones_like(init_z)
    L = torch.zeros_like(init_z)
    alive = torch.ones(B, dtype=torch.bool, device=init_z.device)
    depth = torch.zeros(B, dtype=torch.int64, device=init_z.device)
    iterations = 0
    while iterations < config.max_depth:
        contribution, z, tau_here, xy, d, beta, alive2 = bounce(
            depth, z, tau_here, xy, d, beta, keys, u0_dist, ld
        )
        L = L + torch.where(alive, contribution, 0.0)
        alive = alive & alive2
        depth = depth + 1
        iterations += 1
        # a dead lane adds nothing more, so the host reads the flag rarely
        if iterations % check_every == 0 and not bool(alive.any()):
            break
    return L, iterations


def _lane_plan(n_pix, spp, lanes_target):
    """(lanes_per_pixel, max quota) for the regenerative tracer."""
    lp = max(1, min(spp, lanes_target // max(n_pix, 1)))
    lp = min(lp, max(1, spp // _QUOTA_FLOOR))
    return lp, -(-spp // lp)


def lane_partition(n_pix, spp, lanes_target, device, spp_stride=None, sample_offset=0):
    """Exact-spp lane partition: ``(lp, pix, slot, lane_first, quota)``.

    ``n_pix * lp`` lanes; lane (pixel, slot) renders sample ids
    ``lane_first .. lane_first + quota - 1``, and the ids tile
    ``[pixel * spp, (pixel + 1) * spp)`` exactly (the first ``spp % lp``
    slots take one extra sample).

    The distribution hooks of :mod:`..parallel.render`: ``spp_stride``
    (default ``spp``) is the width of a pixel's *global* sample-id range and
    ``sample_offset`` shifts this rank's ids inside it, so that lane (pixel,
    slot) starts at ``pixel * spp_stride + sample_offset + start`` and the
    ranks of a sample axis together trace the single-device id set.
    """
    lp, _ = _lane_plan(n_pix, spp, lanes_target)
    stride = spp if spp_stride is None else spp_stride
    pix = torch.arange(n_pix, device=device).repeat_interleave(lp)
    slot = torch.arange(lp, device=device).repeat(n_pix)
    q_lo, rem = divmod(spp, lp)
    quota = torch.where(slot < rem, q_lo + 1, q_lo)
    start = torch.where(
        slot < rem, slot * (q_lo + 1), rem * (q_lo + 1) + (slot - rem) * q_lo
    )
    lane_first = pix * stride + start
    if sample_offset:
        lane_first = lane_first + sample_offset
    return lp, pix, slot, lane_first, quota


def advance_xy(xy, d, s, fused):
    """The horizontal position ``xy + d[:, :2] * s`` [B, 2]; ``fused``
    rounds it once, as XLA:CPU contracts it in the reference, so that a
    textured surface (:func:`.bsdf_ops.uses_position`) is looked up where
    the reference's is. Other surfaces ignore the position, and take the
    cheaper rounding."""
    if fused:
        return fma(d[:, :2], s[:, None].expand(-1, 2), xy)
    return xy + d[:, :2] * s[:, None]


def _ray_anchors(medium_row, pix, directions, target, ray_offset, target_extent,
                 fused=False, jitter_key=None):
    """Per-lane ray anchors (init_z, init_xy, init_d, ext): rays start at
    TOA on the line through the target (``[3]``, or ``[N, 3]`` a target a
    pixel), or ``ray_offset`` along it (a camera's origin: 0); ``fused`` as
    :func:`advance_xy`. ``ext`` [B, 2] is the rectangle over which the
    regenerative loop jitters each sample's origin (``target_extent`` [2] or
    [N, 2]). With ``jitter_key`` (the one-shot loop) the target itself is
    jittered once a lane, from ``uniform(fold_in(key, 0x7A19), (B, 2))``,
    and ``ext`` is None."""
    z_top = medium_row.z_levels[-1]
    w_v = directions[pix]
    B = pix.shape[0]
    tgt = target[pix] if target.ndim == 2 else target.expand(B, 3)
    ext = None
    if target_extent is not None:
        ext = target_extent[pix] if target_extent.ndim == 2 else target_extent.expand(B, 2)
    if jitter_key is not None and ext is not None:
        u = uniform_t(fold_in_t(jitter_key, 0x7A19), (B, 2), tgt.dtype)
        tgt = tgt + torch.cat([(u - 0.5) * ext, tgt.new_zeros(B, 1)], dim=-1)
        ext = None
    t_start = torch.where(
        torch.isnan(ray_offset), (z_top - tgt[:, 2]) / clamp_mu(w_v[:, 2]), ray_offset
    )
    init_z = torch.minimum(tgt[:, 2] + w_v[:, 2] * t_start, z_top)
    init_xy = advance_xy(tgt[:, :2], w_v, t_start, fused)
    return init_z, init_xy, -w_v, ext


def _render_row_regen(
    config, n_pix, spp, medium_row, surface_row, illum_row, directions, key,
    target, ray_offset, target_extent, lanes_target, check_every, sample_offset=0,
    spp_stride=None,
):
    """One spectral row: ``n_pix * lp`` lanes x quota samples each, their
    ids placed by :func:`lane_partition`'s ``spp_stride`` and
    ``sample_offset``. Returns (radiance [N], m2 [N], iterations)."""
    lp, pix, _, lane_first, quota = lane_partition(
        n_pix, spp, lanes_target, directions.device, spp_stride, sample_offset
    )
    init_z, init_xy, init_d, ext = _ray_anchors(
        medium_row, pix, directions, target, ray_offset, target_extent,
        uses_position(config.surface_kind),
    )
    L_sum, m2_sum, iterations = trace_paths_regen(
        config, medium_row, surface_row, illum_row, init_z, init_xy, init_d,
        key, lane_first, quota, ext=ext, check_every=check_every,
    )
    radiance = L_sum.reshape(n_pix, lp).sum(dim=1) / spp
    m2 = m2_sum.reshape(n_pix, lp).sum(dim=1) / spp
    return radiance, m2, iterations


def _render_row(
    config, n_pix, spp, medium_row, surface_row, illum_row, directions, key,
    target, ray_offset, target_extent, check_every, sample_offset=None,
    spp_stride=None,
):
    """One spectral row with the one-shot loop (a structured sampler):
    ``n_pix * spp`` lanes, one sample each. Each pixel's primary point set
    comes from the key ``fold_in(fold_in(key, 0x5A17), pixel)``, its
    scramble base from ``bits(fold_in(key, 0x0E11), (n_pix,))``. Returns
    (radiance [N], m2 [N], iterations).

    A sharded render passes ``sample_offset`` and ``spp_stride`` (as
    :func:`lane_partition`): the paths take their global sample ids, and,
    as in the reference, the primary point sets stratify within the rank's
    ``spp`` from a key with the offset folded in, so that sharding keeps the
    estimator in distribution but not the point set."""
    dev = directions.device
    B = n_pix * spp
    stride = spp if spp_stride is None else spp_stride
    pix = torch.arange(n_pix, device=dev).repeat_interleave(spp)
    slot = torch.arange(spp, device=dev).repeat(n_pix)
    if sample_offset is not None:
        slot = slot + sample_offset
    init_z, init_xy, init_d, _ = _ray_anchors(
        medium_row, pix, directions, target, ray_offset, target_extent,
        uses_position(config.surface_kind), jitter_key=key,
    )
    keys = derive_keys(key, pix * stride + slot, config.rng)
    u0 = ld = None
    if config.sampler != "independent":
        k_sampler = fold_in_t(key, 0x5A17)
        if sample_offset is not None:
            k_sampler = fold_in_t(k_sampler, sample_offset)
        pix_keys = fold_in_t(k_sampler.expand(n_pix, 2), torch.arange(n_pix, device=dev))
        u0 = primary_samples(config.sampler, spp, pix_keys).reshape(B).to(init_z.dtype)
        ld = (slot, bits_t(fold_in_t(key, 0x0E11), (n_pix,))[pix])
    L, iterations = trace_paths(
        config, medium_row, surface_row, illum_row, init_z, init_xy, init_d, keys,
        u0_dist=u0, ld=ld, check_every=check_every,
    )
    L = L.reshape(n_pix, spp)
    return L.mean(dim=1), (L * L).mean(dim=1), iterations


#: The reference's words for a spot seen by a distant sensor bank.
SPOT_REFUSAL = (
    "point-source (spot) illumination is supported by the canopy tracer only "
    "— distant radiometer banks cannot see a point source directly; use "
    "CanopyExperiment for lab scenes"
)


def _check_supported(config):
    """Raise ``NotImplementedError`` naming each feature this slice lacks,
    for a spot emitter (with the reference's words) and for a polarized
    config, which has a renderer of its own; ``ValueError`` for an unknown
    surface kind."""
    if config.polarized:
        raise NotImplementedError(
            "the scalar tracer does not render polarized transport: call "
            "ops.tracer_polarized.render_polarized"
        )
    if config.illumination_kind != "directional":
        raise NotImplementedError(SPOT_REFUSAL)
    if config.geometry != "plane_parallel":
        raise NotImplementedError(f"geometry {config.geometry!r} is not ported yet")
    check_kind(config.surface_kind)
    check_phase_kinds(config.phase_kinds)


def _row(x, s):
    """Row ``s`` of a per-spectral-row leaf (scalars are shared)."""
    return x[s] if isinstance(x, torch.Tensor) and x.ndim >= 1 else x


def row_arrays(scene, s):
    """``(medium_row, surface_row, illum_row)``: spectral row ``s`` of a
    plane-parallel scene."""
    med = scene.medium
    il = scene.illumination
    medium_row = MediumArrays(
        z_levels=med.z_levels,
        tau_levels=med.tau_levels[s],
        albedo=med.albedo[s],
        phase_weights=med.phase_weights[s],
        phase_params=tuple({k: v[s] for k, v in p.items()} for p in med.phase_params),
    )
    surface_row = SurfaceArrays(
        params={k: _row(v, s) for k, v in scene.surface.params.items()}
    )
    illum_row = IlluminationArrays(
        direction=il.direction,
        irradiance=il.irradiance[s],
        cos_cutoff=_row(il.cos_cutoff, s),
        sky_radiance=_row(il.sky_radiance, s),
        position=il.position,
    )
    return medium_row, surface_row, illum_row


#: Most paths (spectral rows x pixels x samples) of one dispatch of the
#: reference's renders (its ``MAX_PATHS_PER_DISPATCH``): a render with more
#: splits its samples into chunks (:func:`chunk_plan`), each with its own key.
#: The chunk plan decides the sample set, so where the port keeps this cap
#: its renders follow the reference's stream. The polarized spherical tracer
#: keeps it on every device: the reference chunks that render by itself, and
#: a full-width render on the card is held to it as it is (polarized c4: 16
#: chunks of 262,140 lanes, each drained on its own; one dispatch with a key
#: a lane's chunk is ROADMAP queue 2's follow-up).
MAX_PATHS_PER_DISPATCH = 2**21

#: The canopy tracers' cap per device type. The CPU keeps the reference's
#: canopy cap (``MAX_PATHS_PER_DISPATCH // 8``) so that CPU runs decompose
#: like the reference's and same-seed tests hold; a card takes the whole of
#: config 5 (19 pixels x 2097152 samples) in one dispatch, since its
#: full-width renders are held to the reference by statistics, not by stream.
CANOPY_PATHS_PER_DISPATCH = {"cpu": MAX_PATHS_PER_DISPATCH // 8, "cuda": 2**26}


def chunk_plan(spp, spp_chunk, S, n_pix, cap):
    """Samples of each chunk of a render: ``spp_chunk`` each, by default as
    many as a dispatch of ``cap`` paths allows for ``S`` rows of ``n_pix``
    pixels, the last chunk what remains (the reference's chunking)."""
    if spp_chunk is None:
        max_spp = max(1, cap // max(S * n_pix, 1))
        if spp > max_spp:
            spp_chunk = max_spp
    step = spp_chunk or spp
    return [min(step, spp - start) for start in range(0, spp, step)]


def row_key(seed, s, chunk_id, device):
    """The chunk key ``[2]`` of spectral row ``s``: key(seed) -> fold_in(row)
    -> fold_in(chunk), as the reference's renders derive it."""
    key = threefry.fold_in(threefry.fold_in(threefry.key(seed), s), chunk_id)
    return torch.tensor(key, dtype=torch.int64, device=device)


def one_shot_chunks(spp, spp_chunk, paths):
    """Samples of each chunk of a structured sampler's render, ``paths``
    paths a sample: ``spp_chunk`` each, by default as many as a dispatch of
    :data:`MAX_PATHS_PER_DISPATCH` allows; the chunks are uniform, so the
    budget rounds up to whole chunks (reference ``render``)."""
    if spp_chunk is None:
        spp_chunk = max(1, MAX_PATHS_PER_DISPATCH // max(paths, 1))
    step = min(spp_chunk, spp)
    return [step] * -(-spp // step)


class RowRenderer(NamedTuple):
    """A compiled scene on its device, rendered one spectral row and sample
    chunk at a time: ``render(s, key, n, sample_offset=None,
    spp_stride=None)`` returns row ``s``'s estimate over ``n`` samples
    (``[N]``, or ``[N, 4]`` with ``stokes``), its second moment ``[N]`` and
    its iterations, the samples' ids placed as :func:`lane_partition`'s.
    The single-device renders and the sharded twins
    (:mod:`..parallel.render`) loop over the same rows."""

    rows: int
    n_pix: int
    dtype: torch.dtype
    device: torch.device
    stokes: bool
    render: Callable


def row_renderer(scene, sensor, config, *, device="cuda", lanes_target=None,
                 check_every=CHECK_EVERY):
    """:class:`RowRenderer` of a plane-parallel scene (arguments as
    :func:`render`): the regenerative loop for the ``independent`` sampler,
    the one-shot loop for a structured one."""
    _check_supported(config)
    dev = resolve_device(device)
    scene, sensor, config = from_reference(scene, sensor, config, dev)
    if lanes_target is None:
        lanes_target = REGEN_LANES_TARGET[dev.type]
    n_pix = sensor.directions.shape[0]

    def render_row(s, key, n, sample_offset=None, spp_stride=None):
        medium_row, surface_row, illum_row = row_arrays(scene, s)
        args = (config, n_pix, n, medium_row, surface_row, illum_row, sensor.directions, key,
                sensor.target, sensor.ray_offset, sensor.target_extent)
        if config.sampler == "independent":
            return _render_row_regen(*args, lanes_target, check_every,
                                     sample_offset=sample_offset or 0, spp_stride=spp_stride)
        return _render_row(*args, check_every, sample_offset=sample_offset,
                           spp_stride=spp_stride)

    return RowRenderer(scene.medium.tau_levels.shape[0], n_pix, scene.medium.tau_levels.dtype,
                       dev, False, render_row)


def _render_structured(rr, spp, seed, spp_chunk):
    """:func:`render` for a structured sampler: one-shot chunks."""
    chunks = one_shot_chunks(spp, spp_chunk, rr.rows * rr.n_pix)
    rad = torch.zeros((rr.rows, rr.n_pix), dtype=rr.dtype, device=rr.device)
    m2 = torch.zeros_like(rad)
    iterations = 0
    for chunk_id, n in enumerate(chunks):
        for s in range(rr.rows):
            r, m, it = rr.render(s, row_key(seed, s, chunk_id, rr.device), n)
            rad[s] += r
            m2[s] += m
            iterations += it
    return {"radiance": rad / len(chunks), "m2": m2 / len(chunks), "spp": sum(chunks),
            "iterations": iterations}


def render(
    scene, sensor, config, spp, seed=0, *, device="cuda", lanes_target=None,
    check_every=CHECK_EVERY, spp_chunk=None,
):
    """Render the spectral batch of one distant-sensor bank.

    ``scene``/``sensor``/``config`` are a compiled scene (the reference's or
    the port's, see :func:`~.scene_state.from_reference`); they are moved to
    ``device`` first. ``lanes_target`` (default per device type,
    :data:`REGEN_LANES_TARGET`) sets the lane count and does not change the
    estimate beyond float summation order.

    A structured sampler renders through the one-shot loop in chunks of
    ``MAX_PATHS_PER_DISPATCH // (S * n_pix)`` samples (``spp_chunk``
    overrides it), each with its own key; the budget is rounded up to whole
    chunks and ``spp`` reports what was traced, as in the reference.

    Returns a dict with ``radiance`` [S, N], ``m2`` [S, N] (second moment of
    per-sample contributions), ``spp`` and ``iterations`` (bounce
    iterations, summed over rows and chunks).
    """
    rr = row_renderer(scene, sensor, config, device=device, lanes_target=lanes_target,
                      check_every=check_every)
    if config.sampler != "independent":
        return _render_structured(rr, spp, seed, spp_chunk)

    rads, m2s, iterations = [], [], 0
    for s in range(rr.rows):
        rad, m2, it = rr.render(s, row_key(seed, s, 0, rr.device), spp)
        rads.append(rad)
        m2s.append(m2)
        iterations += it
    return {
        "radiance": torch.stack(rads),
        "m2": torch.stack(m2s),
        "spp": spp,
        "iterations": iterations,
    }
