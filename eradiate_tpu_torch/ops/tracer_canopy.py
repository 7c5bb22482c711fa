"""Regenerative wavefront path tracer for canopy scenes (leaf-disk clouds,
triangle meshes for trunks and mesh trees, a ground and an optional 1D
atmosphere), plane-parallel geometry.

Port of the scalar regenerative path of ``eradiate_tpu/ops/tracer_canopy.py``
(``render_canopy``). One loop iteration resolves the nearest of {medium
collision (closed-form free flight), leaf-disk hit, triangle hit
(nearest-hit sweeps), ground hit, escape}; next-event estimation casts one
shadow ray per lane against the leaves and the triangles and multiplies the
closed-form atmospheric sun transmittance. Leaves and triangles scatter as
bilambertian surfaces, each with its own reflectance and transmittance.
The emitter is the directional sun or a spot (a point source with a top-hat
beam, whose shadow rays end at it); as in the reference, any sampler renders
as ``independent`` and the constant sky is never read. Polarized transport
has a tracer of its own (:mod:`.tracer_canopy_polarized`).

The reference's ``while_loop`` is an eager Python loop here, as in
:mod:`.tracer`: every update is gated by ``active``, ``path_end`` or
``regen``, so the all-lanes-done flag is read on the host only every
``check_every`` iterations. Each iteration launches the leaves' nearest-hit
sweep once and their any-hit sweep once, and with triangles the triangles'
two sweeps as well.

In a double mode the path state, the leaves, the triangles and the sums are
float64 (the leaf and triangle sweeps' float64 builds on the card), as in
the reference under x64;
the uniforms stay float32, and their float32 arithmetic rounds as the
jitted reference's (:mod:`.fastmath`'s depth sample, the bilambertian and
Lambertian directions).

Random numbers follow the reference bit for bit (threefry row and chunk keys
on the host, pcg4d per-sample keys and per-bounce uniforms on the device).
A sample's stream depends on (seed, spectral row, chunk, pixel, sample id
within the chunk, depth): estimates do not depend on the lane count, and
depend on the chunk plan. On the CPU the plan is the reference's
(:data:`.tracer.CANOPY_PATHS_PER_DISPATCH`, :data:`LANES_TARGET`), so
same-seed runs agree with it.
"""

from __future__ import annotations

import torch

from ..core.device import resolve_device
from .bsdf_ops import (
    bilambertian_eval,
    bilambertian_sample_from_uniforms,
    bsdf_eval,
    bsdf_sample_from_uniforms,
    check_kind,
)
from ..kernels.leaf_intersect import fma
from .canopy import leaf_accel, leaf_nearest, leaf_occluded
from .fastmath import depth_sample, sqrt_rn
from .fastrng import bounce_uniforms, derive_keys, origin_uniforms
from .medium import clamp_mu, take_1d, tau_at_z, z_at_tau
from .mesh import tri_accel, tri_nearest, tri_occluded
from .phase_ops import (
    check_phase_kinds,
    layer_param_slots,
    ortho_frame,
    phase_eval_at,
    phase_sample_at,
    rebuild_fetched,
)
from .scene_state import canopy_from_reference, from_reference, scene_dtype
from .tracer import (
    CANOPY_PATHS_PER_DISPATCH,
    CHECK_EVERY,
    RowRenderer,
    chunk_plan,
    lane_partition,
    row_arrays,
    row_key,
)

__all__ = ["render_canopy", "trace_paths_canopy_regen", "lane_rays", "row_renderer",
           "canopy_row_renderer", "canopy_sums"]

#: Bounces between spatial lane sorts in the regenerative loop (0 = off).
#: Sorting lanes by the Morton code of their position makes the rays of a
#: thread block spatially coherent, which is what lets the sweep kernels'
#: per-group sphere culls skip groups for a whole block.
CANOPY_SORT_EVERY = 1

#: Lane-count target per device type: the reference's 2^14 on the CPU; on
#: CUDA the count that was fastest for config 5 on an H100 (PERF.md,
#: "Layers").
LANES_TARGET = {"cpu": 2**14, "cuda": 2**21}


def _step(pos, d, t):
    """``pos + d t`` for per-lane distances ``t`` [B, 1], one fused
    multiply-add per component as XLA:CPU contracts it: a continuing ray
    leaves a leaf at 1e-6 km along its new direction, so at grazing angles
    rounding decides whether it meets that leaf again, and the port rounds
    as the reference does."""
    return fma(d, t, pos)


def _to_world(n, v):
    t1, t2 = ortho_frame(n)
    return t1 * v[..., 0:1] + t2 * v[..., 1:2] + n * v[..., 2:3]


def _to_local(n, v):
    t1, t2 = ortho_frame(n)
    return torch.stack([(t1 * v).sum(-1), (t2 * v).sum(-1), (n * v).sum(-1)], dim=-1)


def _canopy_helpers(config, medium_row, leaves, illum_row, B, tris=None):
    """Shared closures (medium tau, emitter NEE terms) and the sweeps'
    acceleration data (leaves and, with ``tris``, triangles), computed once
    per render for ``B`` lanes.

    ``nee_dir(pos)`` is the direction toward the emitter [B, 3] and
    ``nee_at(pos)`` its next-event terms at vertex positions [B, 3]:
    ``(w_nee, E)``, the direction and the irradiance reaching the vertex,
    visibility and transmittance included. The sun's shadow rays run 1e6 km;
    a spot's (``config.illumination_kind == "spot"``) end at the emitter, and
    its irradiance is the intensity over r^2 (1e-6 / r^2 from km to m) inside
    its top-hat beam, times the finite segment's transmittance through the
    1D medium (reference ``ops/tracer_canopy.py`` ``nee_at``)."""
    z_levels = medium_row.z_levels
    tau_levels = medium_row.tau_levels
    tau_top = tau_levels[-1]
    z_bottom, z_top = z_levels[0], z_levels[-1]
    dev, dtype = z_levels.device, z_levels.dtype
    accel = leaf_accel(leaves)
    tris_accel = None if tris is None else tri_accel(tris)

    def tau_z(z):
        return tau_at_z(z, z_levels, tau_levels)

    def occluded(pos, w, t_max):
        occ = leaf_occluded(pos, w, t_max, leaves, accel)
        if tris is not None:
            occ = occ | tri_occluded(pos, w, t_max, tris, tris_accel)
        return occ

    if config.illumination_kind == "spot":
        position, axis = illum_row.position, illum_row.direction
        tau_spot = tau_z(torch.clamp(position[2], z_bottom, z_top).reshape(1))

        def nee_dir(pos):
            v = position - pos
            return v / torch.clamp(_norm(v), min=1e-9)[:, None]

        def nee_at(pos):
            v = position - pos
            r = _norm(v)
            w_nee = (v / torch.clamp(r, min=1e-9)[:, None]).contiguous()
            in_beam = (-w_nee * axis).sum(-1) >= illum_row.cos_cutoff
            dtau = torch.abs(tau_spot - tau_z(pos[:, 2].contiguous()))
            T_atm = torch.exp(-dtau / torch.clamp(torch.abs(w_nee[:, 2]), min=1e-6))
            occ = occluded(pos, w_nee, r)
            E = illum_row.irradiance * 1e-6 / torch.clamp(r * r, min=1e-12)
            return w_nee, torch.where(in_beam & ~occ, E * T_atm, 0.0)
    else:
        mu_sun = clamp_mu(-illum_row.direction[2])
        w_sun = (-illum_row.direction).expand(B, 3).contiguous()
        far = torch.full((B,), 1e6, dtype=dtype, device=dev)

        def nee_dir(pos):
            return w_sun

        def nee_at(pos):
            T_atm = torch.exp(-(tau_top - tau_z(pos[:, 2].contiguous())) / mu_sun)
            occ = occluded(pos, w_sun, far)
            return w_sun, T_atm * torch.where(occ, 0.0, 1.0) * illum_row.irradiance

    return {"tau_z": tau_z, "nee_dir": nee_dir, "nee_at": nee_at, "accel": accel,
            "tris_accel": tris_accel}


def _norm(v):
    """Euclidean norms [B] of vectors [B, 3], the root correctly rounded on
    every device."""
    return sqrt_rn((v * v).sum(-1))


def _make_bounce_canopy(config, medium_row, surface_row, leaf_row, leaves, helpers, B,
                        tris=None, tri_row=None, eps=1e-6):
    """Per-bounce transition shared by every lane: returns ``bounce(depth,
    pos, d, beta, keys) -> (L_add, pos', d', beta', alive')``; updates are
    unconditional (the caller masks finished lanes). ``tris`` and
    ``tri_row`` are the triangle geometry and its optics row, if any."""
    z_levels = medium_row.z_levels
    tau_levels = medium_row.tau_levels
    tau_top = tau_levels[-1]
    z_bottom = z_levels[0]
    z_top = z_levels[-1]
    tau_z, nee_dir, nee_at = helpers["tau_z"], helpers["nee_dir"], helpers["nee_at"]
    accel, tris_accel = helpers["accel"], helpers["tris_accel"]

    dev, dtype = z_levels.device, z_levels.dtype
    ground_lift = torch.tensor([0.0, 0.0, eps], dtype=dtype, device=dev)

    C = len(config.phase_kinds)
    phase_params = medium_row.phase_params
    param_tables, param_slots = layer_param_slots(config.phase_kinds, phase_params)
    fetch_tables = torch.stack(
        [medium_row.phase_weights[c] for c in range(C)] + param_tables
    )

    def bounce(depth_b, pos, d, beta, keys):
        U = bounce_uniforms(keys, depth_b, 8, config.rng)
        u_dist = U[:, 0]
        u_sel, u_cos, u_phi = U[:, 1], U[:, 2:4], U[:, 4]
        u_srf = U[:, 5:7]
        u_rr = U[:, 7]

        z = pos[:, 2].contiguous()
        mu = clamp_mu(d[:, 2])
        tau_here = tau_z(z)
        tau_exit = torch.where(mu > 0.0, (tau_top - tau_here) / mu, tau_here / (-mu))
        tau_s = depth_sample(u_dist, exact=dtype == torch.float64)
        collide_med = tau_s < tau_exit

        tau_new = torch.minimum(torch.clamp(tau_here + mu * tau_s, min=0.0), tau_top)
        z_med, layer = z_at_tau(tau_new, z_levels, tau_levels)
        z_edge = torch.where(mu > 0.0, z_top, z_bottom)
        t_med = torch.where(collide_med, (z_med - z) / mu, (z_edge - z) / mu)

        # nearest scatterer (leaf disk or mesh triangle) within the segment
        t_leaf, n_leaf, hit_leaf = leaf_nearest(pos, d, t_med, leaves, accel)
        optics = leaf_row
        if tris is not None:
            t_tri, n_tri, hit_tri = tri_nearest(pos, d, t_med, tris, tris_accel)
            tri_first = hit_tri & (~hit_leaf | (t_tri < t_leaf))
            hit_leaf = hit_leaf | hit_tri
            t_leaf = torch.where(tri_first, t_tri, t_leaf)
            n_leaf = torch.where(tri_first[:, None], n_tri, n_leaf)
            # per-lane optics: bilambertian either way (trunks have zero
            # transmittance through their tri_row values)
            optics = {k: torch.where(tri_first, tri_row[k], leaf_row[k])
                      for k in ("reflectance", "transmittance")}

        event_leaf = hit_leaf
        event_med = collide_med & ~hit_leaf
        event_ground = (~collide_med) & ~hit_leaf & (mu < 0.0) & config.has_surface

        # ---- positions --------------------------------------------------
        # XLA:CPU fuses this step in the graph without triangles and leaves
        # it a separate product and sum in the graph with them; from the top
        # of the atmosphere the two differ by half an ulp of ~100 km, which
        # decides on which side of a trunk's wall the hit point lands. Over
        # 60 pixel-seeds of a 3 x 3 trunk forest 12 pixels leave the
        # reference's path with the fused step and 2 with the unfused one.
        # The float64 graph with triangles (x64) keeps the float32 graph's
        # form here: its half ulp, ~7e-12 km, showed in no lane either way
        # (1280 lanes of the small c5_trees, 6 x 40 of the forest: every
        # lane sum within 4e-16 of the reference's with either step)
        if tris is None:
            pos_leaf = _step(pos, d, t_leaf[:, None])
        else:
            pos_leaf = pos + d * t_leaf[:, None]
        pos_med = _step(pos, d, t_med[:, None])
        t_ground = (z_bottom - z) / mu
        pos_ground = _step(pos, d, t_ground[:, None])
        pos_ground = torch.cat([pos_ground[:, :2], z_bottom.expand(B, 1)], dim=1)

        # ---- shared NEE -------------------------------------------------
        # one occlusion sweep per bounce: each lane evaluates NEE only at
        # its own event vertex. Leaf frame oriented toward the incident side
        to_front = -torch.sign((d * n_leaf).sum(-1))
        n_shade = n_leaf * to_front[:, None]
        # the emitter's side of the leaf: the spot's direction from the hit
        # (it barely turns over the lift-off), the sun's everywhere
        wi_leaf_sign = torch.sign((n_shade * nee_dir(pos_leaf)).sum(-1))[:, None]
        # distance-scaled lift-off: pos + t d at t ~ 100 km rounds by
        # ~ulp(t) ~ 1e-5 km in float32, so the hit can land below the disk
        # or triangle it hit, and a fixed 1e-6 offset would leave the shadow
        # origin occluded by its own surface (a trunk's cap seen from above
        # went black). 2.4e-7 = 2 float32 ulp.
        eps_lane = (eps + t_leaf * 2.4e-7)[:, None]
        pos_leaf_off = _step(pos_leaf, n_shade * wi_leaf_sign, eps_lane)
        pos_ground_off = pos_ground + ground_lift
        pos_nee = torch.where(
            event_leaf[:, None],
            pos_leaf_off,
            torch.where(event_med[:, None], pos_med, pos_ground_off),
        )
        w_nee, E_nee = nee_at(pos_nee)

        # ---- medium collision -------------------------------------------
        albedo_col = take_1d(medium_row.albedo, layer)
        fetched = fetch_tables[:, layer]
        weights_at = fetched[:C].T
        params_at = rebuild_fetched(config.phase_kinds, param_slots, fetched[C:])
        cos_nee = (w_nee * d).sum(-1)
        p_nee = phase_eval_at(config.phase_kinds, phase_params, weights_at, params_at, cos_nee)
        L_med = beta * albedo_col * p_nee * E_nee
        d_med = phase_sample_at(
            config.phase_kinds, phase_params, weights_at, params_at, d, u_sel, u_cos, u_phi
        )
        beta_med = beta * albedo_col

        # ---- leaf or triangle interaction (bilambertian) ----------------
        wo_leaf = _to_local(n_shade, -d)
        wi_sun_leaf = _to_local(n_shade, w_nee)
        f_leaf = bilambertian_eval(optics, wi_sun_leaf, wo_leaf)
        cos_sun_leaf = torch.abs((n_shade * w_nee).sum(-1))
        # E_nee was evaluated at pos_leaf_off (the shadow origin slightly off
        # the leaf on the emitter's side) for event_leaf lanes
        L_leaf = beta * f_leaf * cos_sun_leaf * E_nee
        # leaf sampling reuses the phase uniform slots (exclusive branches)
        d_leaf_local, w_leaf = bilambertian_sample_from_uniforms(
            optics, wo_leaf, u_sel, u_cos
        )
        d_leaf = _to_world(n_shade, d_leaf_local)
        beta_leaf = beta * w_leaf
        pos_leaf_new = _step(pos_leaf, d_leaf, eps_lane)

        # ---- ground -----------------------------------------------------
        wo = -d
        xy_ground = pos_ground[:, :2]
        f_g = bsdf_eval(config.surface_kind, surface_row.params, w_nee, wo, xy_ground)
        mu_nee_g = torch.clamp(w_nee[:, 2], min=0.0)
        L_ground = beta * f_g * mu_nee_g * E_nee
        d_ground, w_g = bsdf_sample_from_uniforms(
            config.surface_kind, surface_row.params, wo, u_srf, xy_ground
        )
        beta_ground = beta * w_g

        # ---- combine ----------------------------------------------------
        L_add = torch.where(
            event_leaf, L_leaf,
            torch.where(event_med, L_med, torch.where(event_ground, L_ground, 0.0)),
        )
        pos2 = torch.where(
            event_leaf[:, None], pos_leaf_new,
            torch.where(event_med[:, None], pos_med, pos_ground),
        )
        d2 = torch.where(
            event_leaf[:, None], d_leaf, torch.where(event_med[:, None], d_med, d_ground)
        )
        beta2 = torch.where(
            event_leaf, beta_leaf,
            torch.where(event_med, beta_med, torch.where(event_ground, beta_ground, 0.0)),
        )
        alive2 = (event_leaf | event_med | event_ground) & (beta2 > 0.0)

        do_rr = depth_b >= config.rr_depth
        q = torch.clamp(beta2, 0.0, 0.95)
        survive = u_rr < q
        beta2 = torch.where(do_rr & alive2 & survive, beta2 / q, beta2)
        alive2 = alive2 & (survive | ~do_rr)
        return L_add, pos2, d2, beta2, alive2

    return bounce


def _morton_u32(pos, lo, hi):
    """7-bit/axis Morton code (int64 tensor) of positions [B, 3] within
    [lo, hi]."""
    span = torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((pos - lo) / span * 127.0, 0.0, 127.0).to(torch.int64)
    code = torch.zeros(pos.shape[0], dtype=torch.int64, device=pos.device)
    for b in range(7):
        for ax in range(3):
            code = code | (((q[:, ax] >> b) & 1) << (3 * b + ax))
    return code


def trace_paths_canopy_regen(
    config, medium_row, surface_row, leaf_row, leaves, illum_row, init_pos, init_d,
    row_key, lane_first, quota, ext=None, sort_every=CANOPY_SORT_EVERY,
    check_every=CHECK_EVERY, tris=None, tri_row=None,
):
    """Regenerative canopy trace (see :func:`.tracer.trace_paths_regen`):
    lanes re-seed a fresh (pixel, sample) path on death; ``ext`` [B, 2]
    jitters the xy origin per sample (footprint rectangle targets);
    ``tris``/``tri_row`` add a triangle mesh and its optics row. Returns
    ``(L_sum, m2_sum, iterations)`` per lane, in the caller's lane order.

    With ``sort_every`` > 0 the loop permutes all lane state by the Morton
    code of the current position every ``sort_every`` iterations (done lanes
    are parked at TOA pointing up and sorted to the end: they miss the
    canopy's box and sweep nothing). Keys and sums travel with their lane,
    so per-sample paths and per-lane sums are those of the unsorted loop.
    """
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    B = init_pos.shape[0]
    dev, dtype = init_pos.device, init_pos.dtype
    helpers = _canopy_helpers(config, medium_row, leaves, illum_row, B, tris)
    bounce = _make_bounce_canopy(
        config, medium_row, surface_row, leaf_row, leaves, helpers, B, tris, tri_row
    )
    z_top = medium_row.z_levels[-1]
    _, box_lo, box_hi = helpers["accel"]
    park = torch.stack([z_top.new_zeros(()), z_top.new_zeros(()), z_top]).expand(B, 3)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev).expand(B, 3)

    def origin(keys, init_pos_l, ext_l):
        if ext is None:
            return init_pos_l
        jit = (origin_uniforms(keys, 2, config.rng, dtype) - 0.5) * ext_l
        return init_pos_l + torch.cat([jit, jit.new_zeros(B, 1)], dim=-1)

    ext_l = torch.zeros((B, 2), dtype=dtype, device=dev) if ext is None else ext
    quota_l = torch.as_tensor(quota, device=dev).expand(B)
    lane_first_l, init_pos_l, init_d_l = lane_first, init_pos, init_d
    s_local = torch.zeros(B, dtype=torch.int64, device=dev)
    depth = torch.zeros(B, dtype=torch.int64, device=dev)
    keys = derive_keys(row_key, lane_first, config.rng)
    pos, d = origin(keys, init_pos, ext_l), init_d
    beta = torch.ones(B, dtype=dtype, device=dev)
    L_cur = torch.zeros(B, dtype=dtype, device=dev)
    L_sum = torch.zeros(B, dtype=dtype, device=dev)
    m2_sum = torch.zeros(B, dtype=dtype, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    orig = torch.arange(B, device=dev)

    iterations = 0
    while True:
        L_add, pos2, d2, beta2, alive2 = bounce(depth, pos, d, beta, keys)
        active = ~done
        L_cur = L_cur + torch.where(active, L_add, 0.0)
        depth = depth + 1
        path_end = active & (~alive2 | (depth >= config.max_depth))

        L_sum = L_sum + torch.where(path_end, L_cur, 0.0)
        m2_sum = m2_sum + torch.where(path_end, L_cur * L_cur, 0.0)
        s_local = s_local + path_end
        done = done | (s_local >= quota_l)

        # regenerate: a fresh path, with its own origin jitter, for the
        # lane's next sample
        regen = path_end & ~done
        keys_new = derive_keys(row_key, lane_first_l + s_local, config.rng)
        keys = torch.where(regen[:, None], keys_new, keys)
        pos = torch.where(regen[:, None], origin(keys_new, init_pos_l, ext_l), pos2)
        d = torch.where(regen[:, None], init_d_l, d2)
        beta = torch.where(regen, 1.0, beta2)
        L_cur = torch.where(path_end, 0.0, L_cur)
        depth = torch.where(regen, 0, depth)

        # park done lanes at TOA pointing up: valid geometry that misses the
        # canopy's box
        pos = torch.where(done[:, None], park, pos)
        d = torch.where(done[:, None], up, d)

        if sort_every > 0 and iterations % sort_every == sort_every - 1:
            code = _morton_u32(pos, box_lo, box_hi)
            code = torch.where(done, 0xFFFFFFFF, code)  # done lanes to the end
            order = torch.argsort(code, stable=True)
            (s_local, depth, pos, d, beta, L_cur, keys, done, L_sum, m2_sum,
             lane_first_l, quota_l, init_pos_l, init_d_l, ext_l, orig) = (
                x[order]
                for x in (s_local, depth, pos, d, beta, L_cur, keys, done, L_sum,
                          m2_sum, lane_first_l, quota_l, init_pos_l, init_d_l, ext_l,
                          orig)
            )

        iterations += 1
        if iterations % check_every == 0 and bool(done.all()):
            break

    # undo the in-loop permutations: scatter the sums back to the caller's lanes
    L_out = torch.zeros_like(L_sum)
    m2_out = torch.zeros_like(m2_sum)
    L_out[orig] = L_sum
    m2_out[orig] = m2_sum
    return L_out, m2_out, iterations


def lane_rays(medium_row, directions, target, ray_offset, target_extent, pix):
    """Per-lane ``(init_pos [B, 3], init_d [B, 3], ext [B, 2] or None)``: rays
    start at TOA on the line through the target (``ray_offset`` NaN) or at
    ``target + ray_offset * w_v``; ``ext`` jitters each sample's origin over
    the footprint rectangle."""
    B = pix.shape[0]
    z_top = medium_row.z_levels[-1]
    w_v = directions[pix]
    tgt = target[pix] if target.ndim == 2 else target.expand(B, 3)
    ext = None
    if target_extent is not None:
        ext = target_extent[pix] if target_extent.ndim == 2 else target_extent.expand(B, 2)
    t_up = torch.where(
        torch.isnan(ray_offset),
        (z_top - tgt[:, 2]) / torch.clamp(w_v[:, 2], min=1e-6),
        ray_offset,
    )
    return tgt + w_v * t_up[:, None], -w_v, ext


def _render_row_canopy(
    config, n_pix, spp, medium_row, surface_row, leaf_row, leaves, illum_row, sensor,
    key, lanes_target, sort_every, check_every, tris=None, tri_row=None, sample_offset=0,
    spp_stride=None,
):
    """One spectral row of one chunk, its sample ids placed as
    :func:`.tracer.lane_partition`'s: returns (radiance [N], m2 [N],
    iterations)."""
    lp, pix, _, lane_first, quota = lane_partition(
        n_pix, spp, lanes_target, sensor.directions.device, spp_stride, sample_offset
    )
    init_pos, init_d, ext = lane_rays(
        medium_row, sensor.directions, sensor.target, sensor.ray_offset,
        sensor.target_extent, pix,
    )
    L_sum, m2_sum, iterations = trace_paths_canopy_regen(
        config, medium_row, surface_row, leaf_row, leaves, illum_row, init_pos, init_d,
        key, lane_first, quota, ext=ext, sort_every=sort_every, check_every=check_every,
        tris=tris, tri_row=tri_row,
    )
    radiance = L_sum.reshape(n_pix, lp).sum(dim=1) / spp
    m2 = m2_sum.reshape(n_pix, lp).sum(dim=1) / spp
    return radiance, m2, iterations


def _check_supported(config):
    """Raise ``NotImplementedError`` naming each feature this slice lacks,
    and for a polarized config, which has a renderer of its own;
    ``ValueError`` for an unknown surface kind. ``config.lr_flight`` changes
    nothing here, as in the reference: the canopy tracers have no
    likelihood-ratio flight, and the sensitivities refuse their extinction
    channels."""
    if config.polarized:
        raise NotImplementedError(
            "the scalar canopy tracer does not render polarized transport: call "
            "ops.tracer_canopy_polarized.render_canopy_polarized"
        )
    if config.geometry != "plane_parallel":
        raise NotImplementedError(
            f"geometry {config.geometry!r} for canopy scenes is not ported yet"
        )
    check_kind(config.surface_kind)
    check_phase_kinds(config.phase_kinds)


def canopy_row_renderer(row_fn, stokes, scene, leaf_params, leaves, sensor, config, tris,
                        tri_params, device, lanes_target, sort_every, check_every):
    """:class:`.tracer.RowRenderer` of a canopy scene through ``row_fn``
    (:func:`_render_row_canopy` or its polarized twin): the scene, the
    leaves, the triangles and their optics moved to ``device``, each row's
    optics taken from ``leaf_params``/``tri_params``."""
    dev = resolve_device(device)
    dt = scene_dtype(scene.medium)
    scene, sensor, config = from_reference(scene, sensor, config, dev)
    leaves, leaf_params, tris, tri_params = canopy_from_reference(
        leaves, leaf_params, dev, tris, tri_params, dt
    )
    if lanes_target is None:
        lanes_target = LANES_TARGET[dev.type]
    n_pix = sensor.directions.shape[0]

    def render_row(s, key, n, sample_offset=None, spp_stride=None):
        medium_row, surface_row, illum_row = row_arrays(scene, s)
        leaf_row = {k: v[s] for k, v in leaf_params.items()}
        tri_row = None if tri_params is None else {k: v[s] for k, v in tri_params.items()}
        return row_fn(
            config, n_pix, n, medium_row, surface_row, leaf_row, leaves, illum_row, sensor,
            key, lanes_target, sort_every, check_every, tris, tri_row, sample_offset or 0,
            spp_stride,
        )

    # float64 in a double mode, as the reference's sums
    return RowRenderer(scene.medium.tau_levels.shape[0], n_pix, scene.medium.tau_levels.dtype,
                       dev, stokes, render_row)


def row_renderer(scene, leaf_params, leaves, sensor, config, tris=None, tri_params=None, *,
                 device="cuda", lanes_target=None, sort_every=CANOPY_SORT_EVERY,
                 check_every=CHECK_EVERY):
    """:class:`.tracer.RowRenderer` of a canopy scene (arguments as
    :func:`render_canopy`)."""
    _check_supported(config)
    return canopy_row_renderer(_render_row_canopy, False, scene, leaf_params, leaves, sensor,
                               config, tris, tri_params, device, lanes_target, sort_every,
                               check_every)


def canopy_sums(rr, spp, seed, spp_chunk):
    """The single-device canopy loop over :func:`.tracer.chunk_plan`'s chunks
    of :data:`.tracer.CANOPY_PATHS_PER_DISPATCH` paths: ``(sum, m2_sum,
    traced, iterations)``, each chunk's estimate weighted by its samples as
    the reference sums them, ``key`` of chunk ``c`` of row ``s``
    ``fold_in(fold_in(key(seed), s), c)``."""
    chunks = chunk_plan(spp, spp_chunk, rr.rows, rr.n_pix,
                        CANOPY_PATHS_PER_DISPATCH[rr.device.type])
    lead = (rr.rows, rr.n_pix, 4) if rr.stokes else (rr.rows, rr.n_pix)
    a_sum = torch.zeros(lead, dtype=rr.dtype, device=rr.device)
    m2_sum = torch.zeros((rr.rows, rr.n_pix), dtype=rr.dtype, device=rr.device)
    iterations = 0
    for chunk_id, n in enumerate(chunks):
        for s in range(rr.rows):
            a, m2, it = rr.render(s, row_key(seed, s, chunk_id, rr.device), n)
            a_sum[s] += a * n
            m2_sum[s] += m2 * n
            iterations += it
    return a_sum, m2_sum, sum(chunks), iterations


def render_canopy(
    scene, leaf_params, leaves, sensor, config, spp, seed=0, spp_chunk=None,
    tris=None, tri_params=None, *, device="cuda", lanes_target=None,
    sort_every=CANOPY_SORT_EVERY, check_every=CHECK_EVERY,
):
    """Render a canopy (+ optional atmosphere) scene.

    ``scene``/``sensor``/``config`` are a compiled scene (the medium may be
    zero-extinction for pure canopy scenes), ``leaves`` a flat or instanced
    leaf cloud and ``leaf_params`` ``{"reflectance": [S], "transmittance":
    [S]}``, ``tris`` None or a flat or instanced triangle mesh (trunks, mesh
    trees) with its optics ``tri_params``, the reference's or the port's; all
    are moved to ``device`` first. ``spp_chunk`` (default: what
    :data:`.tracer.CANOPY_PATHS_PER_DISPATCH` allows)
    splits the samples into chunks with their own keys and so changes the
    sample set; ``lanes_target`` (default :data:`LANES_TARGET`) and
    ``sort_every`` change only the float summation order.

    Returns a dict with ``radiance`` [S, N], ``m2`` [S, N], ``spp`` and
    ``iterations`` (bounce iterations, summed over chunks and rows; each
    launches the nearest-hit and the any-hit sweep of the leaves once and,
    with ``tris``, those of the triangles).
    """
    rr = row_renderer(scene, leaf_params, leaves, sensor, config, tris, tri_params,
                      device=device, lanes_target=lanes_target, sort_every=sort_every,
                      check_every=check_every)
    rad_sum, m2_sum, traced, iterations = canopy_sums(rr, spp, seed, spp_chunk)
    return {
        "radiance": rad_sum / traced,
        "m2": m2_sum / traced,
        "spp": traced,
        "iterations": iterations,
    }



