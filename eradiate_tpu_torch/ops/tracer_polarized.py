"""Regenerative wavefront path tracer with polarized (Stokes/Mueller)
transport, plane-parallel geometry.

Port of ``eradiate_tpu/ops/tracer_polarized.py`` (``render_polarized``).
Backward tracing accumulates the left Mueller product

    P_k = M_1 R_1 ... M_{k-1}            (4x4 per lane)

so that every next-event connection adds ``P_k R M_phase(theta) S_sun``
with ``S_sun = E [1, 0, 0, 0]`` (unpolarized sun). Directions are sampled
from the scalar phase function and the Mueller weight divides by its pdf,
which keeps every Stokes component unbiased. Each lane carries the
reference basis ``b`` of its current light segment; scattering frames use
the in-plane ("parallel") convention of :func:`.mueller.rayleigh_mueller`;
the output Stokes vectors are referenced to the viewing direction's
meridian basis.

As in the reference, the sun is an ideal directional emitter here (no cone
sampling), an escaping path adds nothing (no sky term), and the per-bounce
uniform slots are those of the scalar tracer, so a scalar and a polarized
run with one seed trace the same paths. Each collision is resolved by the
collision fetch (:func:`.medium.collision_fetch`: K1 on the card, its plain
twin on the CPU), which also fetches the layer's albedo, phase weights and
Rayleigh depolarization; a ``tab_polarized`` component (an aerosol) reads
its phase matrix from its spectral row's tables, not from the fetch. The eager loop, its host ``done`` check every
``check_every`` iterations and the random streams are those of
:mod:`.tracer`; the 4x4 products are :mod:`.mueller`'s fixed-order sums.
"""

from __future__ import annotations

import torch

from ..core.device import resolve_device
from .bsdf_ops import bsdf_sample_from_uniforms, check_kind, uses_position
from .bsdf_polarized import surface_mueller
from .fastmath import depth_sample
from .fastrng import bounce_uniforms, derive_keys
from .medium import clamp_mu, collision_fetch, tau_at_z
from .mueller import (
    cross,
    default_basis,
    dot,
    matmul4,
    matvec4,
    norm,
    rotate_basis_angle,
    rotator,
)
from .phase_ops import (
    check_phase_kinds,
    layer_param_slots,
    ortho_frame,
    phase_eval_at,
    phase_mueller_at,
    phase_sample_at,
    rebuild_fetched,
)
from .scene_state import from_reference
from .tracer import (
    CHECK_EVERY,
    REGEN_LANES_TARGET,
    RowRenderer,
    advance_xy,
    lane_partition,
    row_arrays,
    row_key,
)

__all__ = [
    "render_polarized",
    "row_renderer",
    "trace_paths_polarized_regen",
    "scatter_frames",
    "basis_rotator",
    "phase_vertex",
    "surface_vertex",
    "roulette",
]


def scatter_frames(l_in, l_out):
    """In-plane bases ``(h_in, h_out)`` of the scattering plane spanned by
    the light propagation directions ``l_in -> l_out`` [B, 3]; where
    ``|l_in x l_out| <= 1e-7`` (forward and backward scattering) the plane's
    normal is an arbitrary perpendicular of ``l_in`` (reference
    ``_scatter_frames``)."""
    n = cross(l_in, l_out)
    nn = norm(n)[:, None]
    t1, _ = ortho_frame(l_in)
    n = torch.where(nn > 1e-7, n / torch.clamp(nn, min=1e-12), t1)
    h_in = cross(n, l_in)
    h_in = h_in / torch.clamp(norm(h_in)[:, None], min=1e-12)
    h_out = cross(n, l_out)
    h_out = h_out / torch.clamp(norm(h_out)[:, None], min=1e-12)
    return h_in, h_out


def unpolarized(value):
    """Stokes vectors ``[B, 4]`` of unpolarized light of intensity
    ``value`` [B]."""
    z = torch.zeros_like(value)
    return torch.stack([value, z, z, z], dim=-1)


def basis_rotator(l_in, l_out, b):
    """``(h_in, R)``: the in-plane basis of ``l_in`` in the scattering plane
    of the light propagation directions ``l_in -> l_out`` [B, 3], and the
    rotator that turns the carried basis ``b`` of ``l_out`` into the plane's
    basis of ``l_out``."""
    h_in, h_out = scatter_frames(l_in, l_out)
    return h_in, rotator(rotate_basis_angle(l_out, h_out, b))


def phase_vertex(
    kinds, phase_params, weights_at, params_at, P, b, d, l_sun, R_sun, S_sun, u_sel, u_cos,
    u_phi,
):
    """The Mueller vertex of a volume collision, shared by the polarized
    tracers: the sun's next-event Stokes vector ``P R_sun M(l_sun . l_out)
    S_sun`` (``l_out = -d``; ``R_sun`` from :func:`basis_rotator` of
    ``l_sun``) and the continuation sampled from the scalar phase function,
    whose Mueller matrix divides by that pdf. Returns ``(S_nee, d_new,
    P_new, b_new)``."""
    l_out = -d
    cos_nee = dot(l_sun, l_out)
    M_nee = phase_mueller_at(kinds, phase_params, weights_at, params_at, cos_nee)
    S_nee = matvec4(P, matvec4(R_sun, matvec4(M_nee, S_sun)))

    d_new = phase_sample_at(kinds, phase_params, weights_at, params_at, d, u_sel, u_cos, u_phi)
    cos_scat = dot(d_new, d)
    p_scalar = phase_eval_at(kinds, phase_params, weights_at, params_at, cos_scat)
    b_new, R_s = basis_rotator(-d_new, l_out, b)
    M_s = phase_mueller_at(kinds, phase_params, weights_at, params_at, cos_scat)
    M_full = matmul4(R_s, M_s) / torch.clamp(p_scalar, min=1e-30)[:, None, None]
    return S_nee, d_new, matmul4(P, M_full), b_new


def surface_vertex(P, b, l_out, R_sun, M_nee, S_sun, d_cont, M_cont):
    """The Mueller vertex of a surface hit, shared by the polarized tracers
    (a scalar kind's matrices are depolarizers): the sun's next-event Stokes
    vector ``P R_sun M_nee S_sun`` and the continuation along the sampled
    world direction ``d_cont``, whose Mueller matrix ``M_cont`` is
    normalised by its own I-to-I element (the sampling weight lives in
    beta). Returns ``(S_nee, P_new, b_new)``."""
    S_nee = matvec4(P, matvec4(R_sun, matvec4(M_nee, S_sun)))
    b_new, R_c = basis_rotator(-d_cont, l_out, b)
    f_scalar = torch.clamp(M_cont[:, 0, 0], min=1e-30)
    return S_nee, matmul4(P, matmul4(R_c, M_cont / f_scalar[:, None, None])), b_new


def roulette(beta, alive, do_rr, u_rr):
    """Russian roulette on ``beta`` where ``do_rr``: it reweights beta once,
    not P (every contribution is ``P ... S_in(beta ...)``, so scaling P too
    would square the ``1/q`` factor). Returns ``(beta', alive')``."""
    q = torch.clamp(beta, 0.0, 0.95)
    survive = u_rr < q
    beta = beta * torch.where(do_rr & alive & survive, 1.0 / q, 1.0)
    return beta, alive & (survive | ~do_rr)


def _make_bounce_polarized(config, medium_row, surface_row, illum_row):
    """Per-bounce Mueller transition shared by every lane: returns
    ``bounce(depth, z, xy, d, P, b, beta, keys) -> (S_add, z', xy', d', P',
    b', beta', alive')``; updates are unconditional (the caller masks
    finished lanes)."""
    z_levels = medium_row.z_levels
    tau_levels = medium_row.tau_levels
    tau_top = tau_levels[-1]
    z_bottom = z_levels[0]
    fused = uses_position(config.surface_kind)

    d_sun = illum_row.direction
    mu_sun = clamp_mu(-d_sun[2])
    w_sun = -d_sun
    E_sun = illum_row.irradiance
    T_sun_bottom = torch.exp(-tau_top / mu_sun)

    C = len(config.phase_kinds)
    phase_params = medium_row.phase_params
    param_tables, param_slots = layer_param_slots(config.phase_kinds, phase_params)
    # albedo, blend weights and layer-indexed phase parameters (Rayleigh
    # depolarization), fetched by the collision fetch in one launch a bounce;
    # under the likelihood-ratio flight first the layers' optical
    # thicknesses, attached
    lr = config.lr_flight
    fetch_tables = torch.stack(
        ([torch.diff(tau_levels)] if lr else [])
        + [medium_row.albedo]
        + [medium_row.phase_weights[c] for c in range(C)]
        + param_tables
    ).contiguous()
    off = 1 if lr else 0
    tau_levels_s = tau_levels.detach() if lr else tau_levels
    tau_top_s = tau_top.detach() if lr else tau_top

    def tau_z(z):
        return tau_at_z(z, z_levels, tau_levels)

    def bounce(depth, z, xy, d, P, b, beta, keys):
        B = z.shape[0]
        # the scalar tracer's slot layout (slots 1-2, its sun cone, unused)
        U = bounce_uniforms(keys, depth, 10, config.rng)
        u_dist = U[:, 0]
        u_ph_sel, u_ph_cos, u_ph_phi = U[:, 3], U[:, 4:6], U[:, 6]
        u_srf = U[:, 7:9]
        u_rr = U[:, 9]
        d_sun_b = d_sun.expand(B, 3)

        mu = clamp_mu(d[:, 2])
        tau_here = tau_z(z)
        tau_exit = torch.where(mu > 0.0, (tau_top - tau_here) / mu, tau_here / (-mu))
        tau_s = depth_sample(u_dist, exact=tau_levels.dtype == torch.float64)
        collide = tau_s < tau_exit

        # ---- volume collision (K1: z, layer and the layer's tables) ------
        tau_here_s = tau_here.detach() if lr else tau_here
        tau_new = torch.minimum(torch.clamp(tau_here_s + mu * tau_s, min=0.0), tau_top_s)
        z_col, _, fetched = collision_fetch(tau_new, z_levels, tau_levels_s, fetch_tables)
        albedo_col = fetched[off]
        weights_at = fetched[off + 1 : off + 1 + C].T  # [B, C]
        params_at = rebuild_fetched(config.phase_kinds, param_slots, fetched[off + 1 + C :])
        xy_col = advance_xy(xy, d, (z_col - z) / mu, fused)
        tau_col = tau_z(z_col)
        r_col = r_bnd = None
        if lr:
            # likelihood-ratio flight (reference ops/tracer_polarized.py):
            # z is a fixed position, so tau_z(z_col) and tau_here are the
            # attached depths; the weights' primal is exactly 1
            tau_path = torch.abs(tau_col - tau_here) / torch.abs(mu)
            g_col = torch.log(torch.clamp(fetched[0], min=1e-30)) - tau_path
            r_col = torch.exp(g_col - g_col.detach())
            r_bnd = torch.exp(-(tau_exit - tau_exit.detach()))

        l_out = -d  # light leaves the vertex toward the sensor path
        # the sun's light arrives along d_sun at either vertex kind: one
        # rotation into its scattering plane serves both estimates
        _, R_sun = basis_rotator(d_sun_b, l_out, b)

        T_sun = torch.exp(-(tau_top - tau_col) / mu_sun)
        beta_w = beta if r_col is None else beta * r_col  # r_col: primal 1
        S_sun = unpolarized(E_sun * T_sun * albedo_col * beta_w)
        S_col, d_new, P_col, h_in_s = phase_vertex(
            config.phase_kinds, phase_params, weights_at, params_at, P, b, d, d_sun_b, R_sun,
            S_sun, u_ph_sel, u_ph_cos, u_ph_phi,
        )
        beta_col = beta_w * albedo_col

        # ---- surface hit (Mueller-general; scalar kinds depolarize) -----
        hit_surface = (~collide) & (mu < 0.0) & config.has_surface
        xy_surf = advance_xy(xy, d, (z_bottom - z) / mu, fused)
        # NEE: incident light propagates along d_sun, leaves along l_out;
        # the sampled continuation comes from d_srf (propagating along
        # -d_srf)
        M_nee_srf = surface_mueller(
            config.surface_kind, surface_row.params, w_sun.expand(B, 3), l_out, xy_surf
        )
        beta_b = beta if r_bnd is None else beta * r_bnd  # r_bnd: primal 1
        S_sun_srf = unpolarized(beta_b * mu_sun * T_sun_bottom * E_sun)
        d_srf, w_srf = bsdf_sample_from_uniforms(
            config.surface_kind, surface_row.params, l_out, u_srf, xy_surf
        )
        M_cont = surface_mueller(
            config.surface_kind, surface_row.params, d_srf, l_out, xy_surf
        )
        S_surf, P_surf, h_in_c = surface_vertex(
            P, b, l_out, R_sun, M_nee_srf, S_sun_srf, d_srf, M_cont
        )
        beta_surf = beta_b * w_srf

        # ---- combine ----------------------------------------------------
        S_add = torch.where(
            collide[:, None], S_col, torch.where(hit_surface[:, None], S_surf, 0.0)
        )
        z2 = torch.where(collide, z_col, z_bottom)
        xy2 = torch.where(collide[:, None], xy_col, xy_surf)
        d2 = torch.where(collide[:, None], d_new, d_srf)
        P2 = torch.where(
            collide[:, None, None], P_col, torch.where(hit_surface[:, None, None], P_surf, P)
        )
        b2 = torch.where(collide[:, None], h_in_s, h_in_c)
        beta2 = torch.where(collide, beta_col, torch.where(hit_surface, beta_surf, 0.0))
        alive2 = (collide | hit_surface) & (beta2 > 0.0)
        beta2, alive2 = roulette(beta2, alive2, depth >= config.rr_depth, u_rr)
        return S_add, z2, xy2, d2, P2, b2, beta2, alive2

    return bounce


def trace_paths_polarized_regen(
    config, medium_row, surface_row, illum_row, init_z, init_xy, init_d,
    row_key, lane_first, quota, check_every=CHECK_EVERY,
):
    """Regenerative Mueller trace (see :func:`.tracer.trace_paths_regen`):
    lane ``l`` renders samples ``lane_first[l] .. lane_first[l] + quota[l] -
    1`` of its pixel, each from a fresh ``P = I`` and the meridian basis of
    its viewing direction. Returns ``(S_sum [B, 4], m2_sum [B], iterations)``:
    per-lane sums of the samples' Stokes vectors and of their I squared, and
    the bounce iterations run."""
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    B = init_z.shape[0]
    dev, dtype = init_z.device, init_z.dtype
    bounce = _make_bounce_polarized(config, medium_row, surface_row, illum_row)
    b_init = default_basis(-init_d)
    eye4 = torch.eye(4, dtype=dtype, device=dev).expand(B, 4, 4)

    s_local = torch.zeros(B, dtype=torch.int64, device=dev)
    depth = torch.zeros(B, dtype=torch.int64, device=dev)
    keys = derive_keys(row_key, lane_first, config.rng)
    z, xy, d, P, b = init_z, init_xy, init_d, eye4, b_init
    beta = torch.ones(B, dtype=dtype, device=dev)
    S_cur = torch.zeros((B, 4), dtype=dtype, device=dev)
    S_sum = torch.zeros((B, 4), dtype=dtype, device=dev)
    m2_sum = torch.zeros(B, dtype=dtype, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)

    iterations = 0
    while True:
        S_add, z2, xy2, d2, P2, b2, beta2, alive2 = bounce(
            depth, z, xy, d, P, b, beta, keys
        )
        active = ~done
        S_cur = S_cur + torch.where(active[:, None], S_add, 0.0)
        depth = depth + 1
        path_end = active & (~alive2 | (depth >= config.max_depth))

        S_sum = S_sum + torch.where(path_end[:, None], S_cur, 0.0)
        m2_sum = m2_sum + torch.where(path_end, S_cur[:, 0] * S_cur[:, 0], 0.0)
        s_local = s_local + path_end
        done = done | (s_local >= quota)

        # regenerate: a fresh path, P and basis for the lane's next sample
        regen = path_end & ~done
        keys_new = derive_keys(row_key, lane_first + s_local, config.rng)
        keys = torch.where(regen[:, None], keys_new, keys)
        z = torch.where(regen, init_z, z2)
        xy = torch.where(regen[:, None], init_xy, xy2)
        d = torch.where(regen[:, None], init_d, d2)
        P = torch.where(regen[:, None, None], eye4, P2)
        b = torch.where(regen[:, None], b_init, b2)
        beta = torch.where(regen, 1.0, beta2)
        S_cur = torch.where(path_end[:, None], 0.0, S_cur)
        depth = torch.where(regen, 0, depth)

        iterations += 1
        if iterations % check_every == 0 and bool(done.all()):
            return S_sum, m2_sum, iterations


def _render_row_polarized(
    config, n_pix, spp, medium_row, surface_row, illum_row, directions, key,
    lanes_target, check_every, sample_offset=0, spp_stride=None,
):
    """One spectral row: every lane starts at the top of the atmosphere
    above the origin, along its pixel's view direction (reference
    ``_render_row_polarized``), its sample ids placed as
    :func:`.tracer.lane_partition`'s. Returns (stokes [N, 4], m2 [N],
    iterations)."""
    lp, pix, _, lane_first, quota = lane_partition(
        n_pix, spp, lanes_target, directions.device, spp_stride, sample_offset
    )
    B = n_pix * lp
    z_top = medium_row.z_levels[-1]
    S_sum, m2_sum, iterations = trace_paths_polarized_regen(
        config, medium_row, surface_row, illum_row, z_top.expand(B).contiguous(),
        torch.zeros((B, 2), dtype=z_top.dtype, device=z_top.device), -directions[pix],
        key, lane_first, quota, check_every=check_every,
    )
    stokes = S_sum.reshape(n_pix, lp, 4).sum(dim=1) / spp
    m2 = m2_sum.reshape(n_pix, lp).sum(dim=1) / spp
    return stokes, m2, iterations


def _check_supported(config):
    """Raise ``NotImplementedError`` naming each feature this slice lacks;
    ``ValueError`` for an unpolarized config or an unknown surface kind."""
    if not config.polarized:
        raise ValueError("config.polarized is False: render it with ops.tracer.render")
    if config.geometry != "plane_parallel":
        raise NotImplementedError(f"polarized geometry {config.geometry!r} is not ported yet")
    check_kind(config.surface_kind)
    check_phase_kinds(config.phase_kinds, polarized=True)


def row_renderer(scene, sensor, config, *, device="cuda", lanes_target=None,
                 check_every=CHECK_EVERY):
    """:class:`.tracer.RowRenderer` of a polarized plane-parallel scene
    (arguments as :func:`render_polarized`)."""
    _check_supported(config)
    dev = resolve_device(device)
    scene, sensor, config = from_reference(scene, sensor, config, dev)
    if lanes_target is None:
        lanes_target = REGEN_LANES_TARGET[dev.type]
    n_pix = sensor.directions.shape[0]

    def render_row(s, key, n, sample_offset=None, spp_stride=None):
        medium_row, surface_row, illum_row = row_arrays(scene, s)
        return _render_row_polarized(
            config, n_pix, n, medium_row, surface_row, illum_row, sensor.directions, key,
            lanes_target, check_every, sample_offset or 0, spp_stride,
        )

    return RowRenderer(scene.medium.tau_levels.shape[0], n_pix, scene.medium.tau_levels.dtype,
                       dev, True, render_row)


def render_polarized(
    scene, sensor, config, spp, seed=0, *, device="cuda", lanes_target=None,
    check_every=CHECK_EVERY,
):
    """Polarized render of the spectral batch of one distant-sensor bank.

    ``scene``/``sensor``/``config`` are a compiled scene with
    ``config.polarized`` (the reference's or the port's), moved to
    ``device`` first; ``lanes_target`` (default
    :data:`.tracer.REGEN_LANES_TARGET`) changes only the float summation
    order. Returns a dict with ``stokes`` [S, N, 4] (meridian-aligned),
    ``radiance`` [S, N] (= I), ``m2`` [S, N] (second moment of I), ``spp`` and
    ``iterations`` (bounce iterations, summed over rows; one collision fetch
    each).
    """
    rr = row_renderer(scene, sensor, config, device=device, lanes_target=lanes_target,
                      check_every=check_every)
    stokes, m2s, iterations = [], [], 0
    for s in range(rr.rows):
        st, m2, it = rr.render(s, row_key(seed, s, 0, rr.device), spp)
        stokes.append(st)
        m2s.append(m2)
        iterations += it
    stokes = torch.stack(stokes)
    return {
        "stokes": stokes,
        "radiance": stokes[..., 0],
        "m2": torch.stack(m2s),
        "spp": spp,
        "iterations": iterations,
    }
