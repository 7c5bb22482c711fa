"""Forward-mode sensitivities of rendered radiance and BRF to scene
parameters.

Port of ``eradiate_tpu/sensitivity.py`` with the same channels, output and
refusals. Each channel is one forward pass of ``torch.autograd.forward_ad``
(one dual level, the channel's parameter a dual number with tangent 1)
through the port's renderer, on the card by default (``device="cuda"``) or
on the CPU when asked.

Estimator semantics, as in the reference: the derivatives are
fixed-sample-path ("detached") estimates with common random numbers (measure
``i`` renders with ``seed + i`` for the value and every channel). Russian
roulette is switched off (``rr_depth = max_depth``) and the renders take the
likelihood-ratio flight (``lr_flight``): sampling geometry and event choices
come from the detached medium, the medium re-entering through weights whose
primal is exactly 1, so that extinction channels (``medium.tau_scale``,
``gas.<species>``) are unbiased and the primal is the production render's
bit for bit. The bilambertian side choice carries a likelihood ratio of the
same kind (:func:`.ops.bsdf_ops.bilambertian_sample_from_uniforms`), so the
leaf channels keep the choice's boundary term.

Tangents cross the kernels through their forward rules: the collision
fetch's on the fetched tables (albedo, and the layers' optical thicknesses
under the likelihood-ratio flight) and the slant depth's on the extinction
(:mod:`.kernels.collision_fetch`, :mod:`.kernels.shell_flight`); the
spherical flight's weights launch the shell-depth kernel on the
extinction's tangent (:func:`.ops.tracer_spherical.lr_weights`). The geometry kernels (shell flight and event,
leaf and triangle sweeps, the terrain march) refuse a tangent rather than
drop it; the renders detach the sampling geometry before them. No kernel is
switched off.

Channels perturb the compiled scene (numpy leaves; a perturbed leaf becomes
a tensor, which :func:`.ops.scene_state.from_reference` moves to the device
with its tangent), not the experiment's constructor arguments: compilation is
host-side numpy and is not differentiated, except for the gas channels, which
difference two compiles.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from .core.device import resolve_device

__all__ = ["sensitivities", "channel_names"]


def _replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


def as_tensor(x):
    """A compiled scene's leaf (numpy or tensor) as a tensor, so that adding
    a dual ``theta`` to it makes a dual leaf."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _chan_surface(name):
    def apply(scene, theta):
        params = dict(scene.surface.params)
        if name not in params:
            raise KeyError(
                f"surface parameter '{name}' not in compiled scene "
                f"(available: {sorted(scene.surface.params)})"
            )
        params[name] = as_tensor(params[name]) + theta
        return _replace(scene, surface=_replace(scene.surface, params=params))

    return 0.0, apply


def _chan_medium_albedo():
    def apply(scene, theta):
        med = _replace(scene.medium, albedo=as_tensor(scene.medium.albedo) + theta)
        return _replace(scene, medium=med)

    return 0.0, apply


def _chan_tau_scale():
    # plane-parallel media carry cumulative tau_levels, spherical ones
    # per-shell sigma_t: scaling either scales the optical-depth field
    def apply(scene, theta):
        med = scene.medium
        if getattr(med, "tau_levels", None) is not None:
            med = _replace(med, tau_levels=as_tensor(med.tau_levels) * (1.0 + theta))
        else:
            med = _replace(med, sigma_t=as_tensor(med.sigma_t) * (1.0 + theta))
        return _replace(scene, medium=med)

    return 0.0, apply


def _chan_irradiance_scale():
    def apply(scene, theta):
        ill = _replace(
            scene.illumination,
            irradiance=as_tensor(scene.illumination.irradiance) * (1.0 + theta),
        )
        return _replace(scene, illumination=ill)

    return 0.0, apply


def _chan_leaf(pname):
    def apply(leaf_params, theta):
        if pname not in leaf_params:
            raise KeyError(
                f"leaf parameter '{pname}' not in canopy leaf params "
                f"(available: {sorted(leaf_params)})"
            )
        out = dict(leaf_params)
        out[pname] = as_tensor(out[pname]) + theta
        return out

    return 0.0, apply


def _resolve_channel(name):
    """Channel name -> (theta0, apply, target), target in {"scene", "leaf",
    "gas"}."""
    if callable(name):
        # custom channel: apply(scene, theta) evaluated at theta = 0
        return 0.0, name, "scene"
    if name.startswith("surface."):
        return _chan_surface(name.split(".", 1)[1]) + ("scene",)
    if name.startswith("canopy."):
        return _chan_leaf(name.split(".", 1)[1]) + ("leaf",)
    if name.startswith("gas."):
        # resolved per measure (needs the experiment and its spectral
        # context); the apply slot holds the species until then
        return 0.0, name.split(".", 1)[1], "gas"
    if name == "medium.albedo":
        return _chan_medium_albedo() + ("scene",)
    if name == "medium.tau_scale":
        return _chan_tau_scale() + ("scene",)
    if name == "illumination.irradiance_scale":
        return _chan_irradiance_scale() + ("scene",)
    raise ValueError(
        f"unknown sensitivity channel '{name}'; use 'surface.<param>', "
        "'canopy.<reflectance|transmittance>', 'medium.albedo', "
        "'medium.tau_scale', 'illumination.irradiance_scale', or pass a "
        "callable apply(scene, theta)"
    )


def channel_names(scene, canopy: bool = False) -> list:
    """Built-in channel names valid for a compiled scene."""
    names = [f"surface.{k}" for k in sorted(scene.surface.params)]
    names += ["medium.albedo", "medium.tau_scale", "illumination.irradiance_scale"]
    if canopy:
        names += ["canopy.reflectance", "canopy.transmittance"]
    return names


def _check_tau_support(config, wrt, is_canopy=False):
    # every atmosphere tracer family (plane-parallel and spherical shell,
    # both polarizations, and DEM terrain) has the likelihood-ratio flight;
    # the canopy tracers have none, so extinction channels stay refused there
    supported = config.geometry in ("plane_parallel", "spherical_shell") and not is_canopy
    extinction = [n for n in wrt if n == "medium.tau_scale" or str(n).startswith("gas.")]
    if extinction and not supported:
        raise ValueError(
            f"extinction channels {extinction} require the likelihood-"
            "ratio flight estimator, implemented by the plane-parallel "
            "and spherical-shell atmosphere tracers but not the canopy "
            f"dispatch (got geometry='{config.geometry}', "
            f"canopy={is_canopy}); use seed-averaged common-random-"
            "number finite differences for this configuration."
        )


@contextlib.contextmanager
def _scaled_species(exp, species, factor):
    """Temporarily scale one species' mole-fraction profile on the
    experiment's radprofile thermoprops (interpolation caches cleared)."""
    atm = exp.atmosphere
    rp = getattr(atm, "radprofile", None)
    tp = getattr(rp, "thermoprops", None)
    if tp is None or species not in getattr(tp, "x", {}):
        have = sorted(getattr(tp, "x", {}) or {})
        raise ValueError(
            f"gas channel species '{species}' not in the thermophysical "
            f"profile (available: {have})"
        )
    db = getattr(rp, "absorption_data", None)
    if db is None or species not in getattr(db, "species", []):
        have = list(getattr(db, "species", []) or [])
        raise ValueError(
            f"gas channel species '{species}' is not resolvable by the "
            f"absorption database (species axes present: {have}); a "
            "fixed-composition table cannot attribute absorption to one "
            "species"
        )
    old = tp.x[species]
    cache = dict(getattr(rp, "_interp_cache", {}) or {})
    tp.x[species] = np.asarray(old) * factor
    if hasattr(rp, "_interp_cache"):
        rp._interp_cache.clear()
    try:
        yield
    finally:
        tp.x[species] = old
        if hasattr(rp, "_interp_cache"):
            rp._interp_cache.clear()
            rp._interp_cache.update(cache)


#: relative concentration step of the gas channels' compile linearization:
#: the database interpolation is piecewise linear in x, so within a knot
#: interval the difference quotient is exact in float64
_GAS_REL_STEP = 1e-3

#: medium fields never perturbed by the compiled-scene difference (geometry
#: grids; the sun-tau table is unused on the likelihood-ratio path)
_GAS_SKIP_FIELDS = ("radii", "z_levels", "mu_grid", "sun_tau", "phase_params")


def _gas_channel(exp, measure, ctx, scene0, species):
    """Per-species concentration channel x_s -> x_s (1 + theta): the scene
    compiled once more with the species scaled by (1 + h), the medium
    arrays' difference quotient the perturbation direction (linear in theta
    by construction). Layer and shell merging are off while it runs
    (:func:`sensitivities`), so both compiles share one grid."""
    with _scaled_species(exp, species, 1.0 + _GAS_REL_STEP):
        scene_h, _, _ = exp.compile_scene(measure, ctx)
    med0, medh = scene0.medium, scene_h.medium
    dirs = {}
    for fld in dataclasses.fields(type(med0)):
        if fld.name in _GAS_SKIP_FIELDS:
            continue
        a = getattr(med0, fld.name)
        b = getattr(medh, fld.name)
        if a is None or not hasattr(a, "shape"):
            continue
        d = (np.asarray(b, dtype=np.float64) - np.asarray(a, dtype=np.float64)) / _GAS_REL_STEP
        if np.any(d != 0.0):
            dirs[fld.name] = torch.as_tensor(d.astype(np.asarray(a).dtype))
    if not dirs:
        raise ValueError(
            f"gas channel '{species}' has zero effect on the compiled "
            "medium — the absorption database does not respond to this "
            "species' concentration at the profile state"
        )

    def apply(scene, theta):
        med = scene.medium
        kw = {k: as_tensor(getattr(med, k)) + theta * d for k, d in dirs.items()}
        return _replace(scene, medium=_replace(med, **kw))

    return apply


def _delegates_to_base(exp):
    """Canopy-class experiments with ``canopy=None`` delegate process() to
    the base dispatch, so the base sensitivity path is valid."""
    from .experiments import CanopyAtmosphereExperiment

    return isinstance(exp, CanopyAtmosphereExperiment) and exp.canopy is None


def _unpack(x):
    """``(primal, tangent)`` of a render output as numpy (tangent None
    where it has none)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x), None
    primal, tan = fwAD.unpack_dual(x)
    out = primal.detach().cpu().numpy()
    return out, None if tan is None else tan.detach().cpu().numpy()


def sensitivities(exp, wrt, spp=None, seed=0, mesh=None, device="cuda"):
    """Radiance and BRF values and parameter sensitivities for an experiment
    (reference ``eradiate_tpu.sensitivity.sensitivities``).

    ``exp`` is an atmosphere experiment (plane-parallel or spherical, scalar
    or polarized), a canopy experiment (leaf channels) or a DEM experiment
    (marched or triangulated; every channel). ``wrt`` is a sequence of
    channel names (:func:`channel_names`, ``gas.<species>``) and/or
    callables ``apply(scene, theta)`` (``theta`` a 0-dim tensor; a leaf they
    perturb must become a tensor, :func:`as_tensor`). ``spp`` defaults to
    each measure's own; measure ``i`` renders with ``seed + i``. ``mesh``
    (None by default; ``"auto"`` or a ``DeviceMesh``, as
    :func:`.experiments._core.resolve_mesh`) shards the renders as
    :func:`eradiate_tpu_torch.run` does, the tangents reduced beside the
    primal (:func:`.parallel.render.reduce_sum`), so that sharded Jacobians
    equal single-device ones up to float summation order; a triangulated
    terrain refuses it, as in the reference. ``device`` is ``"cuda"`` by
    default and raises without a card; ``"cpu"`` runs on the CPU.

    Returns ``{measure_id: entry}``, ``entry`` holding ``radiance`` [S, P],
    ``brf`` [S, P] (distant-type measures), ``radiance_var`` [S, P] (the
    variance of the mean) and ``jac``: ``{channel: {"radiance": [S, P],
    "brf": [S, P]}}``, all numpy arrays. BRF is ``pi L / (E mu0)``; its
    tangents follow the quotient rule, so a channel that scales the
    irradiance leaves the BRF invariant.
    """
    from .experiments import DEMExperiment
    from .experiments._core import EarthObservationExperiment, resolve_mesh
    from .scenes.surface import DEMSurface

    dev = resolve_device(device)
    mesh = resolve_mesh(mesh, dev)
    is_canopy = getattr(exp, "canopy", None) is not None
    is_dem = isinstance(exp, DEMExperiment) and isinstance(exp.surface, DEMSurface)
    # an experiment overriding process() with a dispatch this module does
    # not reflect would render without its extra scene arrays
    if (
        not is_canopy
        and not is_dem
        and type(exp).process is not EarthObservationExperiment.process
        and not _delegates_to_base(exp)
    ):
        raise NotImplementedError(
            f"sensitivities() does not support {type(exp).__name__}: its "
            "render dispatch bypasses the base _render_one (the compiled "
            "scene's terrain arrays would be dropped). Use seed-averaged "
            "common-random-number finite differences over "
            "eradiate_tpu_torch.run for this experiment family."
        )
    terrain = exp.terrain() if is_dem else None
    if is_dem and terrain[1] is not None and mesh is not None:
        raise NotImplementedError(
            "triangulated DEM sensitivities are single-device only (pass mesh=None); the "
            "marched heightfield path shards"
        )
    channels = []
    for name in wrt:
        theta0, apply, target = _resolve_channel(name)
        if target == "leaf" and not is_canopy:
            raise ValueError(f"channel '{name}' requires a canopy experiment")
        label = name if not callable(name) else getattr(name, "__name__", "custom")
        channels.append((label, theta0, apply, target))
    has_gas = any(c[3] == "gas" for c in channels)

    out = {}
    # the gas channels difference two compiles: merging could regroup the
    # layers between them, so it is off for the duration
    merge_saved = None
    if has_gas:
        geo = exp.geometry
        merge_saved = (getattr(geo, "layer_merge_tol", None),
                       getattr(geo, "shell_merge_tol", None))
        if hasattr(geo, "layer_merge_tol"):
            geo.layer_merge_tol = None
        if hasattr(geo, "shell_merge_tol"):
            geo.shell_merge_tol = None
    try:
        for i, measure in enumerate(exp.measures):
            ctx = exp.spectral_context(measure)
            leaf_params = leaves = tris = tri_params = None
            if is_canopy:
                (scene, sensor, config, leaf_params, leaves, tris,
                 tri_params) = exp.compile_canopy_scene(measure, ctx)
            else:
                scene, sensor, config = exp.compile_scene(measure, ctx)
            _check_tau_support(config, [c[0] for c in channels], is_canopy=is_canopy)
            chans = [
                (nm, t0, _gas_channel(exp, measure, ctx, scene, ap) if tg == "gas" else ap, tg)
                for nm, t0, ap, tg in channels
            ]
            # RR off: its survival tracks the path weight, and the detached
            # estimate would drop the continuation of paths at the threshold
            config = dataclasses.replace(config, rr_depth=config.max_depth, lr_flight=True)
            n = int(spp) if spp is not None else int(measure.spp)

            def run(scene_p, leaf_p):
                if is_canopy:
                    raw = exp._render_canopy_raw(
                        scene_p, leaf_p, leaves, sensor, config, n, seed + i, tris,
                        tri_params, device=dev, mesh=mesh,
                    )
                elif is_dem:
                    raw = exp._render_dem_raw(scene_p, terrain, sensor, config, n, seed + i,
                                              device=dev, mesh=mesh)
                else:
                    raw = exp._render_one(scene_p, sensor, config, n, seed + i, device=dev,
                                          mesh=mesh)
                return raw["radiance"], raw["m2"]

            jac, d_irr = {}, {}
            radiance = m2 = None
            for name, t0, apply, target in chans:
                # one forward pass a channel: its parameter a dual number
                # with tangent 1 (the others at their base value); a 0-dim
                # float64 theta leaves each leaf in its own dtype
                with fwAD.dual_level():
                    theta = fwAD.make_dual(torch.tensor(t0, dtype=torch.float64),
                                           torch.tensor(1.0, dtype=torch.float64))
                    s, lp = scene, leaf_params
                    if target == "leaf":
                        lp = apply(lp, theta)
                    else:
                        s = apply(s, theta)
                    rad, mom = run(s, lp)
                    val, tan = _unpack(rad)
                    val_m2, _ = _unpack(mom)
                    _, tan_irr = _unpack(s.illumination.irradiance)
                if radiance is None:
                    radiance, m2 = val, val_m2
                jac[name] = {"radiance": np.zeros_like(val) if tan is None else tan}
                irr_shape = np.shape(scene.illumination.irradiance)
                d_irr[name] = np.zeros(irr_shape) if tan_irr is None else tan_irr
            if not chans:
                rad, mom = run(scene, leaf_params)
                radiance, m2 = _unpack(rad)[0], _unpack(mom)[0]

            entry = {"radiance": radiance, "jac": jac}
            entry["radiance_var"] = np.maximum(m2 - radiance**2, 0.0) / max(n, 1)

            # BRF for distant-type measures, pi L / (E mu0); the tangents
            # follow the quotient rule
            mu0 = float(abs(np.asarray(scene.illumination.direction)[2]))
            irr = np.asarray(scene.illumination.irradiance)
            if mu0 > 0 and np.all(irr > 0) and _is_distant(measure):
                factor = (np.pi / (irr * mu0))[:, None]
                brf = radiance * factor
                entry["brf"] = brf
                for name in jac:
                    rel_de = (d_irr[name] / irr)[:, None]
                    jac[name]["brf"] = jac[name]["radiance"] * factor - brf * rel_de
            out[measure.id] = entry
    finally:
        if merge_saved is not None:
            geo = exp.geometry
            if hasattr(geo, "layer_merge_tol"):
                geo.layer_merge_tol = merge_saved[0]
            if hasattr(geo, "shell_merge_tol"):
                geo.shell_merge_tol = merge_saved[1]
    return out


def _is_distant(measure) -> bool:
    return "distant" in type(measure).__name__.lower()
