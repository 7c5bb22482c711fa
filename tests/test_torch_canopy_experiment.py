"""The scalar canopy path of the port against the JAX package, on the CPU.

A small HET01 (one 200-leaf sphere cloud instanced at 3 positions over a
Lambertian floor, 5 view zeniths, 128 spp) runs through
``eradiate_tpu_torch.run(..., device="cpu")`` and ``eradiate_tpu.run`` at the
same seed, with and without the Rayleigh atmosphere. On the CPU the port keeps
the reference's chunk and lane plan and follows the same sample stream; ulp
differences of libm and of XLA's FMA contraction may flip a rare path, so the
gate is the one of c4: every pixel within |z| <= 5 and 2e-3 relative, the
median pixel within 1e-4. The same canopy given as two elements (the flat
path) agrees with the instanced run within the same gate; results do not
change with the lane count or with the lane sort beyond float32 summation
order (1e-6 relative); chunks of samples use the reference's keys.
"""

import dataclasses

import numpy as np
import pytest
import torch

import eradiate_tpu
import eradiate_tpu_torch
from eradiate_tpu.experiments import CanopyAtmosphereExperiment as RefCanopyAtmosphere
from eradiate_tpu.experiments import CanopyExperiment as RefCanopy
from eradiate_tpu.ops.tracer_canopy import render_canopy as ref_render_canopy
from eradiate_tpu.scenes import biosphere as ref_bio
from eradiate_tpu_torch import CanopyAtmosphereExperiment, CanopyExperiment
from eradiate_tpu_torch.ops.tracer_canopy import render_canopy
from eradiate_tpu_torch.scenes import biosphere as bio

torch.set_num_threads(1)

SPP = 128
N_VZA = 5
POSITIONS_M = np.array([[-8.0, -5.0, 0.0], [6.0, -7.0, 0.0], [1.0, 8.0, 0.0]])


def small_het01(pkg, split=False):
    """One 200-leaf sphere cloud (HET01's crown with larger leaves) at three
    positions in a 30 m x 30 m x 15 m canopy; ``split`` gives it as two
    elements (positions 2 + 1), which the experiments flatten."""
    cloud = pkg.LeafCloud.sphere(
        n_leaves=200, leaf_radius=0.4, radius=5.0, center=(0.0, 0.0, 10.0),
        leaf_reflectance=0.4957, leaf_transmittance=0.4409,
    )
    parts = (POSITIONS_M[:2], POSITIONS_M[2:]) if split else (POSITIONS_M,)
    return pkg.DiscreteCanopy(
        size=(30.0, 30.0, 15.0),
        instanced_canopy_elements=[
            {"type": "instanced", "canopy_element": cloud, "instance_positions": part * 1e-3}
            for part in parts
        ],
    )


def kwargs(pkg, atmosphere=True, split=False):
    kw = dict(
        canopy=small_het01(pkg, split),
        illumination={"type": "directional", "zenith": 20.0, "azimuth": 0.0},
        measures={"type": "mdistant", "construct": "hplane",
                  "zeniths": np.linspace(-75, 75, N_VZA), "azimuth": 0.0, "id": "m"},
        surface={"type": "lambertian", "reflectance": 0.159},
        integrator={"type": "volpath"},
    )
    if atmosphere:
        kw["atmosphere"] = {"type": "molecular", "has_absorption": False}
    return kw


def port_exp(atmosphere=True, split=False):
    cls = CanopyAtmosphereExperiment if atmosphere else CanopyExperiment
    return cls(**kwargs(bio, atmosphere, split))


def ref_exp(atmosphere=True, split=False):
    cls = RefCanopyAtmosphere if atmosphere else RefCanopy
    return cls(**kwargs(ref_bio, atmosphere, split))


@pytest.fixture
def mono_single():
    eradiate_tpu.set_mode("mono_single")
    eradiate_tpu_torch.set_mode("mono_single")
    yield
    eradiate_tpu.set_mode("mono")
    eradiate_tpu_torch.set_mode("mono")


def gate(out, ref, median_bound=1e-4):
    """The per-pixel gate: |z| <= 5, 2e-3 relative, median within the bound."""
    brf, brf_ref = np.asarray(out["brf"]), np.asarray(ref["brf"])
    assert brf.shape == brf_ref.shape == (1, N_VZA)
    assert np.isfinite(brf).all()
    rad, rad_ref = np.asarray(out["radiance"]), np.asarray(ref["radiance"])
    z = np.abs(rad - rad_ref) / np.sqrt(np.asarray(out["var"]) + np.asarray(ref["var"]))
    rel = np.abs(brf - brf_ref) / np.abs(brf_ref)
    assert z.max() <= 5.0
    assert rel.max() <= 2e-3
    assert np.median(rel) <= median_bound


def compiled(exp):
    m = exp.measures[0]
    return exp.compile_canopy_scene(m, exp.spectral_context(m))


@pytest.mark.parametrize("split", [False, True])
def test_canopy_arrays_bitwise(mono_single, split):
    """Leaf arrays (Morton order, offsets) and leaf optics of the port's
    host compile equal the reference's bit for bit."""
    out, ref = compiled(port_exp(split=split)), compiled(ref_exp(split=split))
    for k in ("reflectance", "transmittance"):
        assert out[3][k].dtype == np.float32
        np.testing.assert_array_equal(out[3][k], np.asarray(ref[3][k]))
    leaves, ref_leaves = out[4], ref[4]
    assert hasattr(leaves, "canonical") == hasattr(ref_leaves, "canonical") == (not split)
    if not split:
        np.testing.assert_array_equal(leaves.offsets, np.asarray(ref_leaves.offsets))
        leaves, ref_leaves = leaves.canonical, ref_leaves.canonical
    assert leaves.centers.shape == ((600 if split else 200), 3)
    for k in ("centers", "normals", "radii"):
        assert getattr(leaves, k).dtype == np.float32
        np.testing.assert_array_equal(getattr(leaves, k), np.asarray(getattr(ref_leaves, k)))
    assert out[5] is None and out[6] is None and ref[5] is None
    # the footprint target of the measure
    np.testing.assert_array_equal(out[1].target_extent, np.asarray(ref[1].target_extent))
    np.testing.assert_array_equal(out[1].target, np.asarray(ref[1].target))


@pytest.mark.parametrize("atmosphere", [True, False])
def test_run_matches_reference(mono_single, atmosphere):
    ref = eradiate_tpu.run(
        ref_exp(atmosphere), spp=SPP, seed_state=eradiate_tpu.SeedState(7), mesh=None
    )
    out = eradiate_tpu_torch.run(
        port_exp(atmosphere), spp=SPP, seed_state=eradiate_tpu_torch.SeedState(7),
        device="cpu",
    )
    assert set(out.data_vars) == set(ref.data_vars)
    for k in ref.coords:
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(ref[k]))
    gate(out, ref)
    # the canopy matters: the BRF is not the bare floor's
    assert np.abs(np.asarray(out["brf"]) - 0.159).max() > 0.01


def test_flat_matches_reference_and_instanced(mono_single):
    """The two-element canopy flattens (K5/K6's plain versions run) and gives
    what the reference gives for it, and what the instanced form gives."""
    seed = 7
    flat = eradiate_tpu_torch.run(
        port_exp(split=True), spp=SPP, seed_state=eradiate_tpu_torch.SeedState(seed),
        device="cpu",
    )
    ref = eradiate_tpu.run(
        ref_exp(split=True), spp=SPP, seed_state=eradiate_tpu.SeedState(seed), mesh=None
    )
    gate(flat, ref)
    inst = eradiate_tpu_torch.run(
        port_exp(), spp=SPP, seed_state=eradiate_tpu_torch.SeedState(seed), device="cpu"
    )
    gate(flat, inst)


@pytest.mark.parametrize("split", [False, True])
def test_estimate_independent_of_lane_count(mono_single, split):
    scene, sensor, config, leaf_params, leaves, _, _ = compiled(port_exp(split=split))
    out = [
        render_canopy(scene, leaf_params, leaves, sensor, config, spp=64, seed=3,
                      device="cpu", lanes_target=lt)["radiance"].numpy()
        for lt in (N_VZA * 8, N_VZA * 3, N_VZA)  # 8, 3 and 1 lanes per pixel
    ]
    np.testing.assert_allclose(out[1], out[0], rtol=1e-6, atol=0)
    np.testing.assert_allclose(out[2], out[0], rtol=1e-6, atol=0)


@pytest.mark.parametrize("sort_every", [0, 3])
def test_estimate_independent_of_lane_sort(mono_single, sort_every):
    """Keys and sums travel with their lane: the sort changes no path."""
    scene, sensor, config, leaf_params, leaves, _, _ = compiled(port_exp())
    base = render_canopy(scene, leaf_params, leaves, sensor, config, spp=64, seed=3,
                         device="cpu")
    other = render_canopy(scene, leaf_params, leaves, sensor, config, spp=64, seed=3,
                          device="cpu", sort_every=sort_every)
    for k in ("radiance", "m2"):
        np.testing.assert_allclose(other[k].numpy(), base[k].numpy(), rtol=1e-6, atol=0)
    assert other["spp"] == base["spp"] == 64


def test_chunks_use_the_reference_keys(mono_single):
    """80 spp in chunks of 32 (32 + 32 + 16), each chunk with its own
    ``fold_in(chunk_id)`` key: same samples as the reference's chunks."""
    out_c, ref_c = compiled(port_exp()), compiled(ref_exp())
    out = render_canopy(out_c[0], out_c[3], out_c[4], out_c[1], out_c[2], spp=80, seed=5,
                        spp_chunk=32, device="cpu")
    ref = ref_render_canopy(ref_c[0], ref_c[3], ref_c[4], ref_c[1], ref_c[2], spp=80, seed=5,
                            spp_chunk=32)
    assert out["spp"] == ref["spp"] == 80
    rel = np.abs(out["radiance"].numpy() - np.asarray(ref["radiance"])) / np.asarray(ref["radiance"])
    assert rel.max() <= 2e-3 and np.median(rel) <= 1e-4
    # the chunk plan changes the sample set: one chunk of 80 differs
    whole = render_canopy(out_c[0], out_c[3], out_c[4], out_c[1], out_c[2], spp=80, seed=5,
                          device="cpu")
    assert np.abs(whole["radiance"].numpy() - out["radiance"].numpy()).max() > 0


def test_cpu_plan_is_the_reference_plan():
    from eradiate_tpu.ops import tracer as ref_tracer
    from eradiate_tpu_torch.ops import tracer, tracer_canopy

    caps = tracer.CANOPY_PATHS_PER_DISPATCH
    assert caps["cpu"] == ref_tracer.MAX_PATHS_PER_DISPATCH // 8
    assert tracer_canopy.LANES_TARGET["cpu"] == ref_tracer.REGEN_LANES_TARGET
    # config 5: 19 pixels -> 13797 spp per chunk, 152 chunks of 2097152 spp
    assert caps["cpu"] // 19 == 13797


def test_cuda_without_card_raises(mono_single, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        eradiate_tpu_torch.run(port_exp(), spp=8, device="cuda")


def _with_tree(**overrides):
    tree = bio.AbstractTree(leaf_cloud=bio.LeafCloud.sphere(n_leaves=20, leaf_radius=0.4,
                                                             radius=2.0))
    return CanopyExperiment(**{
        **kwargs(bio, atmosphere=False),
        "canopy": bio.DiscreteCanopy(
            size=(30.0, 30.0, 15.0),
            instanced_canopy_elements=[
                {"type": "instanced", "canopy_element": tree,
                 "instance_positions": POSITIONS_M * 1e-3}
            ],
        ),
        **overrides,
    })


@pytest.mark.parametrize(
    "kind, name",
    [("tree", "AbstractTree"), ("polarized", "render_canopy_polarized"),
     ("tris", "triangle meshes")],
)
def test_unported_features_raise(mono_single, kind, name):
    """Trees, triangle meshes and the spot emitter are ported
    (``test_torch_tree_experiment.py``, ``test_torch_spot.py``); what still
    raises with them is what raises without them: a polarized config given
    to the scalar tracer, which names the polarized renderer."""
    if kind == "tree":
        brf = np.asarray(eradiate_tpu_torch.run(_with_tree(), spp=8, device="cpu")["brf"])
        assert np.isfinite(brf).all()
        return
    if kind == "tris":
        scene, sensor, config, leaf_params, leaves, tris, tri_params = compiled(_with_tree())
        assert tris.canonical.v0.shape == (36, 3)
        with pytest.raises(NotImplementedError, match="render_canopy_polarized"):
            render_canopy(scene, leaf_params, leaves, sensor,
                          dataclasses.replace(config, polarized=True), spp=8, device="cpu",
                          tris=tris, tri_params=tri_params)
        return
    scene, sensor, config, leaf_params, leaves, _, _ = compiled(port_exp())
    config = dataclasses.replace(config, polarized=True)
    with pytest.raises(NotImplementedError, match=name):
        render_canopy(scene, leaf_params, leaves, sensor, config, spp=8, device="cpu")


def test_polarized_mode_raises():
    """``mono_polarized`` names the double-precision polarized mode: it
    renders the leaf canopy (``test_torch_canopy_double.py``) and a canopy
    with triangles (``test_torch_tri_double.py``) with float64 path state.
    (The name is the test's from when the canopy with triangles was
    refused.)"""
    eradiate_tpu_torch.set_mode("mono_polarized")
    try:
        for exp in (port_exp(), _with_tree()):
            ds = eradiate_tpu_torch.run(exp, spp=8, device="cpu")
            assert exp.measures[0].results["raw"]["radiance"].dtype == np.float64
            assert np.isfinite(np.asarray(ds["brf"])).all()
    finally:
        eradiate_tpu_torch.set_mode("mono")
