"""The port's sharded renders (``eradiate_tpu_torch.parallel``) on the CPU.

One dry run (``eradiate_tpu_torch.parallel.dryrun``) spawns four gloo ranks
for the whole file and renders every family on a (2, 2) and a (1, 4)
("spectral", "sample") mesh through ``run(exp, mesh=...)`` and
``sensitivities(..., mesh=...)``, and once unsharded, at one seed. Held here:

- every family sharded equals the port's unsharded render within float
  summation order (rtol 3e-5, as ``tests/system/test_multihost.py``), with
  the same ``spp``, and every rank holds the whole result; the structured
  sampler, whose point sets stratify within each rank, within |z| <= 5;
- the sharded Jacobian equals the single-process one, and a forward-mode
  dual summed over the sample axis keeps the sum of the tangents;
- the port's ``render_sharded`` equals the reference's on the same mesh at
  S = 2 rows and ``spp`` 33 (each rank traces 17, so ``spp`` is 34) within
  1e-5, and the sharded canopy the reference's under the canopy gate;
- a spectral axis that does not divide the rows raises; the ``auto`` mesh
  shards over every rank unless ``ERADIATE_TPU_MESH=none``, and without a
  process group renders as ``mesh=None`` bit for bit; the lane hooks tile
  the global sample ids and leave the single-device partition as it was.
"""

import types

import jax
import numpy as np
import pytest
import torch

import eradiate_tpu
import eradiate_tpu_torch
from eradiate_tpu.experiments import AtmosphereExperiment as RefExperiment
from eradiate_tpu.experiments import CanopyAtmosphereExperiment as RefCanopyExperiment
from eradiate_tpu.parallel import make_render_mesh as ref_make_render_mesh
from eradiate_tpu.parallel import render_canopy_sharded as ref_render_canopy_sharded
from eradiate_tpu.parallel import render_sharded as ref_render_sharded
from eradiate_tpu.scenes import biosphere as ref_biosphere
from eradiate_tpu_torch import parallel
from eradiate_tpu_torch.experiments._core import resolve_mesh
from eradiate_tpu_torch.ops.tracer import lane_partition
from eradiate_tpu_torch.parallel import dryrun

torch.set_num_threads(1)

MESHES = [(2, 2), (1, 4)]
TAGS = ["2x2", "1x4"]
#: float32 summation order over the ranks' partial sums
RTOL, ATOL = 3e-5, 1e-7
EXACT = [c for c in dryrun.FAMILIES if c not in ("stratified", "sensitivity")]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The dry run's results: four gloo ranks, both meshes, every family."""
    out = tmp_path_factory.mktemp("dryrun")
    dryrun.run_ranks(4, MESHES, "cpu", "gloo", out, timeout=600)
    return out


def load(ranks, case, tag):
    return np.load(ranks / f"{case}-{tag}.npz")


@pytest.fixture
def mono_single():
    eradiate_tpu.set_mode("mono_single")
    eradiate_tpu_torch.set_mode("mono_single")
    yield
    eradiate_tpu.set_mode("mono")
    eradiate_tpu_torch.set_mode("mono")


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("case", EXACT)
def test_every_family_sharded_equals_unsharded(ranks, case, tag):
    sharded, single = load(ranks, case, tag), load(ranks, case, "single")
    assert bool(sharded["ranks_agree"])
    assert int(sharded["spp"]) == int(single["spp"]) == dryrun.FAMILIES[case][1]
    keys = ["radiance", "m2"] + (["stokes"] if "polarized" in case else [])
    for k in keys:
        assert sharded[k].shape == single[k].shape
        assert np.isfinite(sharded[k]).all()
        np.testing.assert_allclose(sharded[k], single[k], rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("tag", TAGS)
def test_structured_sampler_sharded_agrees_statistically(ranks, tag):
    """Each rank stratifies its own point set (the reference's rule), so the
    sharded estimate is another one of the same estimator."""
    sharded, single = load(ranks, "stratified", tag), load(ranks, "stratified", "single")
    assert int(sharded["spp"]) == int(single["spp"])
    sigma = np.sqrt(single["m2"] / int(single["spp"]))
    assert (np.abs(sharded["radiance"] - single["radiance"]) <= 5 * sigma).all()
    assert not np.array_equal(sharded["radiance"], single["radiance"])


@pytest.mark.parametrize("tag", TAGS)
def test_sharded_jacobian_equals_single_process(ranks, tag):
    sharded, single = load(ranks, "sensitivity", tag), load(ranks, "sensitivity", "single")
    assert bool(sharded["ranks_agree"])
    assert np.abs(single["jac_radiance"]).max() > 0
    for k in ("radiance", "brf", "jac_radiance", "jac_brf"):
        np.testing.assert_allclose(sharded[k], single[k], rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("tag", TAGS)
def test_dual_reduction_keeps_the_tangent_sum(ranks, tag):
    """Rank (c, r) holds primal c + r + 1 and tangent 10 (c + r + 1): the sum
    over its sample group carries both sums (a plain ``all_reduce`` on the
    dual sums the primal and leaves each rank its own tangent), the gather
    over its spectral group both blocks."""
    shape = dict(zip(TAGS, MESHES))[tag]
    d = load(ranks, "dual", tag)
    for rank in range(4):
        c, r = d[f"r{rank}_coordinate"]
        total = sum(c + q + 1 for q in range(shape[1]))
        np.testing.assert_array_equal(d[f"r{rank}_sum_primal"], np.full((2, 3), total))
        np.testing.assert_array_equal(d[f"r{rank}_sum_tangent"], np.full((2, 3), 10 * total))
        rows = np.concatenate([np.full((2, 3), q + r + 1) for q in range(shape[0])])
        np.testing.assert_array_equal(d[f"r{rank}_gather_primal"], rows)
        np.testing.assert_array_equal(d[f"r{rank}_gather_tangent"], 10 * rows)


def test_render_sharded_equals_reference(ranks, mono_single):
    """The reference's ``render_sharded`` on a (2, 2) mesh of the virtual CPU
    devices, on the same compiled scene and seed: the budget rounds up to
    whole chunks of whole rank slices alike."""
    exp = RefExperiment(**dryrun.atmosphere_kwargs("plane_parallel"))
    m = exp.measures[0]
    scene, sensor, config = exp.compile_scene(m, exp.spectral_context(m))
    mesh = ref_make_render_mesh(2, 2, devices=jax.devices()[:4])
    ref = ref_render_sharded(scene, sensor, config, 33, seed=dryrun.SEED, mesh=mesh)
    out = load(ranks, "spp33", "2x2")
    assert int(out["spp"]) == ref["spp"] == 34
    assert int(load(ranks, "spp33", "1x4")["spp"]) == 36
    for k in ("radiance", "m2"):
        np.testing.assert_allclose(out[k], np.asarray(ref[k]), rtol=1e-5, atol=0, err_msg=k)


def test_canopy_sharded_matches_reference(ranks, mono_single):
    """The sharded small HET01 against the reference's sharded canopy on a
    (2, 2) mesh, under the canopy gate (|z| <= 5, 2e-3, median 1e-4)."""
    exp = RefCanopyExperiment(**dryrun.canopy_kwargs(ref_biosphere, {"type": "volpath"}))
    m = exp.measures[0]
    scene, sensor, config, leaf_params, leaves, tris, tri_params = exp.compile_canopy_scene(
        m, exp.spectral_context(m))
    spp = dryrun.FAMILIES["canopy"][1]
    seed = int(eradiate_tpu.SeedState(dryrun.SEED).next())  # the seed run() draws
    ref = ref_render_canopy_sharded(
        scene, leaf_params, leaves, sensor, config, spp, seed=seed,
        mesh=ref_make_render_mesh(2, 2, devices=jax.devices()[:4]), tris=tris,
        tri_params=tri_params)
    out = load(ranks, "canopy", "2x2")
    assert int(out["spp"]) == ref["spp"] == spp
    rad, rad_ref = out["radiance"], np.asarray(ref["radiance"])
    var = (np.maximum(out["m2"] - rad**2, 0) + np.maximum(np.asarray(ref["m2"]) - rad_ref**2, 0))
    z = np.abs(rad - rad_ref) / np.sqrt(var / spp)
    rel = np.abs(rad - rad_ref) / np.abs(rad_ref)
    assert z.max() <= 5.0
    assert rel.max() <= 2e-3
    assert np.median(rel) <= 1e-4


def test_auto_mesh_in_a_process_group(ranks):
    """With four ranks up, ``mesh="auto"`` is (1, 4) and renders as that mesh
    bit for bit; ``ERADIATE_TPU_MESH=none`` turns it off."""
    auto = np.load(ranks / "auto.npz")
    assert tuple(auto["shape"]) == (1, 4)
    assert bool(auto["off_is_none"])
    explicit = load(ranks, "plane_parallel", "1x4")
    for k in ("radiance", "m2"):
        np.testing.assert_array_equal(auto[k], explicit[k])


def test_auto_without_process_group_is_single_device(mono_single, monkeypatch):
    monkeypatch.delenv("ERADIATE_TPU_MESH", raising=False)
    assert resolve_mesh("auto", "cpu") is None
    results = {}
    for mesh in ("auto", None):
        exp = dryrun.experiment("plane_parallel")
        eradiate_tpu_torch.run(exp, spp=16, seed_state=eradiate_tpu_torch.SeedState(3),
                               mesh=mesh, device="cpu")
        results[mesh] = exp.measures[0].results["raw"]
    for k in ("radiance", "m2"):
        np.testing.assert_array_equal(results["auto"][k], results[None][k])
    with pytest.raises(ValueError, match="mesh must be"):
        resolve_mesh("all", "cpu")


def test_spectral_axis_must_divide_the_rows(mono_single):
    """Validation comes before any collective; a stand-in mesh of three
    spectral ranks over the two rows is refused."""
    exp = dryrun.experiment("plane_parallel")
    m = exp.measures[0]
    scene, sensor, config = exp.compile_scene(m, exp.spectral_context(m))
    mesh = types.SimpleNamespace(shape=(3, 1), mesh_dim_names=("spectral", "sample"),
                                 device_type="cpu")
    with pytest.raises(ValueError, match="spectral batch 2 not divisible by mesh axis 3"):
        parallel.render_sharded(scene, sensor, config, 8, mesh=mesh)


def test_no_process_group_no_fallback(monkeypatch):
    """Without a process group a mesh cannot be made, ``initialize`` with no
    coordinator starts nothing, and asking for CUDA without a card raises."""
    for name in ("ERADIATE_TPU_COORDINATOR", "MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="no process group"):
        parallel.make_render_mesh(1, 1, "cpu")
    assert parallel.initialize() is False
    assert not torch.distributed.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            parallel.initialize("localhost:1", 2, 0)
        assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("spp_local, n_sample", [(1, 4), (17, 2), (9, 4), (64, 3)])
def test_lane_hooks_tile_the_global_sample_ids(spp_local, n_sample):
    """The ranks of a sample axis together trace every id of each pixel's
    ``n_sample spp_local`` once; the defaults are the single-device plan."""
    n_pix = 5
    ids = []
    for r in range(n_sample):
        _, _, _, first, quota = lane_partition(n_pix, spp_local, 64, "cpu",
                                               spp_local * n_sample, r * spp_local)
        ids.append(torch.cat([f + torch.arange(q) for f, q in zip(first, quota)]))
    stride = spp_local * n_sample
    assert torch.equal(torch.sort(torch.cat(ids)).values, torch.arange(n_pix * stride))
    plain = lane_partition(n_pix, spp_local, 64, "cpu")
    hooked = lane_partition(n_pix, spp_local, 64, "cpu", spp_local, 0)
    for a, b in zip(plain[1:], hooked[1:]):
        assert torch.equal(a, b)
