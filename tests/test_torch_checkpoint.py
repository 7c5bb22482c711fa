"""Checkpoints and profiling counters of the port (after the reference's
``tests/unit/test_profiling_checkpoint.py``).

``eradiate_tpu_torch.checkpoint`` is a host-code copy; held here through
the port's ``run``: a round trip, a fingerprint mismatch that restarts, a
resume from a complete and from a partial checkpoint equal to the
uninterrupted run bit for bit, and, on two gloo ranks spawned by the dry run
(``eradiate_tpu_torch.parallel.dryrun``), ranks sharing one directory (rank
0 writes: one readable file, no temporary left) and ranks resuming from
their own directories with unequal progress (every rank resumes from the
fewest chunks, and the result equals the uninterrupted run bit for bit).
``profiling``: one ``stats`` record a measure, the ``torch.profiler`` trace
written on the CPU, a named range.
"""

import json

import numpy as np
import pytest
import torch

import eradiate_tpu_torch
from eradiate_tpu_torch.checkpoint import RenderCheckpoint
from eradiate_tpu_torch.parallel import dryrun
from eradiate_tpu_torch.profiling import RenderStats, annotate, kernel_roofline, stats, trace

torch.set_num_threads(1)

WAVELENGTHS = [440.0, 550.0, 660.0, 870.0]


def _exp(**kwargs):
    return eradiate_tpu_torch.AtmosphereExperiment(
        illumination={"type": "directional", "zenith": 30.0, "irradiance": 1.0},
        measures={
            "type": "mdistant",
            "construct": "from_angles",
            "angles": [[0.0, 0.0], [30.0, 0.0]],
            "srf": {"type": "delta", "wavelengths": WAVELENGTHS},
            "spp": 16,
            "id": "m",
        },
        surface={"type": "lambertian", "reflectance": 0.5},
        atmosphere={"type": "homogeneous", "sigma_s": 0.01, "top": 10.0},
        geometry={"type": "plane_parallel", "toa_altitude": 10.0},
        **kwargs,
    )


@pytest.fixture
def mono_single():
    eradiate_tpu_torch.set_mode("mono_single")
    yield
    eradiate_tpu_torch.set_mode("mono")


def _run(seed, checkpoint_dir=None):
    exp = _exp(spectral_chunk_size=1)
    res = eradiate_tpu_torch.run(exp, seed_state=eradiate_tpu_torch.SeedState(seed),
                                 checkpoint_dir=checkpoint_dir, mesh=None, device="cpu")
    return exp, np.asarray(res["radiance"])


def test_checkpoint_roundtrip(tmp_path):
    cp = RenderCheckpoint(tmp_path)
    w = np.array([500.0, 600.0])
    raws = [
        {"radiance": np.ones((2, 3)), "m2": np.ones((2, 3)), "spp": 16},
        {"radiance": np.full((2, 3), 2.0), "m2": np.ones((2, 3)), "spp": 16},
    ]
    cp.save("m", 16, w, raws)
    loaded, n_done = cp.load("m", 16, w)
    assert n_done == 2
    np.testing.assert_array_equal(loaded[1]["radiance"], 2.0)
    assert loaded[0]["spp"] == 16
    assert sorted(p.name for p in tmp_path.iterdir()) == ["m.npz"]
    cp.clear("m")
    assert cp.load("m", 16, w) == ([], 0)


def test_fingerprint_mismatch_restarts(tmp_path):
    cp = RenderCheckpoint(tmp_path)
    w = np.array([500.0, 600.0])
    cp.save("m", 16, w, [{"radiance": np.ones(2), "spp": 16}])
    assert cp.load("m", 32, w) == ([], 0)
    assert cp.load("m", 16, w * 2) == ([], 0)
    assert cp.load("other", 16, w) == ([], 0)
    assert cp.load("m", 16, w)[1] == 1


def test_resume_equals_uninterrupted_run(mono_single, tmp_path):
    """A complete checkpoint renders nothing more and gives the
    uninterrupted run's radiance bit for bit."""
    _, rad_a = _run(123)
    _run(123, tmp_path / "ckpt")
    stats.clear()
    _, rad_c = _run(123, tmp_path / "ckpt")
    np.testing.assert_array_equal(rad_a, rad_c)
    assert stats.last.n_paths == 0  # every chunk came from the checkpoint


def test_partial_resume(mono_single, tmp_path):
    """The first two of four chunks from a checkpoint, the rest rendered with
    the seeds they draw after the skipped ones."""
    _, rad_ref = _run(7)
    exp, _ = _run(7, tmp_path / "ckpt")
    cp = RenderCheckpoint(tmp_path / "ckpt")
    w = exp.spectral_context(exp.measures[0])["w"]
    raws, n_done = cp.load("m", 16, w)
    assert n_done == 4
    cp.save("m", 16, w, raws[:2])
    stats.clear()
    _, rad_res = _run(7, tmp_path / "ckpt")
    np.testing.assert_array_equal(rad_ref, rad_res)
    assert stats.last.n_paths == 2 * 2 * 16  # two chunks of one row, two pixels
    assert RenderCheckpoint(tmp_path / "ckpt").load("m", 16, w)[1] == 4


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("checkpoint_ranks")
    dryrun.run_ranks(2, [(1, 2)], "cpu", "gloo", out, cases=("checkpoint",), timeout=300)
    return np.load(out / "checkpoint.npz")


def test_ranks_sharing_a_directory_leave_one_file(two_ranks):
    assert list(two_ranks["shared_files"]) == ["m.npz"]


def test_ranks_resume_from_the_fewest_chunks(two_ranks):
    """Rank 0's directory holds both chunks, rank 1's the first: both
    resume after the first (resuming after the second on rank 0 alone would
    leave rank 1 alone in the collectives), and every rank's result is the
    uninterrupted run's."""
    assert bool(two_ranks["agree"])
    for k in ("radiance", "m2"):
        np.testing.assert_array_equal(two_ranks[f"resumed_{k}"], two_ranks[f"full_{k}"])
    assert two_ranks["full_radiance"].shape == (2, 3)


def test_render_stats_recorded(mono_single):
    stats.clear()
    exp = _exp()
    exp.measures.append(_exp().measures[0])
    exp.measures[1].id = "m2"
    eradiate_tpu_torch.run(exp, mesh=None, device="cpu")
    assert [r.label for r in stats.records] == ["measure:m", "measure:m2"]
    # 4 wavelengths x 2 pixels x 16 spp
    assert stats.last.n_paths == 4 * 2 * 16
    assert stats.last.samples_per_s > 0
    summary = stats.summary()
    assert summary["n_renders"] == 2
    assert summary["total_paths"] == 2 * stats.last.n_paths


def test_render_stats_isolated():
    s = RenderStats()
    assert s.summary()["n_renders"] == 0
    s.record("x", wall_s=2.0, spectral_size=10, n_pixels=5, spp=4)
    assert s.last.n_paths == 200
    assert s.last.samples_per_s == 100.0
    s.clear()
    assert s.last is None


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(tmp_path / "trace"):
        with annotate("unit-test-scope"):
            torch.ones(64).cumsum(0)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "unit-test-scope" for e in events)


def test_roofline_names_the_h100():
    r = kernel_roofline("k", wall_s=1e-3, flops=67e9 / 2, bytes_moved=3.35e9 / 4)
    assert "H100" in r["card"]
    assert r["bound"] == "compute"
    assert r["speed_of_light_frac"] == pytest.approx(0.5)
    assert kernel_roofline("k", 1e-3, 34e9, 0, unit="f64")["frac_compute_peak"] == pytest.approx(1)
