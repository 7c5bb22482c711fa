"""The port's command line (``python -m eradiate_tpu_torch.cli``) against
the JAX package's, on the CPU.

One small JSON config (3 views, 16 spp, a Lambertian floor under the
default atmosphere: ``tests/system/test_cli_render.py``'s) renders through
``python -m eradiate_tpu.cli render --platform cpu --mesh none`` and
``python -m eradiate_tpu_torch.cli render --platform cpu --mesh none`` with the
same ``ERADIATE_TPU_RNG_SEED``: every array of the two ``.npz`` files agrees
within 1e-5 relative. Two port processes started through the
``ERADIATE_TPU_COORDINATOR``, ``..._NUM_PROCESSES`` and ``..._PROCESS_ID``
variables render it over gloo with ``--mesh auto``: rank 0 alone writes, and
its result is the one-process render's within 1e-5. Without a card and
without ``--platform cpu``, ``render`` exits non-zero and names the missing
device; ``--cpu-devices`` other than 1 is refused (torch has no virtual CPU
devices). ``sys-info``, ``data paths`` and ``srf trim`` mirror
``tests/unit/test_tools_and_cli.py``; ``data install``, ``installed`` and
``remove`` round-trip in a data directory under the test's own temporary
path, which the JAX package's asset manager reads too.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

CONFIG = {
    "mode": "mono_single",
    "illumination": {"type": "directional", "zenith": 30.0, "azimuth": 0.0},
    "measures": {"type": "mdistant", "construct": "hplane", "zeniths": [-30.0, 0.0, 30.0],
                 "azimuth": 0.0, "spp": 16, "id": "m"},
    "surface": {"type": "lambertian", "reflectance": 0.5},
}


def _env(**extra):
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu", "ERADIATE_TPU_MESH": ""})
    env.update(extra)
    return env


def cli(package, *args, timeout=300, **env):
    return subprocess.run([sys.executable, "-m", f"{package}.cli", *map(str, args)],
                          capture_output=True, text=True, cwd=REPO, timeout=timeout,
                          env=_env(**env))


def port(*args, **env):
    return cli("eradiate_tpu_torch", *args, **env)


@pytest.fixture
def cfg_file(tmp_path):
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(CONFIG))
    return path


def arrays(path):
    data = np.load(path)
    return {k: data[k] for k in data.files if k != "__meta__"}


def test_render_matches_the_reference_cli(cfg_file, tmp_path):
    outs = {}
    for package in ("eradiate_tpu", "eradiate_tpu_torch"):
        outs[package] = tmp_path / f"{package}.npz"
        r = cli(package, "render", cfg_file, "-o", outs[package], "--platform", "cpu",
                "--mesh", "none", ERADIATE_TPU_RNG_SEED="11")
        assert r.returncode == 0, r.stderr[-2000:]
    ref, out = arrays(outs["eradiate_tpu"]), arrays(outs["eradiate_tpu_torch"])
    assert out.keys() == ref.keys() and "var__brf" in out
    for k, v in ref.items():
        assert out[k].shape == v.shape, k
        np.testing.assert_allclose(out[k], v, rtol=1e-5, atol=0, err_msg=k)
    assert np.load(outs["eradiate_tpu_torch"])["var__brf"].min() > 0.0


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_over_gloo(cfg_file, tmp_path):
    single = tmp_path / "single.npz"
    r = port("render", cfg_file, "-o", single, "--platform", "cpu", "--mesh", "none",
             ERADIATE_TPU_RNG_SEED="11")
    assert r.returncode == 0, r.stderr[-2000:]
    address = f"localhost:{_free_port()}"
    outs = [tmp_path / f"rank{i}.npz" for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "eradiate_tpu_torch.cli", "render", str(cfg_file), "-o",
             str(outs[rank]), "--mesh", "auto", "--platform", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
            env=_env(ERADIATE_TPU_COORDINATOR=address, ERADIATE_TPU_NUM_PROCESSES="2",
                     ERADIATE_TPU_PROCESS_ID=str(rank), ERADIATE_TPU_RNG_SEED="11"))
        for rank in range(2)
    ]
    try:
        results = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-2000:]
    assert outs[0].exists() and not outs[1].exists()  # only rank 0 writes
    assert "results ->" in results[0][0] and results[1][0] == ""
    sharded, ref = arrays(outs[0]), arrays(single)
    assert sharded.keys() == ref.keys()
    for k in ("var__radiance", "var__brf"):
        np.testing.assert_allclose(sharded[k], ref[k], rtol=1e-5, err_msg=k)


def test_render_without_a_card_fails_and_names_it(cfg_file, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    out = tmp_path / "res.npz"
    r = port("render", cfg_file, "-o", out)
    assert r.returncode != 0
    assert "CUDA" in r.stderr and "--platform cpu" in r.stderr
    assert not out.exists()


@pytest.mark.parametrize("n", [4, 2])
def test_cpu_devices_above_one_is_refused(cfg_file, tmp_path, n):
    out = tmp_path / "res.npz"
    r = port("render", cfg_file, "-o", out, "--platform", "cpu", "--cpu-devices", n)
    assert r.returncode != 0
    assert f"--cpu-devices {n}" in r.stderr and "torchrun" in r.stderr
    assert "ERADIATE_TPU_COORDINATOR" in r.stderr
    assert not out.exists()


def test_cpu_devices_one_is_accepted(cfg_file, tmp_path):
    out = tmp_path / "res.npz"
    r = port("render", cfg_file, "-o", out, "--platform", "cpu", "--cpu-devices", 1,
             "--mesh", "none")
    assert r.returncode == 0, r.stderr[-2000:]
    assert np.isfinite(arrays(out)["var__brf"]).all()
    assert "render:" in r.stdout and "on cpu" in r.stdout


def test_sys_info():
    r = port("sys-info")
    assert r.returncode == 0, r.stderr
    info = json.loads(r.stdout)
    assert info["eradiate_tpu_torch"] == __import__("eradiate_tpu_torch").__version__
    assert info["torch"] == torch.__version__ and info["default_device"] == "cuda"
    assert info["devices"][0] == "cpu" and "numpy" in info and "cuda" in info


def test_data_paths():
    r = port("data", "paths")
    assert r.returncode == 0, r.stderr
    assert "eradiate_tpu_torch" in r.stdout and "store" in r.stdout


def test_data_list_shows_the_packaged_store():
    r = port("data", "list")
    assert r.returncode == 0, r.stderr
    assert "srf/sentinel_2a-msi-4.npz" in r.stdout
    assert "aerosol/govaerts_2021-continental.npz" in r.stdout


def test_srf_trim_roundtrip(tmp_path):
    w = np.linspace(400, 600, 101)
    v = np.exp(-0.5 * ((w - 500) / 10) ** 2)
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, w=w, srf=v)
    r = port("srf", "trim", src, dst)
    assert r.returncode == 0, r.stderr
    assert np.load(dst)["w"].size < 101


def test_data_install_and_remove(tmp_path, monkeypatch):
    data_dir = tmp_path / "data"
    monkeypatch.setenv("ERADIATE_TPU_DATA_PATH", str(data_dir))
    src = tmp_path / "bundle"
    (src / "srf").mkdir(parents=True)
    np.savez(src / "srf" / "custom-band.npz", w=np.array([500.0, 510.0]), srf=np.ones(2))
    r = port("data", "install", src, "--name", "bundle")
    assert r.returncode == 0, r.stderr
    assert (data_dir / "bundle" / "srf" / "custom-band.npz").exists()
    r = port("data", "installed")
    assert r.returncode == 0 and r.stdout.startswith("bundle\t")
    # one installed dataset serves both packages
    from eradiate_tpu.data.asset_manager import list_installed

    assert set(list_installed()) == {"bundle"}
    assert port("data", "remove", "bundle").returncode == 0
    assert not (data_dir / "bundle").exists()
    r = port("data", "remove", "bundle")
    assert r.returncode == 1 and "no installed asset" in r.stderr
    assert port("data", "installed").stdout == ""
