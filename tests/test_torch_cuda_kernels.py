"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and ``nvcc``: they carry the ``cuda`` marker
and skip elsewhere (the decision is taken inside a fixture, never at import
time). Run them on a machine with a card with

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

(``--noconftest``: ``tests/conftest.py`` sets up JAX's virtual CPU devices
for the reference's tests, which these tests do not use.)

They are a quick form of what ``chip_smoke.py`` checks at full size: each
leaf-sweep kernel equals its plain version bit for bit, on random disks with
rays aimed at their rims (a stress of the kernels' conservative culls), at a
ragged lane count, from origins near the disks and from origins a hundred
times farther away (where float32 rounding of the ray moves the hit point by
a sizeable part of a disk, and the culls' margins have to grow with it).
"""

import numpy as np
import pytest
import torch

from eradiate_tpu_torch.kernels import leaf_intersect as li
from eradiate_tpu_torch.ops.canopy import morton_order

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form but their plain versions")
    return torch.device("cuda")


def rim_problem(B, seed, instanced, far=False):
    rng = np.random.default_rng(seed)
    N = 700
    c = rng.uniform(-1, 1, (N, 3))
    c = c[morton_order(c)]
    n = rng.normal(size=(N, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    r = rng.uniform(0.05, 0.2, N)
    offsets = np.array([[0.0, 0, 0], [5.0, 0, 0], [0, 7.0, 0]]) if instanced else np.zeros((1, 3))
    leaf = rng.integers(0, N, B)
    u = np.cross(n[leaf], rng.normal(size=(B, 3)))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    scale = 1 + rng.choice([0.0, 1e-7, -1e-7, 1e-6, -1e-6, -0.5], B)
    rim = c[leaf] + (r[leaf] * scale)[:, None] * u + offsets[rng.integers(0, len(offsets), B)]
    back = rng.normal(size=(B, 3))
    back /= np.linalg.norm(back, axis=1, keepdims=True)
    dist = rng.uniform(0.5, 3.0, B) * (100.0 if far else 1.0)
    t_max = dist * rng.choice([2.0, 1.0, 1 + 1e-7, 1 - 1e-7], B)
    arrays = [rim + back * dist[:, None], -back, t_max, c, n, r]
    if instanced:
        arrays.append(offsets)
    return [np.asarray(a, np.float32) for a in arrays]


@pytest.mark.parametrize(
    "name", ["ray_leaves_nearest", "ray_leaves_occluded", "ray_leaves_nearest_instanced",
             "ray_leaves_occluded_instanced"]
)
@pytest.mark.parametrize("B", [1, 100_037])
@pytest.mark.parametrize("far", [False, True])
def test_leaf_kernel_equals_plain_version(card, name, B, far):
    problem = rim_problem(B, 3, name.endswith("instanced"), far)
    args = [torch.tensor(a, device=card) for a in problem]
    before = li.launches[name]
    got = getattr(li, name)(*args)
    torch.cuda.synchronize()
    assert li.launches[name] == before + 1
    want = getattr(li, name + "_plain")(*args)
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[-1].any() or B == 1
