"""The port's random streams and sample warps against the JAX package.

Keys and uniforms must be bitwise equal to ``eradiate_tpu.ops.fastrng`` and
``jax.random`` (same seed, same samples); the polynomial trig and the warps
agree to 1e-6 absolute (float32 rounding of the same formulas).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eradiate_tpu.core import warp as ref_warp
from eradiate_tpu.ops import fastmath as ref_fastmath
from eradiate_tpu.ops import fastrng as ref_rng
from eradiate_tpu_torch.core import threefry
from eradiate_tpu_torch.core import warp
from eradiate_tpu_torch.ops import fastmath, fastrng

torch.set_num_threads(1)

N = 4096


def _words(seed, n=N):
    """Full-range uint32 words, with the extremes included."""
    w = np.random.default_rng(seed).integers(0, 2**32, size=n, dtype=np.uint64)
    w[:4] = [0, 1, 2**31, 2**32 - 1]
    return w.astype(np.uint32)


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def test_pcg4d_bitwise():
    a, b, c, d = (_words(s) for s in range(4))
    ref = ref_rng.pcg4d(*(jnp.asarray(x) for x in (a, b, c, d)))
    out = fastrng.pcg4d(_t(a), _t(b), _t(c), _t(d))
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r).astype(np.int64))


def _ref_keys(kd):
    return jax.random.wrap_key_data(jnp.asarray(kd))


def test_derive_keys_bitwise():
    kd = np.stack([_words(10), _words(11)], axis=-1)
    sid = _words(12)
    ref = jax.random.key_data(
        ref_rng.derive_keys("pcg4d", _ref_keys(kd), jnp.asarray(sid))
    )
    out = fastrng.derive_keys(_t(kd), _t(sid))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref).astype(np.int64))


def test_derive_keys_broadcast_row_key():
    row = np.array([0x12345678, 0xFEDCBA98], dtype=np.uint32)
    sid = _words(13)
    full = fastrng.derive_keys(_t(np.broadcast_to(row, (N, 2))), _t(sid))
    bcast = fastrng.derive_keys(_t(row), _t(sid))
    assert torch.equal(full, bcast)


def test_bounce_uniforms_bitwise():
    kd = np.stack([_words(20), _words(21)], axis=-1)
    depth = np.random.default_rng(22).integers(0, 64, size=N).astype(np.int32)
    ref = ref_rng.bounce_uniforms("pcg4d", _ref_keys(kd), jnp.asarray(depth), 10)
    out = fastrng.bounce_uniforms(_t(kd), _t(depth), 10)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert float(out.max()) < 1.0 and float(out.min()) >= 0.0


def test_origin_uniforms_bitwise():
    kd = np.stack([_words(30), _words(31)], axis=-1)
    ref = ref_rng.origin_uniforms("pcg4d", _ref_keys(kd), 2)
    out = fastrng.origin_uniforms(_t(kd), 2)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 2**31, 2**32 - 1, 0x9E3779B9])
def test_threefry_key_fold_in(seed):
    k = jax.random.key(jnp.asarray(seed, dtype=jnp.uint32))
    assert threefry.key(seed) == tuple(int(x) for x in jax.random.key_data(k))
    for data in (0, 1, 5, 2**31 + 3, 2**32 - 1):
        ref = jax.random.key_data(jax.random.fold_in(k, jnp.uint32(data)))
        assert threefry.fold_in(threefry.key(seed), data) == tuple(
            int(x) for x in ref
        )
    # the render's row -> chunk derivation
    ref = jax.random.key_data(jax.random.fold_in(jax.random.fold_in(k, 3), 0))
    chain = threefry.fold_in(threefry.fold_in(threefry.key(seed), 3), 0)
    assert chain == tuple(int(x) for x in ref)


def _uniform_grid(seed, shape):
    u = np.random.default_rng(seed).random(shape, dtype=np.float32)
    u.reshape(-1)[:4] = [0.0, 0.25, 0.5, 1.0 - 2.0**-24]
    return u


def test_cos_sin_2pi():
    u = np.concatenate(
        [_uniform_grid(40, N), np.random.default_rng(41).uniform(-8, 8, N)]
    ).astype(np.float32)
    rc, rs = ref_fastmath.cos_sin_2pi(jnp.asarray(u))
    c, s = fastmath.cos_sin_2pi(torch.as_tensor(u))
    np.testing.assert_allclose(c.numpy(), np.asarray(rc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=0, atol=1e-6)


@pytest.mark.parametrize(
    "name", ["square_to_uniform_disk_concentric", "square_to_cosine_hemisphere"]
)
def test_warps(name):
    u = _uniform_grid(50, (N, 2))
    ref = getattr(ref_warp, name)(jnp.asarray(u))
    out = getattr(warp, name)(torch.as_tensor(u))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("cos_cutoff", [1.0, 0.99998])
def test_square_to_uniform_cone(cos_cutoff):
    u = _uniform_grid(60, (N, 2))
    cc = np.float32(cos_cutoff)
    ref = ref_warp.square_to_uniform_cone(jnp.asarray(u), jnp.asarray(cc))
    out = warp.square_to_uniform_cone(torch.as_tensor(u), torch.tensor(cc))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
