"""Collision fetch: the CUDA kernel's wrapper and its plain twin.

:func:`collision_fetch` inverts the cumulative vertical optical-depth table
at each lane's sampled tau and fetches that layer's per-layer table values
(albedo, phase weights, Rayleigh depolarisation for c1). For CUDA tensors it
launches ``csrc/collision_fetch.cu``: float32 tensors its float32 kernel,
float64 tensors (the double modes) its float64 build; for CPU tensors it
runs :func:`collision_fetch_plain`. It never falls back from one to the
other, and any other dtype, or mixed dtypes, raise.
The kernel's search (a branch-free walk down the levels staged as a tree,
a fixed number of trips) is emulated in numpy by
:mod:`eradiate_tpu_torch.test_tools.collision_fetch`.
"""

from __future__ import annotations

import ctypes

import torch

from .dual import refuse_tangents, tangent

__all__ = ["collision_fetch", "collision_fetch_plain", "launches", "MAX_LEVELS"]

#: Kernel launches made by :func:`collision_fetch` in this process, by
#: build: ``launches`` the float32 kernel's, ``launches_f64`` the float64
#: build's.
launches = 0
launches_f64 = 0

#: The most levels (L + 1) the kernels take: their search tree, 2^T values
#: with T = ceil(log2(L + 2)), then fills 64 KB (float32) or 128 KB
#: (float64) of shared memory.
MAX_LEVELS = 12288

_launchers = {}


def collision_fetch_plain(tau_q, z_levels, tau_levels, tables):
    """Plain PyTorch version of the kernel (searchsorted and gathers).

    ``tau_q`` [B], ``z_levels``/``tau_levels`` [L+1], ``tables`` [K, L].
    Returns ``(z [B], layer [B] int32, fetched [K, B])``.
    """
    L = tables.shape[1]
    layer = torch.clamp(
        torch.searchsorted(tau_levels, tau_q, right=True, out_int32=True) - 1,
        0,
        L - 1,
    )
    i = layer.long()
    t0 = tau_levels[i]
    t1 = tau_levels[i + 1]
    z0 = z_levels[i]
    z1 = z_levels[i + 1]
    frac = torch.clamp((tau_q - t0) / torch.clamp(t1 - t0, min=1e-30), 0.0, 1.0)
    return z0 + frac * (z1 - z0), layer, tables[:, i]


def _get_launcher(dtype):
    if dtype not in _launchers:
        from ._build import library

        name = "collision_fetch_launch" if dtype == torch.float32 else "collision_fetch_f64_launch"
        fn = getattr(library(), name)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launchers[dtype] = fn
    return _launchers[dtype]


def _check(tau_q, z_levels, tau_levels, tables):
    named = {"tau_q": tau_q, "z_levels": z_levels, "tau_levels": tau_levels,
             "tables": tables}
    if tau_q.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tau_q must be float32 or float64, got {tau_q.dtype}")
    for name, t in named.items():
        if t.device != tau_q.device:
            raise ValueError(f"{name} is on {t.device}, tau_q on {tau_q.device}")
        if t.dtype != tau_q.dtype:
            raise TypeError(f"{name} is {t.dtype}, tau_q {tau_q.dtype}: one dtype for all")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tau_q.ndim != 1 or tables.ndim != 2:
        raise ValueError("tau_q must be [B] and tables [K, L]")
    K, L = tables.shape
    if L < 1 or K < 1:
        raise ValueError(f"tables must be [K >= 1, L >= 1], got {tuple(tables.shape)}")
    if tuple(tau_levels.shape) != (L + 1,) or tuple(z_levels.shape) != (L + 1,):
        raise ValueError(
            f"tau_levels and z_levels must be [{L + 1}], got "
            f"{tuple(tau_levels.shape)} and {tuple(z_levels.shape)}"
        )
    if L + 1 > MAX_LEVELS:
        raise ValueError(
            f"{L + 1} levels: the kernel's search tree holds at most {MAX_LEVELS} in "
            "shared memory"
        )
    if tau_q.shape[0] >= 2**31:
        raise ValueError("more than 2^31 - 1 lanes")


class _CollisionFetchRule(torch.autograd.Function):
    """:func:`collision_fetch` with a forward rule for a tangent on
    ``tables``: the fetched tangent is the fetch of the tangent tables at
    the same queries and levels (the same bracket, so the same layer); z and
    the layer have none."""

    @staticmethod
    def forward(tau_q, z_levels, tau_levels, tables):
        return _collision_fetch(tau_q, z_levels, tau_levels, tables)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_forward(*inputs[:3])

    @staticmethod
    def jvp(ctx, d_tau_q, d_z_levels, d_tau_levels, d_tables):
        tau_q, z_levels, tau_levels = ctx.saved_tensors
        fetched = _collision_fetch(tau_q, z_levels, tau_levels, d_tables.contiguous())[2]
        return torch.zeros_like(tau_q), None, fetched


def collision_fetch(tau_q, z_levels, tau_levels, tables):
    """Search-and-fetch at each lane's sampled tau (reference
    ``medium.collision_fetch``, with the layer tables stacked as one
    contiguous ``[K, L]`` tensor).

    Returns ``(z [B], layer [B] int32, fetched [K, B])``. CUDA tensors go
    through the kernel of their dtype, float32 or float64 (the wrapper
    checks device, dtype, contiguity and shapes, and raises if the launch
    fails); CPU tensors through :func:`collision_fetch_plain`. A
    forward-mode tangent on ``tables`` is carried by the rule (a second
    launch, on the tangent tables); one on the other operands raises.
    """
    refuse_tangents("collision_fetch", tau_q=tau_q, z_levels=z_levels, tau_levels=tau_levels)
    if tangent(tables) is not None:
        return _CollisionFetchRule.apply(tau_q, z_levels, tau_levels, tables)
    return _collision_fetch(tau_q, z_levels, tau_levels, tables)


def _collision_fetch(tau_q, z_levels, tau_levels, tables):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    global launches, launches_f64
    if tau_q.device.type == "cpu":
        return collision_fetch_plain(tau_q, z_levels, tau_levels, tables)
    if tau_q.device.type != "cuda":
        raise ValueError(f"collision_fetch runs on cuda or cpu, not {tau_q.device}")
    _check(tau_q, z_levels, tau_levels, tables)
    K, L = tables.shape
    B = tau_q.shape[0]
    z = torch.empty_like(tau_q)
    layer = torch.empty(B, dtype=torch.int32, device=tau_q.device)
    fetched = torch.empty((K, B), dtype=tau_q.dtype, device=tau_q.device)
    if B == 0:
        return z, layer, fetched
    launch = _get_launcher(tau_q.dtype)
    with torch.cuda.device(tau_q.device):
        rc = launch(
            tau_q.data_ptr(), z_levels.data_ptr(), tau_levels.data_ptr(),
            tables.data_ptr(), z.data_ptr(), layer.data_ptr(),
            fetched.data_ptr(), B, L, K,
            torch.cuda.current_stream(tau_q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"collision_fetch kernel launch failed: CUDA error {rc}")
    if tau_q.dtype == torch.float64:
        launches_f64 += 1
    else:
        launches += 1
    return z, layer, fetched
