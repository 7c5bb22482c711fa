"""BSDF angular probe utility (port of ``eradiate_tpu/test_tools/bsdf_probe.py``).

Mirror of the reference's ``eval_bsdf`` test helper
(``src/eradiate/kernel/_bsdf.py:25-52``): evaluate a BSDF kind over
outgoing/incident angular grids and return a dataset with dims
``(theta_o, phi_o, theta_i, phi_i)``. The BSDF runs through the port's
:func:`eradiate_tpu_torch.ops.bsdf_ops.bsdf_eval` on torch tensors on
``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import xr
from ..core.device import resolve_device

__all__ = ["eval_bsdf"]


def _sph_to_dir(theta, phi):
    st, ct = np.sin(theta), np.cos(theta)
    sp, cp = np.sin(phi), np.cos(phi)
    return np.stack(np.broadcast_arrays(cp * st, sp * st, ct), axis=-1)


def eval_bsdf(kind, params, theta_os, phi_os, theta_is, phi_is, device="cuda") -> "xr.Dataset":
    """Probe ``f(wi, wo)`` [1/sr] over angular grids on ``device``.

    ``kind``/``params`` as accepted by
    :func:`eradiate_tpu_torch.ops.bsdf_ops.bsdf_eval` (parameter values as
    numbers, numpy arrays or tensors); angles in radians, evaluated in
    float64. Convention note: like the reference helper, directions here
    point AWAY from the surface on the upper hemisphere (``theta`` measured
    from +z), and ``theta_i``/``phi_i`` give the incident (sun-side)
    direction.
    """
    from ..ops.bsdf_ops import bsdf_eval

    dev = resolve_device(device)
    theta_os = np.atleast_1d(np.asarray(theta_os, np.float64))
    phi_os = np.atleast_1d(np.asarray(phi_os, np.float64))
    theta_is = np.atleast_1d(np.asarray(theta_is, np.float64))
    phi_is = np.atleast_1d(np.asarray(phi_is, np.float64))

    to, po, ti, pi_ = np.meshgrid(theta_os, phi_os, theta_is, phi_is, indexing="ij")
    wo = torch.as_tensor(_sph_to_dir(to.ravel(), po.ravel()), device=dev)
    wi = torch.as_tensor(_sph_to_dir(ti.ravel(), pi_.ravel()), device=dev)
    params = {k: torch.as_tensor(v, dtype=torch.float64, device=dev) for k, v in params.items()}
    vals = bsdf_eval(kind, params, wi, wo).cpu().numpy().reshape(to.shape)

    return xr.Dataset(
        {
            "bsdf": xr.DataArray(
                vals,
                dims=("theta_o", "phi_o", "theta_i", "phi_i"),
                attrs={"units": "sr^-1"},
                name="bsdf",
            )
        },
        coords={
            "theta_o": theta_os,
            "phi_o": phi_os,
            "theta_i": theta_is,
            "phi_i": phi_is,
        },
    )
