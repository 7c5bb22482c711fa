# Host-code copy of eradiate_tpu/xarray_utils.py; regenerate with tools/copy_host_code.py, do not edit.
"""Labeled-array post-processing utilities.

Mirror of ``src/eradiate/xarray/interp.py`` (``film_to_angular``,
``dataarray_to_rgb``) operating on this package's lightweight labeled
arrays (:mod:`eradiate_tpu.xr`) or plain numpy/xarray inputs.
"""

from __future__ import annotations

import numpy as np

from .core.warp import uniform_hemisphere_to_square

__all__ = ["film_to_angular", "dataarray_to_rgb"]


def _values(da):
    return np.asarray(getattr(da, "values", da))


def film_to_angular(da, theta, phi, film_shape=None):
    """Resample a 2D hemispherical film onto an angular (theta, phi) grid.

    Mirror of ``xarray/interp.py:15`` for the engine's hdistant film
    parametrization: film uv in [0, 1)^2 maps to hemisphere directions via
    ``square_to_uniform_hemisphere`` (``core/warp.py``), so each requested
    angle pair lands at the exact inverse film coordinate and is read with
    bilinear interpolation.

    Parameters
    ----------
    da : array-like
        Film data, shape [nx, ny] (x-major, matching
        ``HemisphericalDistantMeasure.film_shape``) — or flattened over
        pixels with ``film_shape`` given.
    theta, phi : array-like
        Target angles [rad].
    film_shape : tuple, optional
        (nx, ny) when ``da`` is flattened.

    Returns
    -------
    ndarray of shape [len(theta), len(phi)]
    """
    data = _values(da)
    if film_shape is not None:
        data = data.reshape(*data.shape[:-1], *film_shape)
    if data.ndim > 2:
        data = data.reshape(-1, *data.shape[-2:])[0]
    nx, ny = data.shape

    theta = np.atleast_1d(np.asarray(theta, dtype=np.float64))
    phi = np.atleast_1d(np.asarray(phi, dtype=np.float64))
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    d = np.stack(
        [
            np.sin(tt) * np.cos(pp),
            np.sin(tt) * np.sin(pp),
            np.cos(tt),
        ],
        axis=-1,
    )
    uv = uniform_hemisphere_to_square(d)
    fu = np.clip(uv[..., 0], 0.0, 1.0)
    fv = np.clip(uv[..., 1], 0.0, 1.0)

    # bilinear interpolation on pixel centers
    gx = np.clip(fu * nx - 0.5, 0.0, nx - 1.0)
    gy = np.clip(fv * ny - 0.5, 0.0, ny - 1.0)
    x0 = np.floor(gx).astype(int)
    y0 = np.floor(gy).astype(int)
    x1 = np.minimum(x0 + 1, nx - 1)
    y1 = np.minimum(y0 + 1, ny - 1)
    wx = gx - x0
    wy = gy - y0
    return (
        data[x0, y0] * (1 - wx) * (1 - wy)
        + data[x1, y0] * wx * (1 - wy)
        + data[x0, y1] * (1 - wx) * wy
        + data[x1, y1] * wx * wy
    )


def dataarray_to_rgb(das, channels=None, normalize=True, gamma=1.0 / 2.2):
    """Stack three spectral slices into an RGB image
    (mirror of ``xarray/interp.py:110``).

    Parameters
    ----------
    das : array-like or sequence of three arrays
        Either one array with a leading spectral axis plus ``channels``
        selecting (r, g, b) indices, or a sequence of three 2D arrays.
    normalize : bool
        Scale to [0, 1] by the global max.
    gamma : float
        Display gamma applied after normalization.
    """
    if channels is not None:
        data = _values(das)
        imgs = [data[c] for c in channels]
    else:
        imgs = [_values(d) for d in das]
    if len(imgs) != 3:
        raise ValueError("rgb conversion needs exactly three channels")
    rgb = np.stack(imgs, axis=-1).astype(np.float64)
    if normalize:
        peak = rgb.max()
        if peak > 0:
            rgb = rgb / peak
    rgb = np.clip(rgb, 0.0, 1.0) ** gamma
    return rgb
