# Host-code copy of eradiate_tpu/plot.py; regenerate with tools/copy_host_code.py, do not edit.
"""Plotting helpers.

Mirror of ``src/eradiate/plot.py`` (mpl style + axis utilities) plus the
BRF-oriented visualizations this framework's outputs call for. matplotlib
is imported lazily so headless / plotting-free deployments never pay for
it.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "set_style",
    "detect_axes",
    "remove_xylabels",
    "remove_xyticks",
    "make_ticks",
    "plot_brf_hplane",
    "plot_brf_polar",
]


def _mpl():
    import matplotlib.pyplot as plt

    return plt


def set_style(rc=None):
    """Apply the framework's matplotlib style (reference ``plot.py:20``)."""
    plt = _mpl()
    defaults = {
        "figure.dpi": 110,
        "axes.grid": True,
        "grid.alpha": 0.3,
        "axes.spines.top": False,
        "axes.spines.right": False,
        "legend.frameon": False,
        "font.size": 10,
    }
    if rc:
        defaults.update(rc)
    plt.rcParams.update(defaults)


def detect_axes(from_=None):
    """Normalize figures/axes input into a list of Axes
    (reference ``plot.py:46``)."""
    plt = _mpl()
    from matplotlib.axes import Axes
    from matplotlib.figure import Figure

    if from_ is None:
        from_ = plt.gca()
    if isinstance(from_, Figure):
        return from_.axes
    if isinstance(from_, Axes):
        return [from_]
    if isinstance(from_, (list, tuple)):
        if all(isinstance(x, Axes) for x in from_):
            return list(from_)
    raise TypeError("unsupported input type for axis detection")


def remove_xylabels(from_=None):
    """Strip x/y axis labels (reference ``plot.py:116``)."""
    for ax in detect_axes(from_):
        ax.set_xlabel("")
        ax.set_ylabel("")


def remove_xyticks(from_=None):
    """Strip x/y axis ticks (reference ``plot.py:136``)."""
    for ax in detect_axes(from_):
        ax.get_xaxis().set_ticks([])
        ax.get_yaxis().set_ticks([])


def make_ticks(num_ticks: int, limits):
    """Equally spaced tick positions + degree labels over ``limits``
    (reference ``plot.py:156``)."""
    start, stop = limits
    step = (stop - start) / (num_ticks - 1) if num_ticks > 1 else 0.0
    steps = [start + step * i for i in range(num_ticks)]
    labels = [f"{int(round(np.rad2deg(x)))}°" for x in steps]
    return steps, labels


def _get(var):
    """xarray.DataArray | eradiate_tpu.xr.DataArray | ndarray -> ndarray."""
    values = getattr(var, "values", var)
    return np.asarray(values)


def plot_brf_hplane(result, var="brf", ax=None, **kwargs):
    """Principal-plane BRF plot: signed viewing zenith on x.

    ``result``: dataset from :func:`eradiate_tpu.run` for an hplane
    mdistant measure (carries a signed ``vza`` coordinate).
    """
    plt = _mpl()
    if ax is None:
        _, ax = plt.subplots()
    data = result[var]
    vza = np.asarray(data.coords["vza"]) if "vza" in data.coords else None
    y = _get(data).squeeze()
    if vza is None:
        vza = np.arange(y.shape[-1])
    ax.plot(vza, np.atleast_2d(y).T, **kwargs)
    ax.set_xlabel("Viewing zenith angle [deg]")
    ax.set_ylabel(var.upper())
    return ax


def plot_brf_polar(result, var="brf", ax=None, cmap="viridis", **kwargs):
    """Polar (azimuth x zenith) BRF map for hemispherical measures
    (hdistant/grid layouts). Scatter-based: works for any direction
    layout."""
    plt = _mpl()
    if ax is None:
        _, ax = plt.subplots(subplot_kw={"projection": "polar"})
    data = result[var]
    zen = np.asarray(data.coords["zenith"]) if "zenith" in data.coords else None
    azi = np.asarray(data.coords["azimuth"]) if "azimuth" in data.coords else None
    y = _get(data).squeeze()
    if zen is None or azi is None:
        raise ValueError("polar plot needs zenith/azimuth coordinates")
    sc = ax.scatter(
        np.deg2rad(azi), zen, c=np.atleast_1d(y).ravel(), cmap=cmap, **kwargs
    )
    ax.figure.colorbar(sc, ax=ax, label=var.upper())
    ax.set_theta_zero_location("E")
    return ax
