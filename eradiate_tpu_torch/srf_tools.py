# Host-code copy of eradiate_tpu/srf_tools.py; regenerate with tools/copy_host_code.py, do not edit.
"""Spectral response function manipulation tools.

Parity implementation of ``src/eradiate/srf_tools.py`` (1,045 LoC there):
trimming (``:263``), threshold filtering (``:467``), integral filtering
with the ``walk`` and ``symmetry`` bound methods (``:527-641``), spectral
windowing (``:403``), zero padding (``:643``), summary statistics
(``:79-260``), the combined ``filter_srf`` pipeline (``:857``), plotting
(``:689``) and Gaussian synthesis (``:1003``).

Representation: plain ``(w [nm], srf)`` numpy array pairs (the package's
native SRF form) instead of xarray datasets; ``save``/``load`` use the
``srf/<id>.npz`` store layout consumed by
:class:`eradiate_tpu.spectral.response.BandSRF`.
"""

from __future__ import annotations

import datetime
import warnings

import numpy as np

from .spectral.response import BandSRF, make_gaussian_srf  # noqa: F401

__all__ = [
    "trim",
    "trim_srf",
    "threshold_filter",
    "integral_filter",
    "spectral_filter",
    "pad_zeros",
    "pad_srf",
    "wavelength_range_width",
    "wavelength_bandwidth",
    "mean_wavelength",
    "filtering_summary",
    "summarize",
    "filter_srf",
    "save",
    "show",
    "make_gaussian",
    "make_gaussian_srf",
]


def _as_pair(w, srf):
    return (
        np.asarray(w, dtype=np.float64),
        np.asarray(srf, dtype=np.float64),
    )


# ---------------------------------------------------------------------------
# summary statistics (srf_tools.py:79-160)


def wavelength_range_width(w, srf=None) -> float:
    """Upper minus lower wavelength bound [nm] (``srf_tools.py:79``)."""
    w = np.asarray(w, dtype=np.float64)
    return float(w.max() - w.min())


def wavelength_bandwidth(w, srf) -> float:
    """Integral of the SRF over wavelength [nm] (``srf_tools.py:97``)."""
    w, v = _as_pair(w, srf)
    return float(np.trapezoid(v, w))


def mean_wavelength(w, srf) -> float:
    """SRF-weighted mean wavelength [nm] (``srf_tools.py:126``)."""
    w, v = _as_pair(w, srf)
    return float(np.trapezoid(v * w, w) / np.trapezoid(v, w))


def filtering_summary(w_i, srf_i, w_f, srf_f) -> dict:
    """Initial/final/difference table of the filtering statistics
    (``srf_tools.py:161``)."""
    rows = {
        "lower_wavelength": (float(np.min(w_i)), float(np.min(w_f))),
        "upper_wavelength": (float(np.max(w_i)), float(np.max(w_f))),
        "n_wavelength": (int(np.size(w_i)), int(np.size(w_f))),
        "wavelength_range_width": (
            wavelength_range_width(w_i),
            wavelength_range_width(w_f),
        ),
        "wavelength_bandwidth": (
            wavelength_bandwidth(w_i, srf_i),
            wavelength_bandwidth(w_f, srf_f),
        ),
        "mean_wavelength": (
            mean_wavelength(w_i, srf_i),
            mean_wavelength(w_f, srf_f),
        ),
    }
    return {
        k: {"initial": a, "final": b, "difference": b - a}
        for k, (a, b) in rows.items()
    }


def summarize(w_i, srf_i, w_f, srf_f) -> str:
    """Human-readable filtering summary (``srf_tools.py:212``)."""
    rows = filtering_summary(w_i, srf_i, w_f, srf_f)
    lines = [f"{'quantity':24s} {'initial':>12s} {'final':>12s} {'diff':>12s}"]
    for k, r in rows.items():
        lines.append(
            f"{k:24s} {r['initial']:12.4g} {r['final']:12.4g} "
            f"{r['difference']:12.4g}"
        )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# filters


def trim(w, srf):
    """Trim all leading zeros except the last and all trailing zeros
    except the first (``srf_tools.py:263``)."""
    w, v = _as_pair(w, srf)
    wsize = v.size
    fsize = np.trim_zeros(v, trim="f").size
    bsize = np.trim_zeros(v, trim="b").size
    istart = wsize - fsize - 1 if wsize > fsize else 0
    istop = bsize if bsize < wsize else wsize - 1
    return w[istart : istop + 1], v[istart : istop + 1]


def threshold_filter(w, srf, value: float = 1e-3):
    """Drop points where the response is <= ``value``
    (``srf_tools.py:467``). Warns when this would disconnect the
    wavelength space; raises when it would empty the set."""
    w, v = _as_pair(w, srf)
    if value < 0.0 or value >= 1.0:
        raise ValueError(f"threshold value should be in [0, 1[ (got {value}).")
    idx = np.where(v > value)[0]
    if idx.size == 0:
        raise ValueError(
            f"Filtering this data set with threshold value of {value} would "
            f"result in empty data set."
        )
    consecutive = np.arange(idx[0], idx[0] + idx.size)
    if not np.all(idx == consecutive):
        warnings.warn(
            f"Filtering this data set with threshold value of {value} would "
            "disconnect the wavelength space. You probably do not want that."
        )
    keep = v > value
    return w[keep], v[keep]


def _integral_filter_bounds_walk(x, y, fraction):
    """Eager cumulative-integral walk bounds (``srf_tools.py:527``)."""
    dx = np.diff(x)
    cdf = np.concatenate(([0.0], np.cumsum(0.5 * (y[1:] + y[:-1]) * dx)))
    cdf /= cdf.max()
    i_left = int(np.argwhere(cdf < 0.5 * fraction).max())
    i_right = int(np.argwhere(cdf > 1.0 - 0.5 * fraction).min())
    return (i_left, i_right), float(cdf[i_right] - cdf[i_left])


def _integral_filter_bounds_symmetry(x, y, fraction):
    """Bounds symmetric about the mean wavelength (``srf_tools.py:542``)."""
    xmean = np.trapezoid(y * x, x) / np.trapezoid(y, x)
    i_xmean = int(np.argwhere(x < xmean).max()) + 1
    xext = np.insert(x, i_xmean, xmean)
    yext = np.insert(y, i_xmean, np.interp(xmean, x, y))
    dx = np.diff(xext)
    cdf = np.concatenate(
        ([0.0], np.cumsum(0.5 * (yext[1:] + yext[:-1]) * dx))
    )
    cdf /= cdf.max()
    i_max = (len(xext) - 1) // 2
    i_left, i_right, cs = i_xmean, i_xmean, 0.0
    for i in range(i_max):
        i_left = max(i_xmean - i, 0)
        i_right = min(i_xmean + i, len(xext) - 1)
        cs = float(cdf[i_right] - cdf[i_left])
        if cs >= 1.0 - fraction:
            break
    return (i_left, i_right - 1), cs


def integral_filter(w, srf, percentage: float = 99.0, method: str = "symmetry"):
    """Keep the window contributing ``percentage`` % of the integrated
    response (``srf_tools.py:567``); ``method`` is ``"symmetry"`` (bounds
    symmetric about the mean wavelength) or ``"walk"`` (eager cumulative
    walk)."""
    w, v = _as_pair(w, srf)
    if not 0.0 < percentage <= 100.0:
        raise ValueError(f"value must be within ]0, 100.0] (got {percentage})")
    fraction = 1.0 - percentage / 100.0
    if fraction <= 0.0:
        # keep 100%: both bound searches degenerate (walk's argwhere sets
        # are empty, symmetry's half-range loop cannot reach the tails) —
        # the answer is simply the full set
        return w, v
    if method == "symmetry":
        (i_left, i_right), _ = _integral_filter_bounds_symmetry(w, v, fraction)
        # indices refer to the mean-extended grid; map back via bounds
        xext = np.insert(w, int(np.argwhere(w < mean_wavelength(w, v)).max()) + 1,
                         mean_wavelength(w, v))
        wmin, wmax = xext[i_left], xext[i_right]
    elif method == "walk":
        (i_left, i_right), _ = _integral_filter_bounds_walk(w, v, fraction)
        wmin, wmax = w[i_left], w[i_right]
    else:
        raise ValueError(f"Unknown method '{method}'")
    keep = (w >= wmin) & (w <= wmax)
    if not np.any(keep):
        raise ValueError(
            f"Filtering this data set with percentage={percentage} "
            f"would result in empty data set."
        )
    return w[keep], v[keep]


def spectral_filter(w, srf, wmin=None, wmax=None):
    """Restrict to a spectral window (``srf_tools.py:403``)."""
    w, v = _as_pair(w, srf)
    m = np.ones(w.shape, dtype=bool)
    if wmin is not None:
        m &= w >= wmin
    if wmax is not None:
        m &= w <= wmax
    return w[m], v[m]


def pad_zeros(w, srf):
    """Pad with one zero sample on each side, step-extrapolated
    (``srf_tools.py:643``)."""
    return pad_srf(w, srf, n=1)


def pad_srf(w, srf, n: int = 1):
    """Pad with n zero samples on each side (uniform extrapolated steps)."""
    w, v = _as_pair(w, srf)
    dw_lo = w[1] - w[0]
    dw_hi = w[-1] - w[-2]
    w_lo = w[0] - dw_lo * np.arange(n, 0, -1)
    w_hi = w[-1] + dw_hi * np.arange(1, n + 1)
    return (
        np.concatenate([w_lo, w, w_hi]),
        np.concatenate([np.zeros(n), v, np.zeros(n)]),
    )


def trim_srf(w, srf, threshold: float | None = 1e-3, keep_integral: float | None = None):
    """Back-compat trimming entry: relative-threshold edges, or minimal
    central window keeping ``keep_integral`` of the integral."""
    w, v = _as_pair(w, srf)
    if keep_integral is not None:
        cum = np.concatenate(
            [[0.0], np.cumsum(0.5 * (v[1:] + v[:-1]) * np.diff(w))]
        )
        total = cum[-1]
        half_drop = (1.0 - keep_integral) / 2.0 * total
        lo = int(np.searchsorted(cum, half_drop))
        hi = int(np.searchsorted(cum, total - half_drop))
        lo = max(lo - 1, 0)
        hi = min(hi + 1, w.size - 1)
    else:
        mask = v >= threshold * v.max()
        idx = np.nonzero(mask)[0]
        if idx.size == 0:
            return w, v
        lo = max(int(idx[0]) - 1, 0)
        hi = min(int(idx[-1]) + 1, w.size - 1)
    return w[lo : hi + 1], v[lo : hi + 1]


# ---------------------------------------------------------------------------
# combined pipeline, IO, plotting


def filter_srf(
    w,
    srf,
    trim_prior: bool = True,
    threshold: float | None = None,
    wmin=None,
    wmax=None,
    percentage: float | None = None,
    method: str = "symmetry",
    pad: bool = False,
    verbose: bool = False,
):
    """Combined filtering pipeline (``srf_tools.py:857``). Filter order
    mirrors the reference: integral -> spectral -> threshold; optional
    prior trim and posterior zero padding. Returns ``(w, srf)``."""
    w0, v0 = _as_pair(w, srf)
    w, v = w0, v0
    if trim_prior:
        w, v = trim(w, v)
    if percentage is not None:
        w, v = integral_filter(w, v, percentage=percentage, method=method)
    if wmin is not None or wmax is not None:
        w, v = spectral_filter(w, v, wmin=wmin, wmax=wmax)
    if threshold is not None:
        w, v = threshold_filter(w, v, value=threshold)
    if pad:
        w, v = pad_zeros(w, v)
    if verbose:
        print(summarize(w0, v0, w, v))
    return w, v


def save(w, srf, path, attrs=None):
    """Save to the ``srf/<id>.npz`` store layout (``srf_tools.py:297``);
    stamps a history attribute like the reference."""
    w, v = _as_pair(w, srf)
    history = (
        f"{datetime.datetime.now(datetime.UTC):%Y-%m-%d %H:%M:%S}"
        " - filtered data set - eradiate_tpu"
    )
    meta = dict(attrs or {})
    meta.setdefault("history", history)
    np.savez(path, w=w, srf=v, **{f"attr__{k}": v for k, v in meta.items()})


def show(w, srf, w_filtered=None, srf_filtered=None, ax=None):
    """Plot the SRF, optionally emphasizing a filtered region
    (``srf_tools.py:689``). Returns the matplotlib axes (or None when
    matplotlib is unavailable)."""
    try:
        import matplotlib.pyplot as plt
    except Exception:  # pragma: no cover - env without matplotlib
        return None
    w, v = _as_pair(w, srf)
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 3))
    ax.plot(w, v, color="0.6", label="original")
    if w_filtered is not None:
        ax.plot(
            np.asarray(w_filtered), np.asarray(srf_filtered),
            color="C0", label="filtered",
        )
        ax.axvspan(
            float(np.min(w_filtered)), float(np.max(w_filtered)),
            alpha=0.1, color="C0",
        )
    ax.set_xlabel("wavelength [nm]")
    ax.set_ylabel("spectral response")
    ax.legend()
    return ax


def make_gaussian(*args, **kwargs):
    """Synthesize a Gaussian SRF (``srf_tools.py:1003``); alias of
    :func:`eradiate_tpu.spectral.response.make_gaussian_srf`."""
    return make_gaussian_srf(*args, **kwargs)
