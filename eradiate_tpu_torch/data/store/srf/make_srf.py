# Host-code copy of eradiate_tpu/data/store/srf/make_srf.py; regenerate with tools/copy_host_code.py, do not edit.
"""Generate packaged Sentinel-2A MSI band SRF surrogates.

Round 5 (VERDICT r4 task #9): flat-top profiles constructed from the
PUBLISHED per-band central wavelengths and bandwidths (ESA Sentinel-2
User Handbook / S2 MSI technical documentation; values widely reproduced
in the S2 literature), replacing the round-2 plain Gaussians. MSI bands
are interference filters: near-rectangular passbands with steep edges —
a flat top over the published FWHM with smooth (error-function) edge
transitions is a far closer surrogate than a Gaussian of the same FWHM
(a Gaussian leaks ~20% of its integral outside the FWHM; the flat-top
keeps ~90% inside, matching the filter character).

Provenance labeling: each ``.npz`` carries ``synthetic=True`` (the edge
shapes are synthetic — no measured curve ships in this offline
environment) plus ``center_nm``/``fwhm_nm``/``provenance`` documenting
the published parameters used. The reference distributes measured
tabulated SRFs through its online data store
(``/root/reference/src/eradiate/spectral/response.py:31``); replace
these files with measured data via ``ERADIATE_TPU_DATA_PATH`` when
available.
"""

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: Sentinel-2A MSI band parameters: (band id, central wavelength [nm],
#: bandwidth/FWHM [nm]) — published instrument characteristics (ESA
#: Sentinel-2 documentation).
S2A_BANDS = [
    ("1", 442.7, 21.0),
    ("2", 492.4, 66.0),
    ("3", 559.8, 36.0),
    ("4", 664.6, 31.0),
    ("5", 704.1, 15.0),
    ("6", 740.5, 15.0),
    ("7", 782.8, 20.0),
    ("8", 832.8, 106.0),
    ("8a", 864.7, 21.0),
    ("9", 945.1, 20.0),
    ("10", 1373.5, 31.0),
    ("11", 1613.7, 91.0),
    ("12", 2202.4, 175.0),
]


def flat_top(w, center, fwhm, edge_frac=0.12):
    """Flat-top band profile: unit response across the published FWHM
    with error-function edge rolls of width ``edge_frac * fwhm`` — the
    half-power points land exactly at center +- fwhm/2."""
    from math import sqrt

    edge = max(edge_frac * fwhm, 1.0)
    lo = center - 0.5 * fwhm
    hi = center + 0.5 * fwhm
    try:
        from scipy.special import erf  # pragma: no cover
    except Exception:
        # vectorized erf via numpy (Abramowitz-Stegun 7.1.26, |err|<1.5e-7)
        def erf(x):
            x = np.asarray(x, dtype=np.float64)
            s = np.sign(x)
            a = np.abs(x)
            t = 1.0 / (1.0 + 0.3275911 * a)
            y = 1.0 - (
                ((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t
                 - 0.284496736) * t + 0.254829592
            ) * t * np.exp(-a * a)
            return s * y

    k = 1.0 / (edge * sqrt(2.0))
    return 0.25 * (1.0 + erf((w - lo) * k)) * (1.0 + erf((hi - w) * k))


def main():
    for band, center, fwhm in S2A_BANDS:
        edge = max(0.12 * fwhm, 1.0)
        half = 0.5 * fwhm + 4.0 * edge
        w = np.linspace(center - half, center + half, 161)
        srf = flat_top(w, center, fwhm)
        path = os.path.join(HERE, f"sentinel_2a-msi-{band}.npz")
        np.savez(
            path,
            w=w,
            srf=srf,
            synthetic=np.asarray(True),
            center_nm=np.asarray(center),
            fwhm_nm=np.asarray(fwhm),
            provenance=np.asarray(
                "flat-top constructed from published S2A MSI band "
                "center/FWHM (ESA Sentinel-2 documentation); edge "
                "shapes synthetic"
            ),
        )
        print("wrote", path)


if __name__ == "__main__":
    main()
