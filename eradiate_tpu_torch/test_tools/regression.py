# Host-code copy of eradiate_tpu/test_tools/regression.py; regenerate with tools/copy_host_code.py, do not edit.
"""Regression test metrics.

Mirror of ``src/eradiate/test_tools/regression.py:219-1011``: statistical
comparisons between a candidate result and a stored reference, exploiting
the Monte Carlo variance tracked by the engine (the reference gets it from
the ``moment`` integrator). All tests return (passed, metric_value).

Inputs are plain arrays or :class:`eradiate_tpu.xr.DataArray`; variance
arrays are the per-pixel variances of the *mean* estimates.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
from scipy import stats

__all__ = [
    "RegressionTest",
    "RMSETest",
    "Chi2Test",
    "ZTest",
    "IndependentStudentTTest",
    "PairedStudentTTest",
    "SidakTTest",
]


def _values(x):
    return np.asarray(getattr(x, "values", x), dtype=np.float64).ravel()


@dataclass
class RegressionTest:
    """Base regression test (``regression.py:219``)."""

    value: object = None
    reference: object = None
    threshold: float = 0.05
    archive_dir: str | None = None
    name: str = "regression"

    METRIC_NAME = "metric"

    def run(self) -> bool:
        passed, metric = self._evaluate()
        self.metric_value = metric
        if not passed and self.archive_dir:
            self._archive()
        return bool(passed)

    def _evaluate(self):
        raise NotImplementedError

    def _archive(self):
        import os

        os.makedirs(self.archive_dir, exist_ok=True)
        np.savez(
            os.path.join(self.archive_dir, f"{self.name}_failure.npz"),
            value=_values(self.value),
            reference=_values(self.reference),
        )


@dataclass
class RMSETest(RegressionTest):
    """Root-mean-square error below threshold (``regression.py:509``)."""

    METRIC_NAME = "rmse"

    def _evaluate(self):
        v = _values(self.value)
        r = _values(self.reference)
        denom = np.maximum(np.abs(r), 1e-300)
        rmse = float(np.sqrt(np.mean(((v - r) / denom) ** 2)))
        return rmse <= self.threshold, rmse


@dataclass
class Chi2Test(RegressionTest):
    """Chi-squared goodness of fit on binned residuals
    (``regression.py:537``)."""

    variance: object = None
    METRIC_NAME = "chi2_pvalue"

    def _evaluate(self):
        v = _values(self.value)
        r = _values(self.reference)
        var = _values(self.variance)
        var = np.maximum(var, 1e-300)
        chi2 = np.sum((v - r) ** 2 / var)
        p = float(stats.chi2.sf(chi2, df=v.size))
        return p >= self.threshold, p


@dataclass
class ZTest(RegressionTest):
    """Per-pixel z-test against the reference using the candidate's MC
    variance (``regression.py:801``; used by
    ``tests/03_regression/atmospheres/test_rpv_afgl1986.py:27-36``).

    Passes when the fraction of pixels rejected at the (Bonferroni-
    corrected) threshold is consistent with chance.
    """

    variance: object = None
    METRIC_NAME = "z_pvalue"

    def _evaluate(self):
        v = _values(self.value)
        r = _values(self.reference)
        var = np.maximum(_values(self.variance), 1e-300)
        z = (v - r) / np.sqrt(var)
        p = 2.0 * stats.norm.sf(np.abs(z))
        # Bonferroni-corrected per-pixel significance
        alpha = self.threshold / v.size
        fraction_ok = float(np.mean(p >= alpha))
        return fraction_ok >= 1.0 - 1e-12, float(np.min(p) * v.size)


@dataclass
class IndependentStudentTTest(RegressionTest):
    """Two-sample t-test on the means (``regression.py:635``)."""

    variance: object = None
    reference_variance: object = None
    METRIC_NAME = "t_pvalue"

    def _evaluate(self):
        v = _values(self.value)
        r = _values(self.reference)
        var_v = np.maximum(_values(self.variance), 1e-300)
        var_r = (
            np.maximum(_values(self.reference_variance), 1e-300)
            if self.reference_variance is not None
            else np.zeros_like(var_v)
        )
        t = (v - r) / np.sqrt(var_v + var_r)
        p = 2.0 * stats.norm.sf(np.abs(t))
        pooled = float(np.median(p))
        return pooled >= self.threshold, pooled


@dataclass
class PairedStudentTTest(RegressionTest):
    """Paired t-test over pixels (``regression.py:715``)."""

    METRIC_NAME = "paired_t_pvalue"

    def _evaluate(self):
        v = _values(self.value)
        r = _values(self.reference)
        res = stats.ttest_rel(v, r)
        p = float(res.pvalue) if v.size > 1 else 1.0
        return p >= self.threshold, p


@dataclass
class SidakTTest(RegressionTest):
    """Šidák-corrected per-pixel t-test (``regression.py:916``; used by
    ``tests/03_regression/spherical/test_spherical.py:10-60``)."""

    variance: object = None
    reference_variance: object = None
    METRIC_NAME = "sidak_fraction"

    def _evaluate(self):
        v = _values(self.value)
        r = _values(self.reference)
        var_v = np.maximum(_values(self.variance), 1e-300)
        var_r = (
            np.maximum(_values(self.reference_variance), 1e-300)
            if self.reference_variance is not None
            else np.zeros_like(var_v)
        )
        z = (v - r) / np.sqrt(var_v + var_r)
        p = 2.0 * stats.norm.sf(np.abs(z))
        # Šidák correction for m comparisons
        alpha = 1.0 - (1.0 - self.threshold) ** (1.0 / v.size)
        ok = np.all(p >= alpha)
        return bool(ok), float(np.min(p))
