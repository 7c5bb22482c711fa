# Host-code copy of eradiate_tpu/spectral/ckd_quad.py; regenerate with tools/copy_host_code.py, do not edit.
"""CKD quadrature configuration.

Mirror of ``src/eradiate/spectral/ckd_quad.py``: selects the g-point
quadrature rule used within each CKD bin. The FIXED policy uses a constant
node count; the adaptive policies (MINIMIZE_ERROR / ERROR_THRESHOLD) pick a
node count per bin from precomputed error data shipped with the absorption
database.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

from ..core.quad import Quad

__all__ = ["CKDQuadPolicy", "CKDQuadConfig"]


class CKDQuadPolicy(enum.Enum):
    FIXED = "fixed"
    MINIMIZE_ERROR = "minimize_error"
    ERROR_THRESHOLD = "error_threshold"


@dataclass(frozen=True)
class CKDQuadConfig:
    """Quadrature config (mirror of ``ckd_quad.py:37``)."""

    type: str = "gauss_legendre"
    ng_max: int = 16
    policy: CKDQuadPolicy = CKDQuadPolicy.FIXED
    error_threshold: float = 0.01

    @classmethod
    def convert(cls, value) -> "CKDQuadConfig":
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            d = dict(value)
            if "policy" in d:
                d["policy"] = CKDQuadPolicy(d["policy"]) if not isinstance(d["policy"], CKDQuadPolicy) else d["policy"]
            return cls(**d)
        raise ValueError(f"cannot convert {value!r} to CKDQuadConfig")

    def get_quad(self, error_data=None) -> Quad:
        """Return the quadrature for one bin.

        ``error_data``: optional mapping ng -> estimated error for the
        adaptive policies (mirror of ``ckd_quad.py:80-117``).
        """
        ng = self.ng_max
        if error_data is not None and self.policy is not CKDQuadPolicy.FIXED:
            ngs = np.asarray(sorted(error_data.keys()))
            errs = np.asarray([error_data[int(n)] for n in ngs])
            if self.policy is CKDQuadPolicy.MINIMIZE_ERROR:
                valid = ngs[ngs <= self.ng_max]
                verrs = errs[ngs <= self.ng_max]
                ng = int(valid[np.argmin(verrs)]) if valid.size else self.ng_max
            elif self.policy is CKDQuadPolicy.ERROR_THRESHOLD:
                ok = ngs[(errs <= self.error_threshold) & (ngs <= self.ng_max)]
                ng = int(ok[0]) if ok.size else self.ng_max
        return Quad.new(self.type, ng)
