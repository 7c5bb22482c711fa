# Host-code copy of eradiate_tpu/core/quad.py; regenerate with tools/copy_host_code.py, do not edit.
"""Quadrature rules.

Mirror of ``src/eradiate/quad.py`` (Gauss-Legendre / Gauss-Lobatto over
[-1, 1] with interval remapping); used by the CKD spectral machinery and the
post-processing g-aggregation.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

__all__ = ["Quad", "QuadType"]


class QuadType(enum.Enum):
    GAUSS_LEGENDRE = "gauss_legendre"
    GAUSS_LOBATTO = "gauss_lobatto"


def _gauss_lobatto(n: int):
    """Nodes/weights for Gauss-Lobatto quadrature on [-1, 1]."""
    if n < 2:
        raise ValueError("Gauss-Lobatto requires n >= 2")
    # Interior nodes are roots of P'_{n-1}; use the derivative of the
    # Legendre polynomial via numpy's Legendre series utilities.
    from numpy.polynomial import legendre as L

    c = np.zeros(n)
    c[-1] = 1.0  # P_{n-1}
    dc = L.legder(c)
    interior = L.legroots(dc)
    nodes = np.concatenate(([-1.0], np.sort(interior), [1.0]))
    Pn1 = L.legval(nodes, c)
    weights = 2.0 / (n * (n - 1) * Pn1**2)
    return nodes, weights


@dataclass(frozen=True)
class Quad:
    """A quadrature rule: nodes and weights on the reference interval [-1, 1].

    Mirror of ``src/eradiate/quad.py:22-200``.
    """

    type: QuadType
    nodes: np.ndarray = field(repr=False)
    weights: np.ndarray = field(repr=False)

    @classmethod
    def gauss_legendre(cls, n: int) -> "Quad":
        nodes, weights = np.polynomial.legendre.leggauss(n)
        return cls(QuadType.GAUSS_LEGENDRE, nodes, weights)

    @classmethod
    def gauss_lobatto(cls, n: int) -> "Quad":
        nodes, weights = _gauss_lobatto(n)
        return cls(QuadType.GAUSS_LOBATTO, nodes, weights)

    @classmethod
    def new(cls, type: str, n: int) -> "Quad":
        t = QuadType(type) if not isinstance(type, QuadType) else type
        if t is QuadType.GAUSS_LEGENDRE:
            return cls.gauss_legendre(n)
        if t is QuadType.GAUSS_LOBATTO:
            return cls.gauss_lobatto(n)
        raise ValueError(f"unsupported quadrature type {type}")

    def __len__(self):
        return len(self.nodes)

    def eval_nodes(self, interval=(0.0, 1.0)) -> np.ndarray:
        """Nodes remapped to ``interval`` (mirror of ``quad.py:142``)."""
        a, b = interval
        return 0.5 * (b - a) * self.nodes + 0.5 * (a + b)

    def integrate(self, values: np.ndarray, interval=(0.0, 1.0)) -> float:
        """Quadrature-weighted integral of sampled values over ``interval``."""
        a, b = interval
        return 0.5 * (b - a) * np.sum(np.asarray(values) * self.weights, axis=-1)
