# Host-code copy of eradiate_tpu/core/units.py; regenerate with tools/copy_host_code.py, do not edit.
"""Minimal unit system for configuration-boundary quantities.

The reference framework uses :mod:`pint` everywhere (``src/eradiate/units.py``).
For the TPU-native rebuild, units live *only* at the configuration boundary:
all device code operates on fixed kernel units (length: km, wavelength: nm,
collision coefficient: 1/km, irradiance: W/m^2/nm, angle: rad internally,
deg at the user surface). This module provides a small, dependency-free
quantity type with dimension checking and linear conversion factors —
sufficient for the configuration surface, and deliberately not a full pint
replacement (pint is not available in this environment).

Kernel unit conventions (mirror of the reference's ``unit_context_kernel``):

- length            : km
- wavelength        : nm
- collision coeff.  : km^-1
- irradiance        : W / m^2 / nm
- radiance          : W / m^2 / sr / nm
- angle             : deg (user surface), rad (device)
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

import numpy as np

__all__ = [
    "DimensionalityError",
    "Quantity",
    "Unit",
    "UndefinedUnitError",
    "ureg",
    "to_quantity",
]


class UndefinedUnitError(ValueError):
    """Raised when a unit string cannot be parsed."""


class DimensionalityError(ValueError):
    """Raised when converting between incompatible dimensions."""

    def __init__(self, src, dst):
        super().__init__(f"cannot convert from '{src}' to '{dst}'")
        self.src = src
        self.dst = dst


# Dimension vector: (length, mass, time, angle, solid_angle, temperature,
# amount). Represented as a tuple of rationals (floats are fine: only small
# integers appear).
_DIMLESS = (0, 0, 0, 0, 0, 0, 0)


def _dim(length=0, mass=0, time=0, angle=0, sr=0, temp=0, amount=0):
    return (length, mass, time, angle, sr, temp, amount)


# Base units: name -> (factor to SI-coherent base, dimension vector)
# Base convention: m, kg, s, rad, sr, K, mol.
_UNITS: dict[str, tuple[float, tuple]] = {
    # dimensionless
    "dimensionless": (1.0, _DIMLESS),
    "": (1.0, _DIMLESS),
    "percent": (0.01, _DIMLESS),
    "%": (0.01, _DIMLESS),
    # length
    "m": (1.0, _dim(length=1)),
    "meter": (1.0, _dim(length=1)),
    "metre": (1.0, _dim(length=1)),
    "km": (1e3, _dim(length=1)),
    "kilometer": (1e3, _dim(length=1)),
    "dm": (1e-1, _dim(length=1)),
    "cm": (1e-2, _dim(length=1)),
    "mm": (1e-3, _dim(length=1)),
    "um": (1e-6, _dim(length=1)),
    "micron": (1e-6, _dim(length=1)),
    "micrometer": (1e-6, _dim(length=1)),
    "micrometre": (1e-6, _dim(length=1)),
    "nm": (1e-9, _dim(length=1)),
    "nanometer": (1e-9, _dim(length=1)),
    "angstrom": (1e-10, _dim(length=1)),
    # mass
    "kg": (1.0, _dim(mass=1)),
    "g": (1e-3, _dim(mass=1)),
    # time
    "s": (1.0, _dim(time=1)),
    "second": (1.0, _dim(time=1)),
    "ms": (1e-3, _dim(time=1)),
    "us": (1e-6, _dim(time=1)),
    "ns": (1e-9, _dim(time=1)),
    "hour": (3600.0, _dim(time=1)),
    "day": (86400.0, _dim(time=1)),
    # angle
    "rad": (1.0, _dim(angle=1)),
    "radian": (1.0, _dim(angle=1)),
    "deg": (math.pi / 180.0, _dim(angle=1)),
    "degree": (math.pi / 180.0, _dim(angle=1)),
    # solid angle
    "sr": (1.0, _dim(sr=1)),
    "steradian": (1.0, _dim(sr=1)),
    # temperature (absolute scales only; offsets unsupported)
    "K": (1.0, _dim(temp=1)),
    "kelvin": (1.0, _dim(temp=1)),
    # amount
    "mol": (1.0, _dim(amount=1)),
    "mole": (1.0, _dim(amount=1)),
    # power (derived, frequently used directly)
    "W": (1.0, _dim(mass=1, length=2, time=-3)),
    "watt": (1.0, _dim(mass=1, length=2, time=-3)),
    "mW": (1e-3, _dim(mass=1, length=2, time=-3)),
    # pressure
    "Pa": (1.0, _dim(mass=1, length=-1, time=-2)),
    "pascal": (1.0, _dim(mass=1, length=-1, time=-2)),
    "hPa": (100.0, _dim(mass=1, length=-1, time=-2)),
    "kPa": (1e3, _dim(mass=1, length=-1, time=-2)),
    "bar": (1e5, _dim(mass=1, length=-1, time=-2)),
    "mbar": (1e2, _dim(mass=1, length=-1, time=-2)),
    "atm": (101325.0, _dim(mass=1, length=-1, time=-2)),
    "torr": (101325.0 / 760.0, _dim(mass=1, length=-1, time=-2)),
}

_TOKEN_RE = re.compile(
    r"""
    (?P<unit>[A-Za-zµ%]+)               # unit symbol
    (?:\s*\^?\s*(?P<exp>[+-]?\d+))?     # optional exponent: m^2, m2, m-1
    """,
    re.VERBOSE,
)


def _parse_unit(spec: str) -> tuple[float, tuple]:
    """Parse a unit expression into (si_factor, dimension vector).

    Supports ``*``, ``/``, whitespace as multiplication, and integer
    exponents via ``^`` or adjacency (``m^-1``, ``m-1``, ``m2``).
    """
    if spec is None:
        spec = "dimensionless"
    spec = spec.strip()
    if spec in ("", "dimensionless"):
        return 1.0, _DIMLESS

    factor = 1.0
    dims = [0.0] * 7
    # split on '/' — everything after the first '/' is denominator unless
    # another '/' follows (a/b/c == a per b per c, pint-style)
    sign = 1
    # Tokenize respecting * and /
    pos = 0
    spec = spec.replace("**", "^")
    while pos < len(spec):
        ch = spec[pos]
        if ch in " *\t·":
            pos += 1
            continue
        if ch == "/":
            sign = -1
            pos += 1
            continue
        if ch == "1":
            # literal numerator "1" (e.g. "1/m", "1 / sr"): dimensionless
            pos += 1
            continue
        m = _TOKEN_RE.match(spec, pos)
        if not m:
            raise UndefinedUnitError(f"cannot parse unit '{spec}' at {pos!r}")
        name = m.group("unit")
        exp = int(m.group("exp")) if m.group("exp") else 1
        exp *= sign
        if name not in _UNITS:
            raise UndefinedUnitError(f"unknown unit '{name}' in '{spec}'")
        f, d = _UNITS[name]
        factor *= f**exp
        for i in range(7):
            dims[i] += d[i] * exp
        pos = m.end()
        # after a '/', subsequent '*'-joined units stay in denominator
        # (pint behavior: 'W/m^2/nm' -> W * m^-2 * nm^-1) — handled since
        # sign persists until the next explicit '/' (which keeps sign=-1).
    return factor, tuple(dims)


@dataclass(frozen=True)
class Unit:
    """A parsed unit: conversion factor to SI-coherent base + dimensions."""

    spec: str
    factor: float
    dims: tuple

    def __str__(self):
        return self.spec

    def __repr__(self):
        return f"Unit('{self.spec}')"

    def __eq__(self, other):
        if isinstance(other, str):
            other = parse_units(other)
        return self.factor == other.factor and self.dims == other.dims

    def __hash__(self):
        return hash((self.factor, self.dims))


def parse_units(spec) -> Unit:
    if isinstance(spec, Unit):
        return spec
    factor, dims = _parse_unit(spec)
    return Unit(spec if spec else "dimensionless", factor, dims)


class Quantity:
    """A magnitude (scalar or ndarray) with a unit.

    Implements the subset of the pint API the framework uses:
    ``.to(unit)``, ``.m_as(unit)``, ``.magnitude``/``.m``, ``.units``,
    arithmetic, comparisons and numpy interop.
    """

    __slots__ = ("_m", "_u")
    __array_priority__ = 20.0  # beat ndarray in binary ops

    def __init__(self, magnitude, units="dimensionless"):
        if isinstance(magnitude, Quantity):
            base = magnitude.to(units)
            self._m = base._m
        else:
            self._m = magnitude
        self._u = parse_units(units)

    # -- accessors --------------------------------------------------------
    @property
    def magnitude(self):
        return self._m

    m = magnitude

    @property
    def units(self) -> Unit:
        return self._u

    @property
    def dimensionless(self) -> bool:
        return self._u.dims == _DIMLESS

    # -- conversion -------------------------------------------------------
    def to(self, units) -> "Quantity":
        u = parse_units(units)
        if u.dims != self._u.dims:
            raise DimensionalityError(self._u.spec, u.spec)
        if u.factor == self._u.factor:
            return Quantity.__new_raw__(self._m, u)
        scale = self._u.factor / u.factor
        return Quantity.__new_raw__(np.asarray(self._m) * scale, u)

    def m_as(self, units):
        return self.to(units)._m

    @classmethod
    def __new_raw__(cls, magnitude, unit: Unit):
        obj = cls.__new__(cls)
        object.__setattr__ if False else None
        obj._m = magnitude
        obj._u = unit
        return obj

    # -- arithmetic -------------------------------------------------------
    def _coerce(self, other):
        if isinstance(other, Quantity):
            return other
        return Quantity.__new_raw__(other, parse_units("dimensionless"))

    def __add__(self, other):
        other = self._coerce(other)
        other = other.to(self._u)
        return Quantity.__new_raw__(np.asarray(self._m) + np.asarray(other._m), self._u)

    __radd__ = __add__

    def __sub__(self, other):
        other = self._coerce(other).to(self._u)
        return Quantity.__new_raw__(np.asarray(self._m) - np.asarray(other._m), self._u)

    def __rsub__(self, other):
        other = self._coerce(other).to(self._u)
        return Quantity.__new_raw__(np.asarray(other._m) - np.asarray(self._m), self._u)

    def __neg__(self):
        return Quantity.__new_raw__(-np.asarray(self._m), self._u)

    def __abs__(self):
        return Quantity.__new_raw__(np.abs(np.asarray(self._m)), self._u)

    def _mul_dims(self, other, sign):
        ou = other._u
        dims = tuple(a + sign * b for a, b in zip(self._u.dims, ou.dims))
        factor = self._u.factor * (ou.factor**sign)
        if sign > 0:
            spec = f"{self._u.spec} * {ou.spec}"
        else:
            spec = f"{self._u.spec} / ({ou.spec})"
        if dims == _DIMLESS and factor == 1.0:
            spec = "dimensionless"
        return Unit(spec, factor, dims)

    def __mul__(self, other):
        other = self._coerce(other)
        u = self._mul_dims(other, +1)
        return Quantity.__new_raw__(np.asarray(self._m) * np.asarray(other._m), u)

    __rmul__ = __mul__

    def __truediv__(self, other):
        other = self._coerce(other)
        u = self._mul_dims(other, -1)
        return Quantity.__new_raw__(np.asarray(self._m) / np.asarray(other._m), u)

    def __rtruediv__(self, other):
        other = self._coerce(other)
        return other.__truediv__(self)

    def __pow__(self, exp):
        dims = tuple(d * exp for d in self._u.dims)
        u = Unit(f"({self._u.spec})^{exp}", self._u.factor**exp, dims)
        return Quantity.__new_raw__(np.asarray(self._m) ** exp, u)

    # -- comparisons ------------------------------------------------------
    def _cmp(self, other, op):
        other = self._coerce(other).to(self._u)
        return op(np.asarray(self._m), np.asarray(other._m))

    def __eq__(self, other):
        try:
            return self._cmp(other, np.equal)
        except (DimensionalityError, UndefinedUnitError):
            return NotImplemented

    def __lt__(self, other):
        return self._cmp(other, np.less)

    def __le__(self, other):
        return self._cmp(other, np.less_equal)

    def __gt__(self, other):
        return self._cmp(other, np.greater)

    def __ge__(self, other):
        return self._cmp(other, np.greater_equal)

    # -- container protocol ----------------------------------------------
    def __len__(self):
        return len(self._m)

    def __getitem__(self, idx):
        return Quantity.__new_raw__(np.asarray(self._m)[idx], self._u)

    def __iter__(self):
        for v in np.asarray(self._m):
            yield Quantity.__new_raw__(v, self._u)

    @property
    def shape(self):
        return np.shape(self._m)

    @property
    def size(self):
        return np.size(self._m)

    def __repr__(self):
        return f"<Quantity({self._m!r}, '{self._u.spec}')>"

    def __str__(self):
        return f"{self._m} {self._u.spec}"

    def __float__(self):
        return float(np.asarray(self._m))

    def __array__(self, dtype=None):
        # Only safe for dimensionless quantities; otherwise the caller must
        # use m_as() explicitly to state the target unit.
        if not self.dimensionless:
            raise DimensionalityError(self._u.spec, "dimensionless")
        arr = np.asarray(self._m) * self._u.factor
        return arr.astype(dtype) if dtype is not None else arr


class UnitRegistry:
    """pint-lookalike entry point: ``ureg.Quantity(1.0, "km")``, ``ureg.km``."""

    Quantity = Quantity

    def __call__(self, spec: str) -> Unit:
        return parse_units(spec)

    def __getattr__(self, name: str):
        try:
            return Quantity(1.0, name)
        except UndefinedUnitError as e:
            raise AttributeError(str(e)) from e

    def parse_units(self, spec) -> Unit:
        return parse_units(spec)


#: Global unit registry (mirror of the reference's ``unit_registry``,
#: ``src/eradiate/units.py:36``)
ureg = UnitRegistry()


def to_quantity(value, default_units="dimensionless") -> Quantity:
    """Convert value to a Quantity, applying default units to bare numbers.

    Accepts: Quantity (returned as-is), (magnitude, units) tuples, dicts
    ``{"value": ..., "units": ...}``, bare scalars/arrays.
    """
    if isinstance(value, Quantity):
        return value
    if isinstance(value, tuple) and len(value) == 2 and isinstance(value[1], (str, Unit)):
        return Quantity(value[0], value[1])
    if isinstance(value, dict) and "value" in value:
        return Quantity(value["value"], value.get("units", default_units))
    return Quantity(value, default_units)


# Kernel unit conventions: fixed units used by all device-side code.
KERNEL_LENGTH = "km"
KERNEL_WAVELENGTH = "nm"
KERNEL_COLLISION = "km^-1"
KERNEL_IRRADIANCE = "W/m^2/nm"
KERNEL_RADIANCE = "W/m^2/sr/nm"
KERNEL_ANGLE = "rad"
