# Host-code copy of eradiate_tpu/core/modes.py; regenerate with tools/copy_host_code.py, do not edit.
"""Operational mode system.

Mirror of the reference mode registry (``src/eradiate/_mode.py:56-117``):
8 concrete modes spanning {mono, ckd} x {unpolarized, polarized} x
{single, double precision}, plus aliases (``mono`` == ``mono_double`` in the
reference, ``_mode.py:381-389``).

TPU-native reinterpretation: there is no Mitsuba variant to swap. A mode
selects
- the spectral discretization family (``mono`` vs ``ckd``) used for subtype
  dispatch (spectral grids / indices),
- whether polarized transport (Stokes 4-vector path state) is compiled in,
- the floating-point policy: on TPU, float64 is emulated and slow, so
  "double" modes keep *path state* in float32 but use float64 **accumulators**
  on host aggregation and enable x64 semantics for pre/post-processing
  (numpy side). Device dtype remains configurable via
  :attr:`Mode.device_dtype` for CPU-backed runs where f64 is native.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

__all__ = [
    "Mode",
    "ModeFlag",
    "modes",
    "mode",
    "set_mode",
    "supported_mode",
    "unsupported_mode",
    "UnsetModeError",
    "UnsupportedModeError",
]


class UnsetModeError(Exception):
    """Raised when the operational mode is consulted before being set."""


class UnsupportedModeError(Exception):
    """Raised when the current mode does not support an operation."""

    def __init__(self, supported=None, unsupported=None):
        msg = "unsupported mode"
        cur = _CURRENT_MODE.id if _CURRENT_MODE is not None else None
        if supported:
            msg = f"mode '{cur}' is not one of the supported modes {supported}"
        elif unsupported:
            msg = f"mode '{cur}' is among unsupported modes {unsupported}"
        super().__init__(msg)


class ModeFlag(enum.Flag):
    """Feature flags (mirror of ``src/eradiate/_mode.py:18``)."""

    NONE = 0
    SPECTRAL_MODE_MONO = enum.auto()
    SPECTRAL_MODE_CKD = enum.auto()
    POLARIZED = enum.auto()
    UNPOLARIZED = enum.auto()
    SINGLE = enum.auto()
    DOUBLE = enum.auto()

    ANY = (
        SPECTRAL_MODE_MONO
        | SPECTRAL_MODE_CKD
        | POLARIZED
        | UNPOLARIZED
        | SINGLE
        | DOUBLE
    )


@dataclass(frozen=True)
class Mode:
    """An operational mode."""

    id: str
    flags: ModeFlag

    @property
    def is_mono(self) -> bool:
        return bool(self.flags & ModeFlag.SPECTRAL_MODE_MONO)

    @property
    def is_ckd(self) -> bool:
        return bool(self.flags & ModeFlag.SPECTRAL_MODE_CKD)

    @property
    def is_polarized(self) -> bool:
        return bool(self.flags & ModeFlag.POLARIZED)

    @property
    def is_single_precision(self) -> bool:
        return bool(self.flags & ModeFlag.SINGLE)

    @property
    def is_double_precision(self) -> bool:
        return bool(self.flags & ModeFlag.DOUBLE)

    @property
    def spectral_mode(self) -> str:
        return "mono" if self.is_mono else "ckd"

    @property
    def device_dtype(self):
        """Path-state dtype for device code, as a torch dtype: float64 in a
        double mode (on every device, without an x64 switch), float32 in a
        single one. Random uniforms stay float32 in every mode."""
        import torch

        return torch.float64 if self.is_double_precision else torch.float32

    @property
    def host_dtype(self):
        """The numpy dtype of :attr:`device_dtype`, for host-side leaves."""
        return np.float64 if self.is_double_precision else np.float32

    @property
    def accumulator_dtype(self):
        """Dtype for radiance / second-moment accumulators."""
        return self.device_dtype

    def check(self, include: ModeFlag = ModeFlag.NONE, exclude: ModeFlag = ModeFlag.NONE):
        return bool((self.flags & include) == include and not (self.flags & exclude))


def _build_registry() -> dict[str, Mode]:
    m = ModeFlag
    reg = {}

    def add(mid, *flags):
        f = ModeFlag.NONE
        for x in flags:
            f |= x
        reg[mid] = Mode(mid, f)

    add("mono_single", m.SPECTRAL_MODE_MONO, m.UNPOLARIZED, m.SINGLE)
    add("mono_double", m.SPECTRAL_MODE_MONO, m.UNPOLARIZED, m.DOUBLE)
    add("mono_polarized_single", m.SPECTRAL_MODE_MONO, m.POLARIZED, m.SINGLE)
    add("mono_polarized_double", m.SPECTRAL_MODE_MONO, m.POLARIZED, m.DOUBLE)
    add("ckd_single", m.SPECTRAL_MODE_CKD, m.UNPOLARIZED, m.SINGLE)
    add("ckd_double", m.SPECTRAL_MODE_CKD, m.UNPOLARIZED, m.DOUBLE)
    add("ckd_polarized_single", m.SPECTRAL_MODE_CKD, m.POLARIZED, m.SINGLE)
    add("ckd_polarized_double", m.SPECTRAL_MODE_CKD, m.POLARIZED, m.DOUBLE)

    # Aliases, as in the reference (`_mode.py:381-389`): unsuffixed names map
    # to the double-precision variants.
    reg["mono"] = reg["mono_double"]
    reg["ckd"] = reg["ckd_double"]
    reg["mono_polarized"] = reg["mono_polarized_double"]
    reg["ckd_polarized"] = reg["ckd_polarized_double"]
    return reg


_REGISTRY = _build_registry()
_CURRENT_MODE: Mode | None = None


def modes(filter=None) -> dict[str, Mode]:
    """Return the registry of concrete modes, optionally filtered."""
    result = {k: v for k, v in _REGISTRY.items() if k == v.id}
    if filter is not None:
        result = {k: v for k, v in result.items() if filter(v)}
    return result


def mode() -> Mode:
    """Return the currently active mode.

    Mirror of ``eradiate.mode()`` (``src/eradiate/_mode.py:497``).
    """
    if _CURRENT_MODE is None:
        raise UnsetModeError(
            "no mode is set; call eradiate_tpu_torch.set_mode() first (e.g. "
            "set_mode('mono'))"
        )
    return _CURRENT_MODE


def get_mode_or_none() -> Mode | None:
    return _CURRENT_MODE


def set_mode(mode_id: str) -> None:
    """Set the operational mode.

    Mirror of ``eradiate.set_mode()`` (``src/eradiate/_mode.py:542``); the
    TPU build swaps no compiled kernel variant — the mode only drives subtype
    dispatch and precision policy.
    """
    global _CURRENT_MODE
    if mode_id not in _REGISTRY:
        raise ValueError(
            f"unknown mode '{mode_id}'; available: {sorted(_REGISTRY.keys())}"
        )
    _CURRENT_MODE = _REGISTRY[mode_id]


def supported_mode(flags: ModeFlag):
    """Raise UnsupportedModeError unless current mode has all ``flags``."""
    if not mode().check(include=flags):
        raise UnsupportedModeError(supported=str(flags))


def unsupported_mode(flags: ModeFlag):
    """Raise UnsupportedModeError if current mode has any of ``flags``."""
    if mode().flags & flags:
        raise UnsupportedModeError(unsupported=str(flags))
