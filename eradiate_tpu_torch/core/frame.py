# Host-code copy of eradiate_tpu/core/frame.py; regenerate with tools/copy_host_code.py, do not edit.
"""Angle and local-frame conversions.

Mirror of ``src/eradiate/frame.py`` (azimuth conventions, angle/direction
conversions, hplane detection). Functions accept numpy or JAX arrays and
return the matching array type; all angles in radians unless noted.

Conventions: zenith angle measured from +z; azimuth in the EAST_RIGHT
convention is the usual mathematical angle from +x (East), counter-clockwise.
"""

from __future__ import annotations

import enum

import numpy as np

__all__ = [
    "AzimuthConvention",
    "transform_azimuth",
    "angles_to_direction",
    "direction_to_angles",
    "cos_angle_to_direction",
    "spherical_to_cartesian",
    "angles_in_hplane",
]


class AzimuthConvention(enum.Enum):
    """Azimuth angle conventions (mirror of ``frame.py:15``).

    Each value is ``(offset_rad, orientation)`` with orientation +1 for CCW
    from the offset direction, -1 for CW.
    """

    EAST_RIGHT = (0.0, 1)  # math convention (default)
    EAST_LEFT = (0.0, -1)
    NORTH_RIGHT = (np.pi / 2.0, 1)
    NORTH_LEFT = (np.pi / 2.0, -1)
    WEST_RIGHT = (np.pi, 1)
    WEST_LEFT = (np.pi, -1)
    SOUTH_RIGHT = (-np.pi / 2.0, 1)
    SOUTH_LEFT = (-np.pi / 2.0, -1)

    @classmethod
    def convert(cls, value) -> "AzimuthConvention":
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            return cls[value.upper()]
        raise ValueError(f"cannot convert {value!r} to AzimuthConvention")


def _np(x):
    """Return the array namespace for x (numpy: host code only)."""
    return np


def transform_azimuth(
    angles,
    from_convention: AzimuthConvention | str = AzimuthConvention.EAST_RIGHT,
    to_convention: AzimuthConvention | str = AzimuthConvention.EAST_RIGHT,
    normalize: bool = False,
):
    """Convert azimuth values [rad] between conventions."""
    xp = _np(angles)
    fc = AzimuthConvention.convert(from_convention)
    tc = AzimuthConvention.convert(to_convention)
    off_f, or_f = fc.value
    off_t, or_t = tc.value
    # to EAST_RIGHT: phi_er = offset + orientation * phi
    phi_er = off_f + or_f * xp.asarray(angles)
    # from EAST_RIGHT to target: phi_t = orientation_t * (phi_er - offset_t)
    result = or_t * (phi_er - off_t)
    if normalize:
        result = result % (2.0 * np.pi)
    return result


def cos_angle_to_direction(cos_theta, phi, flip: bool = False):
    """(cos zenith, azimuth EAST_RIGHT [rad]) -> unit direction(s), shape (..., 3)."""
    xp = _np(cos_theta)
    cos_theta = xp.asarray(cos_theta)
    phi = xp.asarray(phi)
    sin_theta = xp.sqrt(xp.clip(1.0 - cos_theta * cos_theta, 0.0, 1.0))
    d = xp.stack(
        [sin_theta * xp.cos(phi), sin_theta * xp.sin(phi), cos_theta], axis=-1
    )
    return -d if flip else d


def angles_to_direction(
    angles,
    azimuth_convention: AzimuthConvention | str = AzimuthConvention.EAST_RIGHT,
    flip: bool = False,
):
    """Convert (zenith, azimuth) pairs [rad] to unit vectors.

    Mirror of ``frame.py:242``: negative zeniths are flipped into
    (|theta|, phi + pi) — this encodes the signed-zenith principal-plane
    parametrization used by hplane measure layouts.
    """
    xp = _np(angles)
    angles = xp.asarray(angles, dtype=np.float64 if xp is np else None)
    if angles.ndim < 2:
        angles = angles.reshape((angles.size // 2, 2))
    theta = angles[..., 0]
    phi = angles[..., 1]
    neg = theta < 0
    theta = xp.where(neg, -theta, theta)
    phi = xp.where(neg, phi + np.pi, phi)
    phi = transform_azimuth(phi, from_convention=azimuth_convention)
    return cos_angle_to_direction(xp.cos(theta), phi, flip=flip)


def direction_to_angles(
    v,
    azimuth_convention: AzimuthConvention | str = AzimuthConvention.EAST_RIGHT,
    normalize: bool = True,
):
    """Convert unit vectors (shape (..., 3)) to (zenith, azimuth) pairs [rad]."""
    xp = _np(v)
    v = xp.asarray(v)
    if v.ndim < 2:
        v = v.reshape((v.size // 3, 3))
    norm = xp.sqrt(xp.sum(v * v, axis=-1, keepdims=True))
    v = v / norm
    theta = xp.arccos(xp.clip(v[..., 2], -1.0, 1.0))
    phi = xp.arctan2(v[..., 1], v[..., 0])
    phi = transform_azimuth(
        phi, to_convention=azimuth_convention, normalize=normalize
    )
    return xp.stack([theta, phi], axis=-1)


def spherical_to_cartesian(r, theta, phi, origin=(0.0, 0.0, 0.0)):
    """Spherical (r, zenith, azimuth EAST_RIGHT) [rad] -> cartesian."""
    xp = _np(theta)
    r = xp.asarray(r)
    st, ct = xp.sin(theta), xp.cos(theta)
    sp, cp = xp.sin(phi), xp.cos(phi)
    o = xp.asarray(origin)
    return xp.stack(
        [r * st * cp + o[..., 0], r * st * sp + o[..., 1], r * ct + o[..., 2]],
        axis=-1,
    )


def angles_in_hplane(plane_phi, theta, phi, raise_exc: bool = False):
    """Classify (theta, phi) pairs [rad] against the hemisphere plane at
    azimuth ``plane_phi``: returns (in_plane_positive, in_plane_negative)
    boolean masks. Mirror of ``frame.py:378``."""
    xp = _np(theta)
    twopi = 2.0 * np.pi
    dphi = (xp.asarray(phi) - plane_phi) % twopi
    at_pole = xp.isclose(xp.cos(theta), 1.0)
    in_plane_pos = xp.isclose(dphi, 0.0) | xp.isclose(dphi, twopi) | at_pole
    in_plane_neg = xp.isclose(dphi, np.pi) & ~at_pole
    in_plane = in_plane_pos | in_plane_neg
    if raise_exc and not bool(np.all(np.asarray(in_plane))):
        raise ValueError("found off-plane directions")
    return in_plane_pos, in_plane_neg
