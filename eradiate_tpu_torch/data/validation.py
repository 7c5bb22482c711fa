# Host-code copy of eradiate_tpu/data/validation.py; regenerate with tools/copy_host_code.py, do not edit.
"""Dataset schema validation.

Mirror of ``src/eradiate/data/_validation.py`` (cerberus-based xarray
schema checks against ``data/schemas/*.yml``: ``particle_dataset_v1``,
``srf_v1``). Neither cerberus nor YAML is load-bearing here: schemas are
small and declarative, so they live as Python dicts with the same
semantics — per-variable dims, dtype family, and unit compatibility.

Works on ``xarray.Dataset`` and on this package's lightweight
:class:`eradiate_tpu.xr.Dataset`.
"""

from __future__ import annotations

import numpy as np

from ..core.units import DimensionalityError, UndefinedUnitError, to_quantity

__all__ = ["SCHEMAS", "validate_dataset", "DatasetSchemaError"]


class DatasetSchemaError(ValueError):
    """Raised when a dataset does not conform to its schema."""

    def __init__(self, errors):
        super().__init__(
            "dataset failed schema validation:\n  - " + "\n  - ".join(errors)
        )
        self.errors = list(errors)


#: variable spec keys: dims (exact tuple), kind ("f" float / "i" int),
#: units (compatibility target or tuple of alternatives), required (bool)
SCHEMAS = {
    # aerosol/particle single-scattering datasets
    # (reference particle_dataset_v1.yml)
    "particle_dataset_v1": {
        "coords": {
            "w": {"dims": ("w",), "kind": "f", "units": "nm"},
            "mu": {"dims": ("mu",), "kind": "f", "units": "dimensionless"},
            "i": {"dims": ("i",), "kind": "i", "units": "dimensionless"},
            "j": {"dims": ("j",), "kind": "i", "units": "dimensionless"},
        },
        "data_vars": {
            "sigma_t": {
                "dims": ("w",),
                "kind": "f",
                "units": ("dimensionless", "1/m"),
            },
            "albedo": {"dims": ("w",), "kind": "f", "units": "dimensionless"},
            "phase": {
                "dims": ("w", "mu", "i", "j"),
                "kind": "f",
                "units": "dimensionless",
            },
        },
    },
    # spectral response function datasets (reference srf_v1.yml)
    "srf_v1": {
        "coords": {
            "w": {"dims": ("w",), "kind": "f", "units": "nm"},
        },
        "data_vars": {
            "srf": {"dims": ("w",), "kind": "f", "units": "dimensionless"},
            "srf_u": {
                "dims": ("w",),
                "kind": "f",
                "units": "dimensionless",
                "required": False,
            },
        },
        "allow_unknown_data_vars": False,
    },
}


def _get_var(ds, group, name):
    if group == "coords":
        coords = getattr(ds, "coords", {})
        if name in coords:
            return coords[name]
        return None
    try:
        if name in ds:
            return ds[name]
    except TypeError:
        pass
    return None


def _var_dims(var, fallback_name=None):
    dims = getattr(var, "dims", None)
    if dims is None and fallback_name is not None:
        # lightweight datasets store coords as bare 1D arrays
        return (fallback_name,)
    return tuple(dims or ())


def _var_dtype_kind(var):
    values = np.asarray(getattr(var, "values", var))
    return values.dtype.kind


def _var_units(var):
    attrs = getattr(var, "attrs", {}) or {}
    return attrs.get("units")


def _units_compatible(units, target):
    try:
        to_quantity(1.0, units).m_as(target)
        return True
    except (DimensionalityError, UndefinedUnitError):
        return False


def validate_dataset(ds, schema, raise_on_error: bool = True):
    """Validate a dataset against a schema (by name or spec dict).

    Returns the list of error strings (empty when valid); raises
    :class:`DatasetSchemaError` when ``raise_on_error`` and errors exist.
    """
    if isinstance(schema, str):
        try:
            schema = SCHEMAS[schema]
        except KeyError:
            raise ValueError(
                f"unknown schema '{schema}' (known: {sorted(SCHEMAS)})"
            ) from None

    errors = []
    for group in ("coords", "data_vars"):
        for name, spec in schema.get(group, {}).items():
            var = _get_var(ds, group, name)
            if var is None:
                if spec.get("required", True):
                    errors.append(f"missing {group[:-1]} '{name}'")
                continue
            dims = _var_dims(var, fallback_name=name if group == "coords" else None)
            if dims != tuple(spec["dims"]):
                errors.append(
                    f"'{name}': dims {dims} != expected {tuple(spec['dims'])}"
                )
            kind = _var_dtype_kind(var)
            if kind != spec["kind"]:
                expect = "float" if spec["kind"] == "f" else "integer"
                errors.append(f"'{name}': dtype kind '{kind}' is not {expect}")
            units = _var_units(var)
            targets = spec.get("units")
            if targets is not None and units is not None:
                if isinstance(targets, str):
                    targets = (targets,)
                if not any(_units_compatible(units, t) for t in targets):
                    errors.append(
                        f"'{name}': units '{units}' incompatible with "
                        f"{' / '.join(targets)}"
                    )

    if not schema.get("allow_unknown_data_vars", True):
        known = set(schema.get("data_vars", {}))
        present = set(getattr(ds, "data_vars", ds.keys() if hasattr(ds, "keys") else []))
        unknown = present - known
        if unknown:
            errors.append(f"unknown data variables: {sorted(unknown)}")

    if errors and raise_on_error:
        raise DatasetSchemaError(errors)
    return errors
