# Host-code copy of eradiate_tpu/xr.py; regenerate with tools/copy_host_code.py, do not edit.
"""Minimal labeled N-d arrays (xarray is unavailable in this environment).

The reference's post-processing outputs ``xarray.Dataset`` objects
(``pipelines/logic.py``); this module provides a compact, dependency-free
subset of the xarray API — named dims, coordinate arrays, attrs,
dim-aligned broadcasting arithmetic, ``sel``/``isel``, reductions and npz
round-trip — sufficient to reproduce the reference's output conventions
(variable names, dims, coords, metadata). If real xarray is installed,
:func:`to_xarray` converts losslessly.
"""

from __future__ import annotations

import numpy as np

__all__ = ["DataArray", "Dataset"]


def _as_tuple(x):
    if x is None:
        return ()
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,)


class DataArray:
    """A labeled N-d array: data + dims + 1D coords + attrs."""

    def __init__(self, data, dims=None, coords=None, attrs=None, name=None):
        self.data = np.asarray(data)
        if dims is None:
            dims = tuple(f"dim_{i}" for i in range(self.data.ndim))
        self.dims = tuple(dims)
        if len(self.dims) != self.data.ndim:
            raise ValueError(
                f"dims {self.dims} do not match data ndim {self.data.ndim}"
            )
        self.coords = {}
        if coords:
            for k, v in coords.items():
                v = np.asarray(v)
                self.coords[k] = v
        for d, n in zip(self.dims, self.data.shape):
            if d in self.coords and self.coords[d].shape[0] != n:
                raise ValueError(
                    f"coord '{d}' has length {self.coords[d].shape[0]}, "
                    f"dim has length {n}"
                )
        self.attrs = dict(attrs or {})
        self.name = name

    # -- basics -----------------------------------------------------------
    @property
    def values(self):
        return self.data

    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def sizes(self):
        return dict(zip(self.dims, self.data.shape))

    def copy(self):
        return DataArray(
            self.data.copy(), self.dims, dict(self.coords), dict(self.attrs), self.name
        )

    def rename(self, name):
        out = self.copy()
        out.name = name
        return out

    def __repr__(self):
        coords = ", ".join(self.coords)
        return (
            f"<DataArray {self.name or ''} {dict(zip(self.dims, self.shape))} "
            f"coords: [{coords}]>"
        )

    def item(self):
        return self.data.item()

    def __float__(self):
        return float(self.data)

    def __array__(self, dtype=None):
        return self.data.astype(dtype) if dtype else self.data

    # -- selection --------------------------------------------------------
    def isel(self, indexers=None, **kwargs):
        idx = dict(indexers or {})
        idx.update(kwargs)
        slicer = []
        new_dims = []
        for d in self.dims:
            if d in idx:
                i = idx[d]
                slicer.append(i)
                if not np.isscalar(i):
                    new_dims.append(d)
            else:
                slicer.append(slice(None))
                new_dims.append(d)
        data = self.data[tuple(slicer)]
        coords = {}
        for k, v in self.coords.items():
            if k in idx:
                sel = v[idx[k]]
                if np.ndim(sel) > 0:
                    coords[k] = sel
            else:
                coords[k] = v
        return DataArray(data, new_dims, coords, self.attrs, self.name)

    def sel(self, indexers=None, method=None, **kwargs):
        idx = dict(indexers or {})
        idx.update(kwargs)
        iidx = {}
        for d, val in idx.items():
            coord = self.coords[d]
            val_arr = np.atleast_1d(val)
            if method == "nearest":
                pos = np.array([np.argmin(np.abs(coord - v)) for v in val_arr])
            else:
                pos = np.array(
                    [int(np.nonzero(np.isclose(coord, v))[0][0]) for v in val_arr]
                )
            iidx[d] = int(pos[0]) if np.isscalar(val) else pos
        return self.isel(iidx)

    # -- reductions -------------------------------------------------------
    def _reduce(self, fn, dim=None, **kwargs):
        dims = _as_tuple(dim) if dim is not None else self.dims
        axes = tuple(self.dims.index(d) for d in dims)
        data = fn(self.data, axis=axes, **kwargs)
        new_dims = tuple(d for d in self.dims if d not in dims)
        coords = {k: v for k, v in self.coords.items() if k not in dims}
        return DataArray(data, new_dims, coords, self.attrs, self.name)

    def mean(self, dim=None):
        return self._reduce(np.mean, dim)

    def sum(self, dim=None):
        return self._reduce(np.sum, dim)

    def max(self, dim=None):
        return self._reduce(np.max, dim)

    def min(self, dim=None):
        return self._reduce(np.min, dim)

    def std(self, dim=None):
        return self._reduce(np.std, dim)

    # -- arithmetic with dim alignment ------------------------------------
    def _binary(self, other, op):
        if isinstance(other, DataArray):
            out_dims = list(self.dims)
            for d in other.dims:
                if d not in out_dims:
                    out_dims.append(d)
            a = self._expand_to(out_dims)
            b = other._expand_to(out_dims)
            coords = dict(other.coords)
            coords.update(self.coords)
            coords = {k: v for k, v in coords.items() if k in out_dims}
            return DataArray(
                op(a, b), tuple(out_dims), coords, self.attrs, self.name
            )
        return DataArray(
            op(self.data, other), self.dims, self.coords, self.attrs, self.name
        )

    def _expand_to(self, out_dims):
        """View of data broadcastable to out_dims order."""
        shape = []
        src = []
        for d in out_dims:
            if d in self.dims:
                src.append(self.dims.index(d))
        data = np.transpose(self.data, src) if src else self.data
        it = iter(data.shape)
        for d in out_dims:
            shape.append(next(it) if d in self.dims else 1)
        return data.reshape(shape)

    def __add__(self, o):
        return self._binary(o, np.add)

    def __radd__(self, o):
        return self._binary(o, lambda a, b: np.add(b, a))

    def __sub__(self, o):
        return self._binary(o, np.subtract)

    def __rsub__(self, o):
        return self._binary(o, lambda a, b: np.subtract(b, a))

    def __mul__(self, o):
        return self._binary(o, np.multiply)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, np.divide)

    def __rtruediv__(self, o):
        return self._binary(o, lambda a, b: np.divide(b, a))

    def __pow__(self, o):
        return self._binary(o, np.power)

    def __neg__(self):
        return DataArray(-self.data, self.dims, self.coords, self.attrs, self.name)


class Dataset:
    """A dict of DataArrays sharing coords."""

    def __init__(self, data_vars=None, coords=None, attrs=None):
        self.data_vars: dict[str, DataArray] = {}
        self.coords = {k: np.asarray(v) for k, v in (coords or {}).items()}
        self.attrs = dict(attrs or {})
        for k, v in (data_vars or {}).items():
            self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, tuple) and len(value) in (2, 3):
            dims, data = value[0], value[1]
            attrs = value[2] if len(value) == 3 else {}
            value = DataArray(data, _as_tuple(dims), attrs=attrs, name=key)
        if not isinstance(value, DataArray):
            value = DataArray(value, name=key)
        value = value.copy()
        value.name = key
        # attach dataset coords
        for d in value.dims:
            if d in self.coords and d not in value.coords:
                value.coords[d] = self.coords[d]
        # absorb variable coords into dataset
        for ck, cv in value.coords.items():
            if ck not in self.coords:
                self.coords[ck] = cv
        self.data_vars[key] = value

    def __getitem__(self, key):
        if key in self.data_vars:
            return self.data_vars[key]
        if key in self.coords:
            # coordinate access, as in xarray: ds["w"]
            return DataArray(self.coords[key], (key,), name=key)
        raise KeyError(key)

    def __getattr__(self, key):
        try:
            return self.__dict__["data_vars"][key]
        except KeyError:
            raise AttributeError(key) from None

    def __contains__(self, key):
        return key in self.data_vars

    def __iter__(self):
        return iter(self.data_vars)

    def keys(self):
        return self.data_vars.keys()

    def items(self):
        return self.data_vars.items()

    def __repr__(self):
        lines = ["<Dataset>"]
        lines.append("Coordinates:")
        for k, v in self.coords.items():
            lines.append(f"    {k}: {v.shape} {v.dtype}")
        lines.append("Data variables:")
        for k, v in self.data_vars.items():
            lines.append(f"    {k}: {v.dims} {v.shape}")
        if self.attrs:
            lines.append(f"Attributes: {list(self.attrs)}")
        return "\n".join(lines)

    # -- IO ---------------------------------------------------------------
    def to_npz(self, path):
        payload = {}
        import json

        meta = {"vars": {}, "coords": list(self.coords), "attrs": self.attrs}
        for k, v in self.coords.items():
            payload[f"coord__{k}"] = v
        for k, v in self.data_vars.items():
            payload[f"var__{k}"] = v.data
            meta["vars"][k] = {"dims": v.dims, "attrs": v.attrs}
        payload["__meta__"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8
        )
        np.savez(path, **payload)

    @classmethod
    def from_npz(cls, path):
        import json

        npz = np.load(path)
        meta = json.loads(bytes(npz["__meta__"]).decode())
        ds = cls(attrs=meta.get("attrs", {}))
        for k in meta["coords"]:
            ds.coords[k] = npz[f"coord__{k}"]
        for k, info in meta["vars"].items():
            ds[k] = DataArray(
                npz[f"var__{k}"], tuple(info["dims"]), attrs=info.get("attrs", {})
            )
        return ds

    def to_xarray(self):
        """Convert to a real xarray.Dataset when xarray is installed."""
        import xarray as xr  # optional

        return xr.Dataset(
            {
                k: (v.dims, v.data, v.attrs)
                for k, v in self.data_vars.items()
            },
            coords=self.coords,
            attrs=self.attrs,
        )
