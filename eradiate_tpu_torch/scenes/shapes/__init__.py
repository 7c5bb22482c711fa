# Host-code copy of eradiate_tpu/scenes/shapes/__init__.py; regenerate with tools/copy_host_code.py, do not edit.
"""Shape scene elements.

Mirror of ``src/eradiate/scenes/shapes/`` (factory at ``_core.py:15-23``:
cuboid, rectangle, sphere, file_mesh, buffer_mesh). In the TPU engine the
1D geometries carry analytic ground/atmosphere shapes, so stand-alone shape
elements exist for (a) triangle-mesh canopy/tree workloads and (b) scene
construction parity. All shapes expose ``triangles() -> (vertices [V, 3],
faces [N, 3])`` in km.
"""

from __future__ import annotations

import os

import attrs
import numpy as np

from ...core.units import to_quantity
from ..core import Factory, SceneElement

__all__ = [
    "Shape",
    "RectangleShape",
    "CuboidShape",
    "SphereShape",
    "BufferMeshShape",
    "FileMeshShape",
    "load_obj",
    "load_ply",
    "shape_factory",
]

shape_factory = Factory("shape")


def _km(value, default_units="km"):
    return np.asarray(to_quantity(value, default_units).m_as("km"), dtype=np.float64)


@attrs.define(eq=False, slots=False)
class Shape(SceneElement):
    """Base shape element."""

    def triangles(self):
        """(vertices [V, 3], faces [N, 3] int) in km."""
        raise NotImplementedError


@shape_factory.register("rectangle")
@attrs.define(eq=False, slots=False)
class RectangleShape(Shape):
    """Axis-aligned rectangle in the z = ``altitude`` plane
    (``scenes/shapes/_rectangle.py``)."""

    edges: object = (1.0, 1.0)  # km
    center: object = (0.0, 0.0, 0.0)

    def triangles(self):
        ex, ey = np.atleast_1d(_km(self.edges)).ravel()[:2] / 2.0
        c = _km(np.asarray(self.center, dtype=np.float64))
        v = np.array(
            [
                [-ex, -ey, 0.0],
                [ex, -ey, 0.0],
                [ex, ey, 0.0],
                [-ex, ey, 0.0],
            ]
        ) + c
        f = np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int64)
        return v, f


@shape_factory.register("cuboid")
@attrs.define(eq=False, slots=False)
class CuboidShape(Shape):
    """Axis-aligned box (``scenes/shapes/_cuboid.py``)."""

    edges: object = (1.0, 1.0, 1.0)  # km
    center: object = (0.0, 0.0, 0.0)

    def triangles(self):
        e = np.atleast_1d(_km(self.edges)).ravel()[:3] / 2.0
        c = _km(np.asarray(self.center, dtype=np.float64))
        sgn = np.array(
            [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
        )
        v = sgn * e[None, :] + c
        # 12 triangles, outward winding
        f = np.array(
            [
                [0, 2, 3], [0, 3, 1],  # x = -e
                [4, 5, 7], [4, 7, 6],  # x = +e
                [0, 1, 5], [0, 5, 4],  # y = -e
                [2, 6, 7], [2, 7, 3],  # y = +e
                [0, 4, 6], [0, 6, 2],  # z = -e
                [1, 3, 7], [1, 7, 5],  # z = +e
            ],
            dtype=np.int64,
        )
        return v, f


@shape_factory.register("sphere")
@attrs.define(eq=False, slots=False)
class SphereShape(Shape):
    """UV-sphere triangulation (``scenes/shapes/_sphere.py``)."""

    radius: object = 1.0  # km
    center: object = (0.0, 0.0, 0.0)
    n_theta: int = 12
    n_phi: int = 24

    def triangles(self):
        R = float(_km(self.radius))
        c = _km(np.asarray(self.center, dtype=np.float64))
        th = np.linspace(0.0, np.pi, self.n_theta + 1)
        ph = np.linspace(0.0, 2 * np.pi, self.n_phi, endpoint=False)
        tt, pp = np.meshgrid(th, ph, indexing="ij")
        v = np.stack(
            [
                R * np.sin(tt) * np.cos(pp),
                R * np.sin(tt) * np.sin(pp),
                R * np.cos(tt),
            ],
            axis=-1,
        ).reshape(-1, 3) + c
        faces = []
        for i in range(self.n_theta):
            for j in range(self.n_phi):
                j1 = (j + 1) % self.n_phi
                a = i * self.n_phi + j
                b = i * self.n_phi + j1
                cidx = (i + 1) * self.n_phi + j
                didx = (i + 1) * self.n_phi + j1
                if i > 0:
                    faces.append([a, b, cidx])
                if i < self.n_theta - 1:
                    faces.append([b, didx, cidx])
        return v, np.asarray(faces, dtype=np.int64)


@shape_factory.register("buffer_mesh")
@attrs.define(eq=False, slots=False)
class BufferMeshShape(Shape):
    """In-memory triangle mesh (``scenes/shapes/_buffermesh.py``):
    vertices [V, 3] + faces [N, 3]."""

    vertices: np.ndarray = attrs.field(default=None)
    faces: np.ndarray = attrs.field(default=None)
    #: units the vertex coordinates are expressed in
    mesh_units: str = "km"

    def __attrs_post_init__(self):
        self.vertices = np.atleast_2d(np.asarray(self.vertices, dtype=np.float64))
        self.faces = np.atleast_2d(np.asarray(self.faces, dtype=np.int64))

    def triangles(self):
        scale = float(to_quantity(1.0, self.mesh_units).m_as("km"))
        return self.vertices * scale, self.faces


def load_obj(path):
    """Minimal Wavefront OBJ reader: ``v`` and (fan-triangulated) ``f``
    records; 1-based indices with negative-index support."""
    vertices, faces = [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                vertices.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = []
                for tok in parts[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(vertices) + i)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    if not vertices or not faces:
        raise ValueError(f"no mesh data found in OBJ file {path!r}")
    return (
        np.asarray(vertices, dtype=np.float64),
        np.asarray(faces, dtype=np.int64),
    )


def load_ply(path):
    """Minimal ASCII PLY reader (vertex xyz + face vertex lists)."""
    with open(path, "rb") as fh:
        header = []
        while True:
            line = fh.readline().decode("ascii", "replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next((h for h in header if h.startswith("format")), "")
        if "ascii" not in fmt:
            raise ValueError("only ASCII PLY files are supported")
        counts = {}
        order = []
        for h in header:
            if h.startswith("element"):
                _, name, n = h.split()
                counts[name] = int(n)
                order.append(name)
        vertices, faces = [], []
        for name in order:
            for _ in range(counts[name]):
                parts = fh.readline().split()
                if name == "vertex":
                    vertices.append([float(x) for x in parts[:3]])
                elif name == "face":
                    k = int(parts[0])
                    idx = [int(x) for x in parts[1 : 1 + k]]
                    for j in range(1, k - 1):
                        faces.append([idx[0], idx[j], idx[j + 1]])
    return (
        np.asarray(vertices, dtype=np.float64),
        np.asarray(faces, dtype=np.int64),
    )


@shape_factory.register("file_mesh")
@attrs.define(eq=False, slots=False)
class FileMeshShape(Shape):
    """Triangle mesh loaded from an OBJ or PLY file
    (``scenes/shapes/_filemesh.py``)."""

    filename: str = attrs.field(default=None)
    mesh_units: str = "km"

    def triangles(self):
        ext = os.path.splitext(str(self.filename))[1].lower()
        if ext == ".obj":
            v, f = load_obj(self.filename)
        elif ext == ".ply":
            v, f = load_ply(self.filename)
        else:
            raise ValueError(f"unsupported mesh format '{ext}' (obj/ply)")
        scale = float(to_quantity(1.0, self.mesh_units).m_as("km"))
        return v * scale, f
