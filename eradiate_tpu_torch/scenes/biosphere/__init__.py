# Host-code copy of eradiate_tpu/scenes/biosphere/__init__.py; regenerate with tools/copy_host_code.py, do not edit.
"""Biosphere (canopy) scene elements.

Mirror of ``src/eradiate/scenes/biosphere/`` (factory at ``_core.py:23-55``:
leaf_cloud, discrete_canopy, instanced elements, RAMI scenario loaders).
Leaf clouds are disk sets generated host-side with deterministic numpy RNG
(reference generators at ``_leaf_cloud.py:25-210``); canopies compile to
flat :class:`~eradiate_tpu.ops.canopy.LeafCloudArrays`.

Lengths in km at compile time; the config surface accepts meters (the
reference's canopy sizes are meter-scale) via unit-tagged values.
"""

from __future__ import annotations

import attrs
import numpy as np

from ...core.units import to_quantity
from ..bsdfs import BiLambertianBSDF, BSDF, bsdf_factory
from ..core import Factory, SceneElement

__all__ = [
    "LeafCloud",
    "AbstractTree",
    "MeshTree",
    "MeshTreeElement",
    "DiscreteCanopy",
    "InstancedCanopyElement",
    "biosphere_factory",
    # RAMI-V scenarios (re-exported from .rami)
    "RAMIActualCanopies",
    "RAMIHeterogeneousAbstractCanopies",
    "RAMIHomogeneousAbstractCanopies",
    "RAMIScenarioVariant",
    "generate_name",
    "load_rami_scenario",
    "load_scenario",
]

biosphere_factory = Factory("biosphere")


def _km(value, default_units="m"):
    q = to_quantity(value, default_units)
    return np.asarray(q.m_as("km"), dtype=np.float64)


def _sample_inclination(rng, n, mu=1.066, nu=1.853):
    """Goel & Strebel (1984) leaf-normal inclination sampling: theta_n =
    2 theta / pi ~ Beta(mu, nu). Defaults approximate a spherical LAD."""
    t = rng.beta(mu, nu, size=n)
    return t * (np.pi / 2.0)


def _orientations(rng, n, mu, nu):
    theta = _sample_inclination(rng, n, mu, nu)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    st, ct = np.sin(theta), np.cos(theta)
    return np.stack([st * np.cos(phi), st * np.sin(phi), ct], axis=-1)


@biosphere_factory.register("leaf_cloud")
@attrs.define(eq=False, slots=False)
class LeafCloud(SceneElement):
    """A cloud of disk-shaped leaves (``_leaf_cloud.py``).

    Construct directly from arrays or via the generators
    ``cuboid``/``sphere``/``ellipsoid``/``cylinder``/``cone``.
    """

    positions: np.ndarray = attrs.field(default=None)  # [N, 3] km
    orientations: np.ndarray = attrs.field(default=None)  # [N, 3] unit
    radii: np.ndarray = attrs.field(default=None)  # [N] km
    leaf_reflectance: object = 0.5
    leaf_transmittance: object = 0.5

    def __attrs_post_init__(self):
        if self.positions is not None:
            self.positions = np.atleast_2d(np.asarray(self.positions, dtype=np.float64))
            self.orientations = np.atleast_2d(
                np.asarray(self.orientations, dtype=np.float64)
            )
            self.radii = np.atleast_1d(np.asarray(self.radii, dtype=np.float64))

    # -- generators (mirror of ``_leaf_cloud.py:25-210``) -----------------
    @classmethod
    def cuboid(
        cls,
        n_leaves: int = 1000,
        leaf_radius=0.05,
        l_horizontal=10.0,
        l_vertical=1.0,
        mu: float = 1.066,
        nu: float = 1.853,
        seed: int = 12345,
        **kwargs,
    ) -> "LeafCloud":
        rng = np.random.default_rng(seed)
        lh = float(_km(l_horizontal))
        lv = float(_km(l_vertical))
        r = float(_km(leaf_radius))
        pos = rng.uniform(
            [-lh / 2, -lh / 2, 0.0], [lh / 2, lh / 2, lv], size=(n_leaves, 3)
        )
        return cls(
            positions=pos,
            orientations=_orientations(rng, n_leaves, mu, nu),
            radii=np.full(n_leaves, r),
            **kwargs,
        )

    @classmethod
    def sphere(
        cls, n_leaves=1000, leaf_radius=0.05, radius=1.0, center=(0, 0, 1.0),
        mu=1.066, nu=1.853, seed=12345, **kwargs,
    ) -> "LeafCloud":
        rng = np.random.default_rng(seed)
        R = float(_km(radius))
        c = _km(np.asarray(center, dtype=np.float64))
        u = rng.normal(size=(n_leaves, 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        rr = R * rng.uniform(0, 1, n_leaves) ** (1 / 3)
        pos = c[None, :] + u * rr[:, None]
        return cls(
            positions=pos,
            orientations=_orientations(rng, n_leaves, mu, nu),
            radii=np.full(n_leaves, float(_km(leaf_radius))),
            **kwargs,
        )

    @classmethod
    def ellipsoid(
        cls, n_leaves=1000, leaf_radius=0.05, a=1.0, b=1.0, c=0.5,
        center=(0, 0, 0.5), mu=1.066, nu=1.853, seed=12345, **kwargs,
    ) -> "LeafCloud":
        rng = np.random.default_rng(seed)
        u = rng.normal(size=(n_leaves, 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        rr = rng.uniform(0, 1, n_leaves) ** (1 / 3)
        unit = u * rr[:, None]
        scale = np.array([float(_km(a)), float(_km(b)), float(_km(c))])
        pos = unit * scale[None, :] + _km(np.asarray(center, dtype=np.float64))[None, :]
        return cls(
            positions=pos,
            orientations=_orientations(rng, n_leaves, mu, nu),
            radii=np.full(n_leaves, float(_km(leaf_radius))),
            **kwargs,
        )

    @classmethod
    def cylinder(
        cls, n_leaves=1000, leaf_radius=0.05, radius=1.0, l_vertical=1.0,
        center=(0, 0, 0), mu=1.066, nu=1.853, seed=12345, **kwargs,
    ) -> "LeafCloud":
        rng = np.random.default_rng(seed)
        R = float(_km(radius))
        H = float(_km(l_vertical))
        c = _km(np.asarray(center, dtype=np.float64))
        rr = R * np.sqrt(rng.uniform(0, 1, n_leaves))
        phi = rng.uniform(0, 2 * np.pi, n_leaves)
        z = rng.uniform(0, H, n_leaves)
        pos = np.stack([rr * np.cos(phi), rr * np.sin(phi), z], axis=-1) + c
        return cls(
            positions=pos,
            orientations=_orientations(rng, n_leaves, mu, nu),
            radii=np.full(n_leaves, float(_km(leaf_radius))),
            **kwargs,
        )

    @classmethod
    def cone(
        cls, n_leaves=1000, leaf_radius=0.05, radius=1.0, l_vertical=1.0,
        center=(0, 0, 0), mu=1.066, nu=1.853, seed=12345, **kwargs,
    ) -> "LeafCloud":
        rng = np.random.default_rng(seed)
        R = float(_km(radius))
        H = float(_km(l_vertical))
        c = _km(np.asarray(center, dtype=np.float64))
        # uniform in a cone (apex up): z ~ 1 - u^(1/3)
        zfrac = 1.0 - rng.uniform(0, 1, n_leaves) ** (1.0 / 3.0)
        rmax = R * (1.0 - zfrac)
        rr = rmax * np.sqrt(rng.uniform(0, 1, n_leaves))
        phi = rng.uniform(0, 2 * np.pi, n_leaves)
        pos = np.stack([rr * np.cos(phi), rr * np.sin(phi), zfrac * H], axis=-1) + c
        return cls(
            positions=pos,
            orientations=_orientations(rng, n_leaves, mu, nu),
            radii=np.full(n_leaves, float(_km(leaf_radius))),
            **kwargs,
        )

    # -- interface ---------------------------------------------------------
    @property
    def n_leaves(self) -> int:
        return 0 if self.positions is None else self.positions.shape[0]

    @classmethod
    def from_file(
        cls,
        filename,
        leaf_reflectance=0.5,
        leaf_transmittance=0.5,
        **kwargs,
    ) -> "LeafCloud":
        """Load a leaf cloud from the reference's text format
        (``_leaf_cloud.py:1049``): one leaf per line, 7 whitespace-
        separated numbers ``radius x y z nx ny nz``, all in METRES
        (converted to the kernel's km here); normals are renormalized.
        """
        import os

        if not os.path.isfile(filename):
            raise FileNotFoundError(f"no file at {filename} found.")
        data = np.loadtxt(filename, dtype=np.float64, ndmin=2)
        if data.shape[1] < 7:
            raise ValueError(
                f"leaf cloud file {filename} needs 7 columns "
                f"(radius x y z nx ny nz), got {data.shape[1]}"
            )
        radii = data[:, 0] * 1e-3  # m -> km
        positions = data[:, 1:4] * 1e-3
        normals = data[:, 4:7]
        norm = np.linalg.norm(normals, axis=1, keepdims=True)
        normals = normals / np.where(norm > 0, norm, 1.0)
        return cls(
            positions=positions,
            orientations=normals,
            radii=radii,
            leaf_reflectance=leaf_reflectance,
            leaf_transmittance=leaf_transmittance,
            **kwargs,
        )

    def translated(self, offset_km) -> "LeafCloud":
        out = LeafCloud(
            positions=self.positions + np.asarray(offset_km)[None, :],
            orientations=self.orientations,
            radii=self.radii,
            leaf_reflectance=self.leaf_reflectance,
            leaf_transmittance=self.leaf_transmittance,
        )
        return out

    def extent(self) -> tuple:
        lo = self.positions.min(axis=0) - self.radii.max()
        hi = self.positions.max(axis=0) + self.radii.max()
        return lo, hi


@biosphere_factory.register("abstract_tree")
@attrs.define(eq=False, slots=False)
class AbstractTree(SceneElement):
    """Abstract tree: cylindrical trunk + leaf-cloud crown (reference
    ``scenes/biosphere/_tree.py:44``). The trunk spans
    ``[-0.1 trunk_height, trunk_height]`` along z (extends below the ground
    plane to avoid gaps, mirroring the reference) and the leaf cloud is
    shifted up by ``trunk_height + leaf_cloud_extra_offset``."""

    leaf_cloud: LeafCloud = attrs.field(default=None)
    trunk_height: object = 1.0  # m at the config surface
    trunk_radius: object = 0.1  # m
    trunk_reflectance: object = 0.125
    leaf_cloud_extra_offset: object = (0.0, 0.0, 0.0)  # m

    def __attrs_post_init__(self):
        if isinstance(self.leaf_cloud, dict):
            d = dict(self.leaf_cloud)
            d.setdefault("type", "leaf_cloud")
            self.leaf_cloud = biosphere_factory.convert(d)

    def leaf_part(self) -> LeafCloud | None:
        if self.leaf_cloud is None:
            return None
        off = _km(np.asarray(self.leaf_cloud_extra_offset, dtype=np.float64))
        h = float(_km(self.trunk_height))
        return self.leaf_cloud.translated(off + np.array([0.0, 0.0, h]))

    def mesh_part(self):
        """Trunk triangles (vertices, faces, reflectance, transmittance)."""
        from ...ops.mesh import cylinder_mesh

        h = float(_km(self.trunk_height))
        r = float(_km(self.trunk_radius))
        v, f = cylinder_mesh(r, 1.1 * h, center=(0.0, 0.0, -0.1 * h))
        return v, f, self.trunk_reflectance, 0.0


@attrs.define(eq=False, slots=False)
class MeshTreeElement(SceneElement):
    """One mesh component of a mesh-based tree (reference
    ``scenes/biosphere/_tree.py:287``): OBJ/PLY file + bilambertian
    optics."""

    mesh_filename: str = attrs.field(default=None)
    mesh_units: str = "m"
    reflectance: object = 0.5
    transmittance: object = 0.0

    def triangles(self):
        from ..shapes import FileMeshShape

        return FileMeshShape(
            filename=self.mesh_filename, mesh_units=self.mesh_units
        ).triangles()


@biosphere_factory.register("mesh_tree")
@attrs.define(eq=False, slots=False)
class MeshTree(SceneElement):
    """A tree assembled from triangle-mesh components (reference
    ``scenes/biosphere/_tree.py:216``)."""

    mesh_tree_elements: list = attrs.field(factory=list)

    def __attrs_post_init__(self):
        self.mesh_tree_elements = [
            MeshTreeElement(**e) if isinstance(e, dict) else e
            for e in self.mesh_tree_elements
        ]

    def leaf_part(self):
        return None

    def mesh_part(self):
        vs, fs = [], []
        offset = 0
        refl, trans = 0.5, 0.0
        for i, el in enumerate(self.mesh_tree_elements):
            v, f = el.triangles()
            vs.append(v)
            fs.append(f + offset)
            offset += v.shape[0]
            if i == 0:
                refl, trans = el.reflectance, el.transmittance
        if not vs:
            return None
        return np.concatenate(vs), np.concatenate(fs), refl, trans


@biosphere_factory.register("discrete_canopy")
@attrs.define(eq=False, slots=False)
class DiscreteCanopy(SceneElement):
    """A canopy made of (possibly instanced) leaf clouds
    (``_discrete.py:29-209``).

    ``instanced_canopy_elements``: list of (LeafCloud, instance positions).
    ``padded_copy`` replicates the full canopy on a (2p+1)^2 horizontal
    grid (mirror of the reference's scene padding).
    """

    #: canopy extent; bare numbers are meters, converted to km internally
    size: object = (10.0, 10.0, 1.0)
    instanced_canopy_elements: list = attrs.field(factory=list)
    _size_km: np.ndarray = attrs.field(default=None, init=False, repr=False)

    def __attrs_post_init__(self):
        self._size_km = _km(np.asarray(self.size, dtype=np.float64))
        self.instanced_canopy_elements = [
            biosphere_factory.convert(e) if isinstance(e, dict) else e
            for e in self.instanced_canopy_elements
        ]

    @property
    def size_km(self) -> np.ndarray:
        return self._size_km

    @classmethod
    def homogeneous(cls, **kwargs) -> "DiscreteCanopy":
        """Single cuboid leaf cloud filling the canopy extent
        (mirror of ``DiscreteCanopy.homogeneous``)."""
        size_kw = {}
        for k in ("l_horizontal", "l_vertical"):
            if k in kwargs:
                size_kw[k] = kwargs[k]
        cloud = LeafCloud.cuboid(**kwargs)
        lh = size_kw.get("l_horizontal", 10.0)
        lv = size_kw.get("l_vertical", 1.0)
        return cls(
            size=(lh, lh, lv),
            instanced_canopy_elements=[
                InstancedCanopyElement(
                    canopy_element=cloud, instance_positions=np.zeros((1, 3))
                )
            ],
        )

    @classmethod
    def leaf_cloud_from_files(
        cls, size, leaf_cloud_dicts, padding: int = 0, id: str = "discrete_canopy"
    ) -> "DiscreteCanopy":
        """Create a canopy from text-file specifications (mirror of
        ``_discrete.py:290-360``). Each dict in ``leaf_cloud_dicts``:

        - ``leaf_cloud_filename``: leaf file, 7 cols
          ``radius x y z nx ny nz`` [m] (:meth:`LeafCloud.from_file`);
        - ``instance_filename``: instance positions, one ``x y z`` [m]
          triple per line;
        - optional ``leaf_reflectance`` / ``leaf_transmittance`` /
          ``sub_id``.

        ``size`` is the canopy extent in metres (3-vector).
        """
        elements = []
        for d in leaf_cloud_dicts:
            cloud = LeafCloud.from_file(
                d["leaf_cloud_filename"],
                leaf_reflectance=d.get("leaf_reflectance", 0.5),
                leaf_transmittance=d.get("leaf_transmittance", 0.5),
            )
            positions = np.loadtxt(
                d["instance_filename"], dtype=np.float64, ndmin=2
            )
            if positions.shape[1] != 3:
                raise ValueError(
                    f"instance file {d['instance_filename']} needs 3 "
                    f"columns (x y z), got {positions.shape[1]}"
                )
            elements.append(
                InstancedCanopyElement(
                    canopy_element=cloud,
                    instance_positions=positions * 1e-3,  # m -> km
                )
            )
        canopy = cls(size=size, instanced_canopy_elements=elements)
        return canopy.padded_copy(padding)

    def padded_copy(self, padding: int) -> "DiscreteCanopy":
        """Replicate the canopy on a (2 padding + 1)^2 grid."""
        if padding <= 0:
            return self
        lh = float(self._size_km[0])
        elements = []
        for el in self.instanced_canopy_elements:
            offsets = []
            for i in range(-padding, padding + 1):
                for j in range(-padding, padding + 1):
                    offsets.append([i * lh, j * lh, 0.0])
            new_pos = (
                el.instance_positions[:, None, :] + np.asarray(offsets)[None, :, :]
            ).reshape(-1, 3)
            elements.append(
                InstancedCanopyElement(
                    canopy_element=el.canopy_element, instance_positions=new_pos
                )
            )
        return DiscreteCanopy(size=self.size, instanced_canopy_elements=elements)

    def flatten(self) -> LeafCloud:
        """Materialize all instances into a single leaf cloud (meshes
        dropped; use :meth:`flatten_full` when trees are present)."""
        return self.flatten_full()[0]

    def flatten_full(self):
        """Materialize instances into (LeafCloud, mesh | None).

        ``mesh`` is a dict {vertices, faces, reflectance, transmittance}
        merging every trunk / mesh-tree component (the engine carries one
        bilambertian optics set for the whole soup; the first component's
        values win)."""
        pos, ori, rad = [], [], []
        ref = None
        trans = None
        mesh_v, mesh_f = [], []
        mesh_offset = 0
        mesh_ref, mesh_trans = None, None
        for el in self.instanced_canopy_elements:
            element = el.canopy_element
            if isinstance(element, LeafCloud):
                cloud, mesh = element, None
            else:  # tree-like: leaf_part / mesh_part protocol
                cloud = element.leaf_part()
                mesh = element.mesh_part()
            if cloud is not None:
                ref = cloud.leaf_reflectance if ref is None else ref
                trans = cloud.leaf_transmittance if trans is None else trans
            for p in np.atleast_2d(el.instance_positions):
                if cloud is not None:
                    pos.append(cloud.positions + p[None, :])
                    ori.append(cloud.orientations)
                    rad.append(cloud.radii)
                if mesh is not None:
                    v, f, r, t = mesh
                    mesh_v.append(v + p[None, :])
                    mesh_f.append(f + mesh_offset)
                    mesh_offset += v.shape[0]
                    if mesh_ref is None:
                        mesh_ref, mesh_trans = r, t
        flat = LeafCloud(
            positions=np.concatenate(pos) if pos else np.zeros((0, 3)),
            orientations=np.concatenate(ori) if ori else np.zeros((0, 3)),
            radii=np.concatenate(rad) if rad else np.zeros((0,)),
            leaf_reflectance=ref if ref is not None else 0.5,
            leaf_transmittance=trans if trans is not None else 0.5,
        )
        mesh_out = None
        if mesh_v:
            mesh_out = {
                "vertices": np.concatenate(mesh_v),
                "faces": np.concatenate(mesh_f),
                "reflectance": mesh_ref,
                "transmittance": mesh_trans,
            }
        return flat, mesh_out


@biosphere_factory.register("instanced")
@attrs.define(eq=False, slots=False)
class InstancedCanopyElement(SceneElement):
    """Canopy element + instance positions (``_core.py:130``)."""

    canopy_element: LeafCloud = attrs.field(default=None)
    instance_positions: np.ndarray = attrs.field(factory=lambda: np.zeros((1, 3)))

    def __attrs_post_init__(self):
        if isinstance(self.canopy_element, dict):
            self.canopy_element = biosphere_factory.convert(self.canopy_element)
        self.instance_positions = np.atleast_2d(
            np.asarray(self.instance_positions, dtype=np.float64)
        )


from .rami import (  # noqa: E402
    RAMIActualCanopies,
    RAMIHeterogeneousAbstractCanopies,
    RAMIHomogeneousAbstractCanopies,
    RAMIScenarioVariant,
    generate_name,
    load_rami_scenario,
    load_scenario,
)
