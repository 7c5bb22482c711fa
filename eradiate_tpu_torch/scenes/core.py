# Host-code copy of eradiate_tpu/scenes/core.py; regenerate with tools/copy_host_code.py, do not edit.
"""Scene element core: declarative elements + factories.

Mirror of the reference's scene-generation layer entry points
(``src/eradiate/scenes/core.py``): users describe scenes with nested
dicts carrying ``"type"`` keys (or attrs-style element instances); factories
resolve them. The TPU-native difference (SURVEY §7.1 "scene IR"): elements
do not expand to a Mitsuba kernel dict — they *compile to array pytrees*
(:mod:`eradiate_tpu.ops.scene_state`) consumed directly by the jitted
engine, and spectral parameters are evaluated batched over the full
spectral grid instead of once per spectral loop iteration.
"""

from __future__ import annotations

import attrs

__all__ = ["SceneElement", "Factory"]


@attrs.define(eq=False, slots=False)
class SceneElement:
    """Base class for scene elements."""

    id: str | None = attrs.field(default=None, kw_only=True)


class Factory:
    """Registry mapping ``type`` ids to element classes.

    Mirror of the reference's dessinemoi-based factory (``_factory.py:13``),
    including the ``construct`` classmethod dispatch used by e.g.
    ``MultiDistantMeasure``: ``{"type": "mdistant", "construct": "hplane",
    ...}`` calls ``MultiDistantMeasure.hplane(...)``.
    """

    def __init__(self, name: str = "factory"):
        self.name = name
        self.registry: dict[str, type] = {}

    def register(self, type_id: str, cls=None, aliases=()):
        def wrap(c):
            self.registry[type_id] = c
            for a in aliases:
                self.registry[a] = c
            return c

        if cls is not None:
            return wrap(cls)
        return wrap

    def convert(self, value, allowed_cls=None):
        """Convert a dict (or pass through an instance) to an element."""
        if isinstance(value, dict):
            d = dict(value)
            try:
                type_id = d.pop("type")
            except KeyError:
                raise ValueError(
                    f"{self.name}: dict is missing required 'type' key: {value!r}"
                ) from None
            try:
                cls = self.registry[type_id]
            except KeyError:
                raise ValueError(
                    f"{self.name}: unknown type '{type_id}'; registered: "
                    f"{sorted(self.registry)}"
                ) from None
            construct = d.pop("construct", None)
            if construct is not None:
                return getattr(cls, construct)(**d)
            return cls(**d)
        if allowed_cls is not None and not isinstance(value, allowed_cls):
            raise TypeError(
                f"{self.name}: expected {allowed_cls}, got {type(value)}"
            )
        return value

    def keys(self):
        return self.registry.keys()
