"""Material base class and registry (ported laws only).

Counterpart of fourc_tpu/materials/base.py.  Parameters are plain Python
floats.  Stress functions take leading-index batches: a (3, 3, ...) tensor
of strains gives a (3, 3, ...) tensor of stresses.
"""

from __future__ import annotations

MATERIAL_REGISTRY: dict[str, type] = {}


def register_material(name):
    def deco(cls):
        MATERIAL_REGISTRY[name.lower()] = cls
        cls.deck_name = name.lower()
        return cls

    return deco


def make_material(spec: dict):
    """Create a material from a deck spec ``{"type": name, **params}``."""
    spec = {k.lower(): v for k, v in spec.items()}
    for k, v in spec.items():
        if isinstance(v, str):
            try:
                spec[k] = float(v)
            except ValueError:
                pass
    typ = str(spec.pop("type")).lower()
    try:
        cls = MATERIAL_REGISTRY[typ]
    except KeyError:
        raise NotImplementedError(
            f"material type {typ!r} is not ported; ported: "
            f"{sorted(MATERIAL_REGISTRY)}") from None
    return cls.from_deck(spec)


class Material:
    """Base for all materials; ``history_shape`` () means no history."""

    history_shape: tuple = ()

    @classmethod
    def from_deck(cls, params: dict):
        return cls(**params)
