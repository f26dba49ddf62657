"""Material base class and registry (ported laws only).

Counterpart of fourc_tpu/materials/base.py.  Parameters are plain Python
floats.  Stress functions take leading-index batches: a (3, 3, ...) tensor
of strains gives a (3, 3, ...) tensor of stresses.  A law with Gauss-point
history (``HistoryMaterial``) takes its history in the same layout,
(nh, ...).
"""

from __future__ import annotations

import torch

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


class HistoryMaterial(Material):
    """A law with per-Gauss-point internal variables (the reference's
    HistoryMaterial).  ``evaluate(C, h, dt)`` under nonlinear kinematics
    (C = 2E + I) and ``evaluate_small(eps, h, dt)`` under linear
    kinematics give ``(stress, h_new)`` for leading-index batches:
    C or eps (3, 3, ...), h (nh, ...).  The element route passes dt = None
    where the reference passes none (the initial state), and each law reads
    dt only if the reference's does.  The steps keep h of the last converged
    step and replace it only after convergence.  Every law is branch-free
    (``torch.where``), so that forward-mode AD and ``torch.func.vmap`` pass
    through its return map."""

    history_shape: tuple = ()

    def init_history(self, n, dtype=torch.float64, device="cpu"):
        """The history of n Gauss points before the first step, (n, nh):
        zero for every ported law (the reference's)."""
        return torch.zeros((n,) + tuple(self.history_shape), dtype=dtype,
                           device=device)


def max0(x):
    """max(x, 0) whose forward-mode derivative at x = 0 is 1/2, as
    ``jnp.maximum``'s (torch.maximum's is 0 there)."""
    return x * torch.where(x > 0, 1.0, torch.where(x == 0, 0.5, 0.0))
