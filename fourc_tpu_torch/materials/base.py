"""Material base class and registry (ported laws only).

Counterpart of fourc_tpu/materials/base.py.  Parameters are plain Python
floats.  Stress functions take leading-index batches: a (3, 3, ...) tensor
of strains gives a (3, 3, ...) tensor of stresses.  A law with Gauss-point
history (``HistoryMaterial``) takes its history in the same layout,
(nh, ...).
"""

from __future__ import annotations

import numpy as np
import torch

MATERIAL_REGISTRY: dict[str, type] = {}


def register_material(name):
    def deco(cls):
        MATERIAL_REGISTRY[name.lower()] = cls
        cls.deck_name = name.lower()
        return cls

    return deco


# laws of the fields the port carries that it refuses, with the reason
_MULTI = "multi-species scalar transport (ndpn > 1)"
UNPORTED_MATERIALS = {
    "scatra_stvenantkirchhoff": "scatra-structure interaction",
    "matlist": _MULTI, "matlist_reactions": _MULTI,
    "scatra_reaction": "coupled reactions of " + _MULTI,
    "soret": "thermodiffusion of scatra-thermo interaction",
    "ion": "electrochemistry", "newman": "electrochemistry",
    "electrode": "electrochemistry",
    **{name: "a non-Newtonian fluid law: the fluid residual reads a "
       "constant viscosity" for name in ("carreauyasuda", "modpowerlaw",
                                         "herschelbulkley")},
    **{name: "a low-Mach fluid law" for name in ("sutherland",
                                                  "murnaghantait")},
}


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
    if typ in UNPORTED_MATERIALS:
        raise NotImplementedError(
            f"material type {typ!r} is not ported ({UNPORTED_MATERIALS[typ]})")
    try:
        cls = MATERIAL_REGISTRY[typ]
    except KeyError:
        raise NotImplementedError(
            f"material type {typ!r} is not ported; ported: "
            f"{sorted(MATERIAL_REGISTRY)}") from None
    return cls.from_deck(spec)


class Material:
    """Base for all materials; ``history_shape`` () means no history.
    ``affine_in_strain``: the stress is affine in the strain, so
    ``pk2_from_E`` of an increment (and no temperature) is its derivative
    along it at any strain and temperature (the element route's tangent,
    ``ops.solid._law_derivative``)."""

    history_shape: tuple = ()
    affine_in_strain: bool = False

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
        zero, as the reference's base class gives it; a law whose
        reference seeds another start (crystal plasticity's [I, g0])
        overrides this."""
        return torch.zeros((n,) + tuple(self.history_shape), dtype=dtype,
                           device=device)


def elastic_moduli(m):
    """(youngs, nue) of the linear-elastic operator that SA-AMG assembles
    for a block of law ``m``: those the law names (``elastic_moduli()``,
    a law without its own), else its own; None where it has neither."""
    named = getattr(m, "elastic_moduli", None)
    if named is not None:
        return named()
    if hasattr(m, "youngs") and hasattr(m, "nue"):
        return float(m.youngs), float(m.nue)
    return None


def dt_or_zero(dt):
    """The dt of a law whose reference defaults it to 0.0 (the element
    route's call without one, at the initial state)."""
    return 0.0 if dt is None else float(dt)


def unit_vector(a, like):
    """``a`` normalised in float64, then cast to the dtype of ``like`` on
    its device, as the reference's ``_unit(a).astype(dtype)``; shaped
    (3, 1, ...) against a leading-index tensor ``like`` (3, 3, ...)."""
    a = np.asarray(a, dtype=np.float64)
    return torch.as_tensor(a / np.linalg.norm(a), dtype=like.dtype,
                           device=like.device).reshape(
                               (3,) + (1,) * (like.dim() - 2))


def quad_form(a, C):
    """a . (C a) of a (3, 1, ...) vector and a (3, 3, ...) tensor, in the
    reference's order (C a first), term by term."""
    Ca = [C[i, 0] * a[0] + C[i, 1] * a[1] + C[i, 2] * a[2] for i in range(3)]
    return a[0] * Ca[0] + a[1] * Ca[1] + a[2] * Ca[2]


def outer(a, b):
    """a (x) b of two (3, ...) vectors: (3, 3, ...)."""
    return a[:, None] * b[None]


# The reference's return maps clip with jnp.maximum, jnp.minimum, jnp.clip
# and jnp.abs, whose forward derivatives differ from torch's at a tie: the
# mean of both sides (torch's clamp takes 1 at a bound, maximum and minimum
# one side), and +1 for abs at 0 (torch's 0).  Newton's iteration counts
# follow these derivatives where a state sits on a bound (u = 0 in the
# first iteration of every step), so the laws take them from here.


def maximum(a, b):
    """``jnp.maximum(a, b)``: at a tie the value a and the derivative the
    mean of both sides'; ``b`` a tensor or a number."""
    return torch.where(a > b, a, torch.where(a < b, b, 0.5 * (a + b)))


def dmaximum(a, b):
    """The derivative of ``jnp.maximum(a, b)`` in a: 1, 1/2 at a tie, 0."""
    return torch.where(a > b, 1.0, torch.where(a < b, 0.0, 0.5))


def minimum(a, b):
    """``jnp.minimum(a, b)``, with ``maximum``'s tie rule."""
    return torch.where(a < b, a, torch.where(a > b, b, 0.5 * (a + b)))


def clip(x, lo, hi):
    """``jnp.clip(x, lo, hi)`` = minimum(hi, maximum(lo, x)): derivative
    1/2 at either bound."""
    return minimum(maximum(x, lo), hi)


def abs1(x):
    """``jnp.abs``: derivative +1 at 0 (torch.abs's is 0 there)."""
    return torch.where(x < 0, -x, x)
