"""Modular hyperelasticity: ElastHyper, a sum of strain-energy summands.

Counterpart of fourc_tpu/materials/elasthyper.py for the summands the
ported decks use: CoupNeoHooke.  The reference differentiates the summed
energy psi(C) with AD; here each summand gives its PK2 stress in closed
form, in the cancellation-free form of NeoHooke.pk2_from_E, and the
element route (ops/solid.py) takes the stress's directional derivative
with forward-mode AD.

Deck syntax (as the reference's):
  {type: elasthyper, density: 0.1, summands: [
      {type: coupneohooke, youngs: 10.0, nue: 0.25}]}
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from fourc_tpu_torch.materials.base import Material, register_material
from fourc_tpu_torch.ops import common as gm

SUMMAND_REGISTRY: dict[str, type] = {}


def register_summand(name):
    def deco(cls):
        SUMMAND_REGISTRY[name.lower()] = cls
        return cls

    return deco


@register_summand("coupneohooke")
@dataclass
class CoupNeoHooke:
    """psi = c (I1 - 3) + c/beta (J^(-2 beta) - 1), c = E/(4(1+nu)),
    beta = nu/(1-2nu); at nu = 0 the volumetric term is its limit
    -2c ln J.  S = 2 dpsi/dC = 2c (I - J^(-2 beta) C^-1)."""

    youngs: float
    nue: float

    def pk2_from_E(self, E):
        """With A = 2E = C - I: S = 2c C^-1 (A - (J^(-2 beta) - 1) I) and
        J^(-2 beta) - 1 = expm1(-beta log1p(det C - 1)), det C - 1 formed
        from A without cancellation (as NeoHooke.pk2_from_E).  At beta = 0
        the bracket is A: the nu = 0 limit."""
        c = self.youngs / (4.0 * (1.0 + self.nue))
        beta = self.nue / (1.0 - 2.0 * self.nue)
        if abs(beta) < 1e-14:
            beta = 0.0
        A = 2.0 * E
        eye = gm.eye3l(A)
        trA = gm.tr3l(A)
        trA2 = gm.tr3l(gm.matmul3l(A, A))
        detC_m1 = trA + 0.5 * (trA * trA - trA2) + gm.det3l(A)
        Cinv = gm.inv3l(A + eye, 1.0 + detC_m1)
        vol = torch.expm1(-beta * torch.log1p(detC_m1))
        return 2.0 * c * gm.matmul3l(Cinv, A - vol * eye)


@register_material("elasthyper")
@dataclass
class ElastHyper(Material):
    """S = the sum of the summands' PK2 stresses."""

    summands: list = field(default_factory=list)
    density: float = 0.0

    @classmethod
    def from_deck(cls, params: dict):
        summands = []
        for spec in params.pop("summands"):
            spec = {k.lower(): v for k, v in spec.items()}
            typ = str(spec.pop("type")).lower()
            if typ not in SUMMAND_REGISTRY:
                raise NotImplementedError(
                    f"elasthyper summand {typ!r} is not ported; ported: "
                    f"{sorted(SUMMAND_REGISTRY)}")
            summands.append(SUMMAND_REGISTRY[typ](**spec))
        return cls(summands=summands, **params)

    def pk2_from_E(self, E):
        S = self.summands[0].pk2_from_E(E)
        for s in self.summands[1:]:
            S = S + s.pk2_from_E(E)
        return S
