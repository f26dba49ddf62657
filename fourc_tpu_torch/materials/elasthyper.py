"""Modular hyperelasticity: ElastHyper, a sum of strain-energy summands.

Counterpart of fourc_tpu/materials/elasthyper.py for the summands the
ported decks use: CoupNeoHooke, CoupLogNeoHooke and CoupAnisoExpo (with
GOH dispersion).  The reference differentiates the summed energy psi(C)
with AD; here each summand gives its PK2 stress in closed form, in the
cancellation-free form of NeoHooke.pk2_from_E, and the element route
(ops/solid.py) takes the stress's directional derivative with forward-mode
AD.

Deck syntax (as the reference's):
  {type: elasthyper, density: 0.1, summands: [
      {type: coupneohooke, youngs: 10.0, nue: 0.25},
      {type: coupanisoexpo, k1: 100.0, k2: 1.0, a: [1, 1, 0]}]}
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
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


def _detC_m1(A):
    """det C - 1 of C = I + A, formed from A without cancellation."""
    trA = gm.tr3l(A)
    return trA + 0.5 * (trA * trA - gm.tr3l(gm.matmul3l(A, A))) + gm.det3l(A)


@register_summand("couplogneohooke")
@dataclass
class CoupLogNeoHooke:
    """psi = mu/2 (I1 - 3) - mu ln J + lam/2 ln^2 J (Young's modulus and
    Poisson's ratio parametrisation); S = C^-1 (mu A + lam ln J I) with
    A = 2E = C - I and ln J = log1p(det C - 1) / 2 (NeoHooke's form)."""

    youngs: float
    nue: float

    def pk2_from_E(self, E):
        lam = self.youngs * self.nue / ((1 + self.nue) * (1 - 2 * self.nue))
        mu = self.youngs / (2 * (1 + self.nue))
        A = 2.0 * E
        eye = gm.eye3l(A)
        dm1 = _detC_m1(A)
        lnJ = 0.5 * torch.log1p(dm1)
        return gm.matmul3l(gm.inv3l(A + eye, 1.0 + dm1),
                           mu * A + lam * lnJ * eye)


@register_summand("coupanisoexpo")
@dataclass
class CoupAnisoExpo:
    """Fibre family: psi = k1/(2 k2) (exp(k2 x^2) - 1), x = I4* - 1, with the
    GOH dispersed invariant I4* = H : C, H = kappa I + (1 - 3 kappa) a (x) a
    (``a`` normalised; kappa 0 is the aligned fibre), and with
    ``tension_only`` x = max(I4* - 1, 0).  S = 2 k1 w x exp(k2 x^2) H.

    The reference takes S and its derivative by AD through
    ``jnp.maximum``, whose derivative at a tie is 1/2: at I4* = 1 exactly
    (every fibre of an undeformed mesh) the stress is 0 and the tangent
    carries a quarter of the fibre stiffness, above it all of it, below it
    none.  Here x = w y with the constant w = 1, 1/2 or 0 above, at or
    below the tie, so that forward-mode AD gives 2 k1 w^2 (1 + 2 k2 x^2)
    exp(k2 x^2) dy H, the same.  The branch is read from the reference's
    own invariant a . (C a) of C = 2E + I (so the tie falls where it falls
    there); the value is y = 2 H : E, without C's cancellation."""

    k1: float
    k2: float
    a: tuple = (1.0, 0.0, 0.0)
    tension_only: bool = True
    kappa: float = 0.0

    def pk2_from_E(self, E):
        a = np.asarray(self.a, dtype=np.float64)
        a = a / np.linalg.norm(a)
        k = self.kappa
        C = 2.0 * E + gm.eye3l(E)
        Ca = [C[i, 0] * a[0] + C[i, 1] * a[1] + C[i, 2] * a[2]
              for i in range(3)]
        I4 = a[0] * Ca[0] + a[1] * Ca[1] + a[2] * Ca[2]
        aEa = sum(a[i] * a[j] * E[i, j] for i in range(3) for j in range(3))
        if k:
            I4 = k * gm.tr3l(C) + (1.0 - 3.0 * k) * I4
            y = 2.0 * (k * gm.tr3l(E) + (1.0 - 3.0 * k) * aEa)
        else:
            y = 2.0 * aEa
        w = torch.ones_like(y)
        if self.tension_only:
            w = torch.where(I4 - 1.0 > 0, 1.0,
                            torch.where(I4 - 1.0 == 0, 0.5, 0.0))
        x = w * y
        Hs = torch.as_tensor(k * np.eye(3) + (1.0 - 3.0 * k) * np.outer(a, a),
                             dtype=E.dtype, device=E.device)
        Hs = Hs.reshape((3, 3) + (1,) * (E.dim() - 2))
        return (2.0 * self.k1) * (w * x * torch.exp(self.k2 * x * x)) * Hs


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
