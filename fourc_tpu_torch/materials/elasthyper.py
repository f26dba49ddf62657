"""Modular hyperelasticity: ElastHyper, a sum of strain-energy summands.

Counterpart of fourc_tpu/materials/elasthyper.py for the summands the
ported decks use: CoupNeoHooke, CoupLogNeoHooke, CoupAnisoExpo (with
GOH dispersion), IsoOgden and VolSussmanBathe.  The reference
differentiates the summed energy psi(C) with AD; here each summand gives
its PK2 stress in closed form, in the cancellation-free form of
NeoHooke.pk2_from_E, and the element route (ops/solid.py) takes the
stress's directional derivative with forward-mode AD.

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


# the reference's eigenvalue jitter diag(1, 2, 3) 1e-10 (part of its energy:
# it splits coincident principal stretches)
EIG_JITTER = (1e-10, 2e-10, 3e-10)


def _pow_dd(a, b, p):
    """First divided difference of x^p, (a^p - b^p) / (a - b), with its
    limit p a^(p-1) at a = b; for a != b formed as
    b^p expm1(p log1p((a - b) / b)) / (a - b), accurate to a few ulps however
    close a and b are (a - b is exact there)."""
    d = a - b
    tie = d == 0
    dd = torch.where(tie, 1.0, d)
    return torch.where(tie, p * a ** (p - 1),
                       b ** p * torch.expm1(p * torch.log1p(d / b)) / dd)


def spd_power(A, p):
    """(A^p, tr A^(p+1)) of a batch of symmetric positive definite matrices
    A (3, 3, ...), to first order exact: the values from the spectrum of A
    (``torch.linalg.eigh``, detached), the forward-mode derivative by the
    Daleckii-Krein formula dA^p = Q (Phi o Q^T dA Q) Q^T, Phi_ij the first
    divided difference of x^p at the eigenvalues mu_i, mu_j (``_pow_dd``,
    p mu^(p-1) at a tie), and d tr A^(p+1) = (p + 1) tr(A^p dA).  Nothing
    divides by an eigenvalue gap, so the derivative stays finite and
    accurate at coincident eigenvalues, where one taken through the
    eigenvectors of ``eigh`` does not.  The second derivative is not
    carried (the spectrum is a constant of the derivative)."""
    batch = A.shape[2:]
    Ab = A.reshape(3, 3, -1).permute(2, 0, 1)  # (M, 3, 3)
    Ad = Ab.detach()
    mu, Q = torch.linalg.eigh(Ad)  # ascending, (M, 3), (M, 3, 3)
    Phi = _pow_dd(mu[:, :, None], mu[:, None, :], p)  # (M, 3, 3)
    dB = Q.mT @ (Ab - Ad) @ Q  # zero, carries the derivative
    P = Q @ (torch.diag_embed(mu ** p) + Phi * dB) @ Q.mT
    tr = (mu ** (p + 1)).sum(-1) + (p + 1) * (mu ** p * torch.diagonal(
        dB, dim1=1, dim2=2)).sum(-1)
    return (P.permute(1, 2, 0).reshape((3, 3) + batch),
            tr.reshape(batch))


@register_summand("isoogden")
@dataclass
class IsoOgden:
    """psi = 2 mu / alpha^2 (sum_i lbar_i^alpha - 3), lbar_i = lambda_i
    J^(-1/3), the principal stretches lambda_i^2 the eigenvalues mu_i of
    C~ = C + diag(1, 2, 3) 1e-10 (the reference's jitter) and J = det(C)^(1/2):
    S = 2 dpsi/dC = (2 mu / alpha) J^(-alpha/3)
        (C~^(alpha/2 - 1) - tr(C~^(alpha/2)) C^-1 / 3).
    The matrix power comes from ``spd_power``: exact to first order, so that
    the element route's forward-mode tangent is finite and accurate at
    coincident stretches (every Gauss point of the undeformed mesh, and the
    lateral stretches of uniaxial tension).  Its second derivative is not
    carried: the port refuses the summand where one is taken (EAS's
    tangent, stiffness-proportional damping)."""

    mue: float
    alpha: float = 2.0
    first_order_only = True

    def pk2_from_E(self, E):
        a = self.alpha
        A = 2.0 * E
        eye = gm.eye3l(A)
        jit = torch.as_tensor(np.diag(EIG_JITTER), dtype=E.dtype,
                              device=E.device).reshape(
            (3, 3) + (1,) * (E.dim() - 2))
        P, tr = spd_power(A + eye + jit, 0.5 * a - 1.0)
        dm1 = _detC_m1(A)
        Jfac = torch.exp((-a / 6.0) * torch.log1p(dm1))  # J^(-alpha/3)
        Cinv = gm.inv3l(A + eye, 1.0 + dm1)
        return (2.0 * self.mue / a) * Jfac * (P - (tr / 3.0) * Cinv)


@register_summand("volsussmanbathe")
@dataclass
class VolSussmanBathe:
    """psi = kappa/2 (J - 1)^2: S = kappa (J - 1) J C^-1, with
    J - 1 = expm1(log1p(det C - 1) / 2) (no cancellation)."""

    kappa: float

    def pk2_from_E(self, E):
        A = 2.0 * E
        dm1 = _detC_m1(A)
        Jm1 = torch.expm1(0.5 * torch.log1p(dm1))
        Cinv = gm.inv3l(A + gm.eye3l(A), 1.0 + dm1)
        return (self.kappa * Jm1 * (1.0 + Jm1)) * Cinv


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

    @property
    def first_order_only(self):
        """A summand's stress is exact to first order only (IsoOgden)."""
        return any(getattr(s, "first_order_only", False)
                   for s in self.summands)

    def pk2_from_E(self, E):
        S = self.summands[0].pk2_from_E(E)
        for s in self.summands[1:]:
            S = S + s.pk2_from_E(E)
        return S
