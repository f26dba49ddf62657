"""Hyperelastic laws on the lattice slice: St. Venant-Kirchhoff, Neo-Hooke.

Counterpart of fourc_tpu/materials/elastic.py.  ``pk2_from_E`` takes the
Green-Lagrange strain in leading-index layout (3, 3, ...).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from fourc_tpu_torch.materials.base import Material, register_material
from fourc_tpu_torch.ops import common as gm


def lame(youngs: float, nue: float):
    lam = youngs * nue / ((1 + nue) * (1 - 2 * nue))
    mu = youngs / (2 * (1 + nue))
    return lam, mu


@register_material("stvenantkirchhoff")
@dataclass
class StVenantKirchhoff(Material):
    """S = lambda tr(E) I + 2 mu E."""

    youngs: float
    nue: float
    density: float = 0.0

    def pk2_from_E(self, E):
        lam, mu = lame(self.youngs, self.nue)
        return lam * gm.tr3l(E) * gm.eye3l(E) + 2.0 * mu * E


@register_material("neohooke")
@dataclass
class NeoHooke(Material):
    """Compressible Neo-Hooke, psi = mu/2 (I1 - 3) - mu lnJ + lam/2 lnJ^2."""

    youngs: float
    nue: float
    density: float = 0.0

    def pk2_from_E(self, E):
        """Cancellation-free form: with A = 2E = C - I,
        S = C^-1 (mu A + lam lnJ I), lnJ = log1p(det C - 1)/2 and
        det C - 1 = tr A + (tr(A)^2 - tr(A^2))/2 + det A exactly."""
        lam, mu = lame(self.youngs, self.nue)
        A = 2.0 * E
        eye = gm.eye3l(A)
        trA = gm.tr3l(A)
        trA2 = gm.tr3l(gm.matmul3l(A, A))
        detC_m1 = trA + 0.5 * (trA * trA - trA2) + gm.det3l(A)
        lnJ = 0.5 * torch.log1p(detC_m1)
        Cinv = gm.inv3l(A + eye, 1.0 + detC_m1)
        return gm.matmul3l(Cinv, mu * A + lam * lnJ * eye)
