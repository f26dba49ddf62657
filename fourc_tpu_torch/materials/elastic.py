"""Hyperelastic laws on the lattice slice: St. Venant-Kirchhoff, Neo-Hooke,
and the MULF prestress wrapper around any law with a PK2 stress.

Counterpart of fourc_tpu/materials/elastic.py.  ``pk2_from_E`` takes the
Green-Lagrange strain in leading-index layout (3, 3, ...).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from fourc_tpu_torch.materials.base import (HistoryMaterial, Material,
                                            elastic_moduli, make_material,
                                            register_material)
from fourc_tpu_torch.ops import common as gm


def lame(youngs: float, nue: float):
    lam = youngs * nue / ((1 + nue) * (1 - 2 * nue))
    mu = youngs / (2 * (1 + nue))
    return lam, mu


@register_material("stvenantkirchhoff")
@dataclass
class StVenantKirchhoff(Material):
    """S = lambda tr(E) I + 2 mu E."""

    affine_in_strain = True
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


def _green_lagrange(H):
    return 0.5 * (H + H.transpose(0, 1) + gm.tmatmul3l(H, H))


@register_material("mulf")
class MulfPrestress(HistoryMaterial):
    """MULF prestressing (the modified updated Lagrangian formulation),
    held to 4C's solid elements and not to the reference.

    Each Gauss point keeps a prestretch F0 (history (9,), row-major, the
    identity before the first prestress step).  4C measures the
    displacement gradient on the last prestressed configuration, whose
    inverse Jacobian it pushes forward at every prestress update, and
    multiplies: F_tot = (I + Grad_xp u) F0 = F0 + Grad_X u, the mesh as
    given being X.  The wrapped law is evaluated at F_tot, its PK2 stress
    S(F_tot) taken as it is (its fibres in the law's own frame), and the
    element integrates P = F_tot S over the mesh as given.  A converged
    prestress step folds F0 <- F_tot (``physics.solid.update_prestress``).
    The reference instead multiplies by F0 from the right, F = (I + H) F0,
    and scales the pulled-back stress det(F0) F0 S F0^T: it misses 4C's
    converted deck by about 2x (ROADMAP C)."""

    prestress = "mulf"
    history_shape = (9,)

    def __init__(self, material, density=0.0):
        self.base = make_material(dict(material))
        self.density = float(density or getattr(self.base, "density", 0.0)
                             or 0.0)
        self.first_order_only = getattr(self.base, "first_order_only", False)

    def init_history(self, n, dtype=torch.float64, device="cpu"):
        eye = torch.eye(3, dtype=dtype, device=device).reshape(1, 9)
        return eye.expand(n, 9).clone()

    def elastic_moduli(self):
        return elastic_moduli(self.base)

    @staticmethod
    def total_gradient(H, F0):
        """F_tot - I of the displacement gradient H (3, 3, ...) on the mesh
        as given and the prestretch F0 (3, 3, ...)."""
        return H + (F0 - gm.eye3l(F0))

    def first_pk(self, H, F0):
        """P = F_tot S(F_tot), (3, 3, ...)."""
        Ht = self.total_gradient(H, F0)
        S = self.base.pk2_from_E(_green_lagrange(Ht))
        return gm.matmul3l(Ht + gm.eye3l(Ht), S)

    def first_pk_derivative(self, H, dH, F0):
        """The derivative of ``first_pk`` along dH (dF_tot = dH): the base
        law's stress by forward mode."""
        Ht = self.total_gradient(H, F0)
        F = Ht + gm.eye3l(Ht)
        dE = 0.5 * (gm.tmatmul3l(F, dH) + gm.tmatmul3l(dH, F))
        S, dS = torch.func.jvp(self.base.pk2_from_E,
                               (_green_lagrange(Ht),), (dE,))
        return gm.matmul3l(dH, S) + gm.matmul3l(F, dS)
