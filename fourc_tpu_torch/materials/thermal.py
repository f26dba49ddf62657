"""Thermal laws: isotropic Fourier conduction and thermo-elastic SVK.

Counterpart of fourc_tpu/materials/thermal.py: ``fourier`` (q = -k grad T,
rho c dT/dt) and ``thermostvenantkirchhoff`` (S = C : (E - alpha (T - T0) I),
with the conduction and capacity of the thermo side of TSI).  The stress
takes leading-index batches, the temperatures one per Gauss point shaped
like the batch: E (3, 3, g, E), T (g, E).  ``scatra_stvenantkirchhoff``
belongs to scatra-structure interaction and is refused by name
(``materials.base.UNPORTED_MATERIALS``).
"""

from __future__ import annotations

from dataclasses import dataclass

from fourc_tpu_torch.materials.base import Material, register_material
from fourc_tpu_torch.materials.elastic import lame
from fourc_tpu_torch.ops import common as gm


@register_material("fourier")
@dataclass
class FourierIso(Material):
    """Isotropic heat conduction: q = -k grad T; capacity rho c."""

    kind = "thermo"
    conductivity: float
    capacity: float = 1.0
    density: float = 1.0

    def flux(self, gradT):
        return -self.conductivity * gradT


@register_material("thermostvenantkirchhoff")
@dataclass
class ThermoStVenantKirchhoff(Material):
    """SVK with a thermal eigenstrain: S = lam tr(E) I + 2 mu E
    - (3 lam + 2 mu) alpha (T - T0) I, T0 = ``inittemp``.  No kernel
    carries it: a block of it takes the element route (its hex8 mass stays
    B6's)."""

    kind = "thermo_solid"
    affine_in_strain = True
    youngs: float
    nue: float
    thexpans: float  # thermal expansion coefficient alpha
    inittemp: float = 0.0
    conductivity: float = 0.0
    capacity: float = 0.0
    density: float = 0.0

    def _lame(self):
        return lame(self.youngs, self.nue)

    def pk2_from_E(self, E, T=None):
        lam, mu = self._lame()
        eye = gm.eye3l(E)
        S = lam * gm.tr3l(E) * eye + 2.0 * mu * E
        if T is not None:
            S = S - (3.0 * lam + 2.0 * mu) * self.thexpans * (
                T - self.inittemp) * eye
        return S

    def pk2(self, C, T=None):
        """The stress at the right Cauchy-Green tensor C = 2E + I."""
        return self.pk2_from_E(0.5 * (C - gm.eye3l(C)), T)

    def flux(self, gradT):
        return -self.conductivity * gradT
