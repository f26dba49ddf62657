"""Small-strain isotropic elasticity (the GMG level operators' material).

Counterpart of fourc_tpu/materials/small_strain.py.
"""

from __future__ import annotations

from dataclasses import dataclass

from fourc_tpu_torch.materials.base import Material, register_material
from fourc_tpu_torch.ops import common as gm


@register_material("linelastic")
@dataclass
class LinearElastic(Material):
    """sigma = lambda tr(eps) I + 2 mu eps."""

    youngs: float
    nue: float
    density: float = 0.0

    def lame(self):
        lam = self.youngs * self.nue / ((1 + self.nue) * (1 - 2 * self.nue))
        mu = self.youngs / (2 * (1 + self.nue))
        return lam, mu

    def stress_small(self, eps):
        lam, mu = self.lame()
        return lam * gm.tr3l(eps) * gm.eye3l(eps) + 2.0 * mu * eps
