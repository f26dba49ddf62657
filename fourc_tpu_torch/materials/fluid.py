"""Fluid law: the Newtonian fluid.

Counterpart of ``NewtonianFluid`` in fourc_tpu/materials/fluid.py: a
constant dynamic viscosity and a density.  The reference's residual reads
only ``visc()`` with no argument, so its shear-rate and temperature
dependent laws (``carreauyasuda``, ``modpowerlaw``, ``herschelbulkley``,
``sutherland``, ``murnaghantait``) would act as constants there; they are
refused by name (``materials.base.UNPORTED_MATERIALS``).
"""

from __future__ import annotations

from dataclasses import dataclass

from fourc_tpu_torch.materials.base import Material, register_material


@register_material("newtonianfluid")
@dataclass
class NewtonianFluid(Material):
    kind = "fluid"
    viscosity: float  # dynamic viscosity mu
    density: float = 1.0

    def visc(self):
        return self.viscosity
