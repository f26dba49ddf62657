"""Scalar-transport law: linear diffusion with an optional linear reaction.

Counterpart of ``ScatraMat`` in fourc_tpu/materials/scatra.py
(``d phi/dt + u . grad phi = div(D grad phi) - reacoeff phi``, the storage
scaled by ``capacity``), with a scalar diffusivity or principal values
rotated by ``diff_angle`` in the xy-plane.  The multi-species laws
(``matlist``, ``matlist_reactions``, ``scatra_reaction``) and those of
electrochemistry and Soret transport are refused by name
(``materials.base.UNPORTED_MATERIALS``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from fourc_tpu_torch.materials.base import Material, register_material


@register_material("scatra")
@dataclass
class ScatraMat(Material):
    kind = "scatra"
    diffusivity: object
    reacoeff: float = 0.0
    density: float = 1.0
    capacity: float = 1.0
    diff_angle: float = 0.0

    def diff(self):
        """The diffusivity: a number, or the (d, d) tensor (numpy) of
        principal values rotated by ``diff_angle`` about z."""
        if isinstance(self.diffusivity, (list, tuple)):
            d = [float(v) for v in self.diffusivity]
            D = np.diag(d)
            if self.diff_angle:
                c, s = np.cos(self.diff_angle), np.sin(self.diff_angle)
                R = np.eye(len(d))
                R[0, 0], R[0, 1], R[1, 0], R[1, 1] = c, -s, s, c
                D = R @ D @ R.T
            return D
        return float(self.diffusivity)

    def reaction(self, phi):
        return self.reacoeff * phi
