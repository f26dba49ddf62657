"""Finite-strain viscoelasticity around a hyperelastic law.

Counterpart of ``ViscoElastHyper`` of fourc_tpu/materials/viscoelastic.py
(the reference's viscoelasthyper: generalized-Maxwell overstress branches
on the PK2 stress, Simo's finite linear viscoelasticity with the
exponential-integrator recurrence), batched over the Gauss points in the
leading-index layout.
"""

from __future__ import annotations

import math

import torch

from fourc_tpu_torch.materials.base import (HistoryMaterial, make_material,
                                            register_material)
from fourc_tpu_torch.ops import common as gm

# Voigt order of the history's stresses: xx, yy, zz, xy, yz, xz
VOIGT = ((0, 0), (1, 1), (2, 2), (0, 1), (1, 2), (0, 2))


def voigt(S):
    """(3, 3, ...) symmetric -> (6, ...)."""
    return torch.stack([S[i, j] for i, j in VOIGT])


def unvoigt(v):
    """(6, ...) -> (3, 3, ...)."""
    return torch.stack([torch.stack([v[0], v[3], v[5]]),
                        torch.stack([v[3], v[1], v[4]]),
                        torch.stack([v[5], v[4], v[2]])])


@register_material("viscoelasthyper")
class ViscoElastHyper(HistoryMaterial):
    """S = S_eq(E) + sum_k Q_k with
    Q_k^{n+1} = e^{-dt/tau_k} Q_k^n + beta_k e^{-dt/(2 tau_k)}
    (S_eq^{n+1} - S_eq^n); history per Gauss point [Q_k (6 each),
    S_eq of the last step (6)].  ``material`` is any ported law with a PK2
    stress.  Without dt (the initial state) both factors are 1, as the
    reference's default dt = 0 gives."""

    def __init__(self, material, taus, betas, density=0.0):
        self.base = make_material(dict(material))
        if not hasattr(self.base, "pk2_from_E"):
            raise NotImplementedError(
                f"viscoelasthyper around {type(self.base).__name__} is not "
                f"ported (the base law needs a PK2 stress)")
        self.taus = [float(t) for t in (taus if isinstance(
            taus, (list, tuple)) else [taus])]
        self.betas = [float(b) for b in (betas if isinstance(
            betas, (list, tuple)) else [betas])]
        if len(self.taus) != len(self.betas):
            raise ValueError("viscoelasthyper: taus and betas differ in "
                             "length")
        self.nb = len(self.taus)
        self.history_shape = (6 * self.nb + 6,)
        self.density = float(density or getattr(self.base, "density", 0.0))
        for attr in ("youngs", "nue"):
            if hasattr(self.base, attr):
                setattr(self, attr, getattr(self.base, attr))

    def evaluate(self, C, h, dt=None):
        """C (3, 3, ...), h (6 nb + 6, ...) -> (S, h_new)."""
        Seq = self.base.pk2_from_E(0.5 * (C - gm.eye3l(C)))
        Seq_v = voigt(Seq)
        Sold_v = h[6 * self.nb:]
        S = Seq
        h_new = []
        for k, (tau, beta) in enumerate(zip(self.taus, self.betas)):
            ek = math.exp(-dt / tau) if dt else 1.0
            eh = math.exp(-dt / (2 * tau)) if dt else 1.0
            Qk = ek * h[6 * k:6 * k + 6] + beta * eh * (Seq_v - Sold_v)
            S = S + unvoigt(Qk)
            h_new.append(Qk)
        h_new.append(Seq_v)
        return S, torch.cat(h_new)
