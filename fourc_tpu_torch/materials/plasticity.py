"""Elasto-plastic laws with Gauss-point history.

Counterpart of ``PlasticLinElast`` and ``PlasticLogFiniteStrain`` of
fourc_tpu/materials/plasticity.py (the reference's plasticlinelast and
plasticnlnlogneohooke), batched over every Gauss point in the
leading-index layout: strains (3, 3, ...), history (nh, ...).  Both return
maps are branch-free (``torch.where``; ``max0`` keeps ``jnp.maximum``'s
derivative at a tie), so that the element route's tangent is forward-mode
AD through them, as the reference takes ``jax.jvp``.

Both laws round alike on every device: a division by a constant is a
product with its reciprocal (PyTorch's CUDA kernel divides a tensor by a
host scalar so, its CPU kernel divides), a sum of a 3x3 tensor's entries
goes term by term (a reduction kernel sums in its own order), and every
square root is correctly rounded (``sqrt_rn``; the CPU's torch.sqrt is
not, for about 0.6% of float64 inputs).  A 1-ulp difference of the stress
moves a step's answer by about the tangent's condition number times it,
1e-11 and more in the plasticity decks, so the card then matches the CPU
run to the last bit instead.
"""

from __future__ import annotations

import math

import torch

from fourc_tpu_torch.materials.base import (HistoryMaterial, max0,
                                            register_material)
from fourc_tpu_torch.ops import common as gm


THIRD = 1.0 / 3.0


def _lame(youngs, nue):
    return (youngs * nue / ((1 + nue) * (1 - 2 * nue)),
            youngs / (2 * (1 + nue)))


def _norm3l(a):
    """Frobenius norm squared of a (3, 3, ...) tensor, term by term."""
    out = a[0, 0] * a[0, 0]
    for i in range(3):
        for j in range(3):
            if i or j:
                out = out + a[i, j] * a[i, j]
    return out


@register_material("plasticlinelast")
class PlasticLinElast(HistoryMaterial):
    """Small-strain J2 plasticity with linear isotropic and kinematic
    hardening, radial return; history per Gauss point [eps_p (9, row
    major), back stress (9), kappa] = 19."""

    history_shape = (19,)

    def __init__(self, youngs, nue, yield_stress, isohard=0.0, kinhard=0.0,
                 density=0.0):
        self.youngs, self.nue = float(youngs), float(nue)
        self.yield_stress = float(yield_stress)
        self.isohard, self.kinhard = float(isohard), float(kinhard)
        self.density = float(density)

    def evaluate_small(self, eps, h, dt=None):
        """eps (3, 3, ...), h (19, ...) -> (sigma, h_new)."""
        lam, mu = _lame(self.youngs, self.nue)
        batch = eps.shape[2:]
        eye = gm.eye3l(eps)
        eps_p = h[:9].reshape((3, 3) + batch)
        back = h[9:18].reshape((3, 3) + batch)
        kappa = h[18]
        eps_e = eps - eps_p
        sig_tr = lam * gm.tr3l(eps_e) * eye + 2.0 * mu * eps_e
        s_tr = sig_tr - gm.tr3l(sig_tr) * THIRD * eye
        xi = s_tr - back
        norm_xi = gm.sqrt_rn(_norm3l(xi) + 1e-30)
        q_tr = math.sqrt(1.5) * norm_xi
        f_tr = q_tr - (self.yield_stress + self.isohard * kappa)
        dgamma = max0(f_tr) * (1.0 / (3.0 * mu + self.isohard
                                      + self.kinhard))
        n = xi / norm_xi
        plastic = f_tr > 0.0
        deps_p = torch.where(plastic, math.sqrt(1.5) * dgamma, 0.0) * n
        back_new = back + torch.where(
            plastic, (2.0 / 3.0) * self.kinhard * math.sqrt(1.5) * dgamma,
            0.0) * n
        kappa_new = kappa + torch.where(plastic, dgamma, 0.0)
        sig = sig_tr - 2.0 * mu * deps_p
        h_new = torch.cat([(eps_p + deps_p).reshape((9,) + batch),
                           back_new.reshape((9,) + batch), kappa_new[None]])
        return sig, h_new


def sqrtm_db(C, iters=7):
    """Denman-Beavers square root of (3, 3, ...) SPD matrices: smooth at
    repeated eigenvalues (the reference's ``_sqrtm_db``)."""
    tr = gm.tr3l(C) * THIRD
    Y = C / tr
    Z = gm.eye3l(C).expand_as(C)
    for _ in range(iters):
        Yn = 0.5 * (Y + gm.inv3l(Z))
        Z = 0.5 * (Z + gm.inv3l(Y))
        Y = Yn
    return Y * gm.sqrt_rn(tr)


def logm_spd(C, roots=3, terms=10):
    """Matrix logarithm of (3, 3, ...) SPD matrices by inverse scaling and
    squaring: ``roots`` Denman-Beavers square roots, then ``terms`` terms of
    the series of log(I + X), times 2^roots (the reference's ``_logm_spd``;
    no eigen-decomposition, whose derivative breaks at equal stretches)."""
    A = C
    for _ in range(roots):
        A = sqrtm_db(A)
    X = A - gm.eye3l(C)
    out = torch.zeros_like(C)
    P = X
    for k in range(1, terms + 1):
        out = out + ((-1.0) ** (k + 1) / k) * P
        P = gm.matmul3l(P, X)
    return out * (2.0 ** roots)


# symmetric storage order of the log-strain law's history
_SYM = ((0, 0), (1, 1), (2, 2), (0, 1), (1, 2), (0, 2))


@register_material("plasticnlnlogneohooke")
class PlasticLogFiniteStrain(HistoryMaterial):
    """Finite-strain J2 plasticity in logarithmic strain space: Hencky
    elasticity on eps = log(C) / 2, radial return with linear isotropic
    hardening, S = (C^-1 tau + tau C^-1) / 2; history per Gauss point
    [eps_p (xx, yy, zz, xy, yz, xz), alpha] = 7."""

    history_shape = (7,)

    def __init__(self, youngs, nue, yield_stress, isohard=0.0, density=0.0):
        self.youngs, self.nue = float(youngs), float(nue)
        self.yield_stress, self.isohard = float(yield_stress), float(isohard)
        self.density = float(density)
        self.G = self.youngs / (2 * (1 + self.nue))
        self.K = self.youngs / (3 * (1 - 2 * self.nue))

    def evaluate(self, C, h, dt=None):
        """C (3, 3, ...), h (7, ...) -> (S, h_new)."""
        G, K = self.G, self.K
        eye = gm.eye3l(C)
        eps = 0.5 * logm_spd(C)
        eps_p = torch.stack([torch.stack([h[0], h[3], h[5]]),
                             torch.stack([h[3], h[1], h[4]]),
                             torch.stack([h[5], h[4], h[2]])])
        alpha = h[6]
        ee_tr = eps - eps_p
        tr_e = gm.tr3l(ee_tr)
        s_tr = 2.0 * G * (ee_tr - tr_e * THIRD * eye)
        snorm = gm.sqrt_rn(_norm3l(s_tr) + 1e-30)
        f = math.sqrt(1.5) * snorm - (self.yield_stress
                                      + self.isohard * alpha)
        dgam = max0(f) * (1.0 / (3.0 * G + self.isohard))
        ee = ee_tr - dgam * math.sqrt(1.5) * (s_tr / snorm)
        tau = K * tr_e * eye + 2.0 * G * (ee - gm.tr3l(ee) * THIRD * eye)
        Cinv = gm.inv3l(C)
        S = 0.5 * (gm.matmul3l(Cinv, tau) + gm.matmul3l(tau, Cinv))
        eps_p_new = eps - ee
        h_new = torch.stack([eps_p_new[i, j] for i, j in _SYM]
                            + [alpha + dgam])
        return S, h_new
