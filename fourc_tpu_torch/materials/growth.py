"""Biological laws: a mixture of history-free laws, isotropic volumetric
growth, homogenized constrained-mixture growth and remodelling, and a
ramped active fibre stress.

Counterpart of fourc_tpu/materials/growth.py, batched over the Gauss
points in the leading-index layout: C (3, 3, ...), history (nh, ...).
The reference takes a fibre's stress derivative in its remodelling
Newton loop with ``jax.grad``; here it is in closed form, with
``jnp.maximum``'s derivative of 1/2 at a tie.  As the plasticity laws,
every law is branch-free (``torch.where`` and the tie helpers of
materials/base.py), divides by a constant as a product with its
reciprocal, and takes exp, log, powers and square roots from
ops/common.py's ``*_ieee`` and ``sqrt_rn``: the card rounds as the CPU.
"""

from __future__ import annotations

import math

import torch

from fourc_tpu_torch.materials.base import (HistoryMaterial, Material, clip,
                                            dmaximum, dt_or_zero,
                                            make_material, maximum, minimum,
                                            outer, quad_form,
                                            register_material, unit_vector)
from fourc_tpu_torch.materials.elastic import NeoHooke
from fourc_tpu_torch.ops import common as gm


def history_free(m, where):
    """Raise as the reference does when a constituent carries history."""
    if getattr(m, "history_shape", ()):
        raise ValueError(f"{where} must be history-free materials "
                         f"({type(m).__name__} carries GP history)")
    if not hasattr(m, "pk2_from_E"):
        raise NotImplementedError(f"{where}: material {type(m).__name__} "
                                  f"(no PK2 stress) is not ported")
    return m


def trace_of_product(A, B):
    """tr(A B) of two (3, 3, ...) tensors, term by term."""
    out = None
    for i in range(3):
        term = A[i, 0] * B[0, i] + A[i, 1] * B[1, i] + A[i, 2] * B[2, i]
        out = term if out is None else out + term
    return out


def log_neohooke(C, youngs, nue):
    """2 d psi / dC of psi = mu/2 (tr C - 3) - mu ln J + lam/2 ln^2 J,
    ln J = log(max(det C, 1e-12)) / 2: mu (I - C^-1) + lam ln J C^-1, the
    reference's AD of its energy (C^-1 by the adjugate)."""
    lam = youngs * nue / ((1.0 + nue) * (1.0 - 2.0 * nue))
    mu = youngs / (2.0 * (1.0 + nue))
    J2 = gm.det3l(C)
    Cinv = gm.inv3l(C, J2)
    lnJ = 0.5 * gm.log_ieee(maximum(J2, 1e-12))
    return mu * (gm.eye3l(C) - Cinv) + lam * lnJ * Cinv


@register_material("mixture")
class Mixture(Material):
    """Mass-fraction mixture of history-free constituents: S = sum_i
    frac_i S_i(E).  Deck: {type: mixture, constituents: [{frac: ..,
    material: {...}}, ...]}."""

    def __init__(self, constituents, density=0.0):
        self.parts = []
        for c in constituents:
            m = history_free(make_material(dict(c["material"])),
                             "mixture constituents")
            self.parts.append((float(c["frac"]), m))
        self.density = density or sum(
            fr * float(getattr(m, "density", 0.0) or 0.0)
            for fr, m in self.parts)

    def pk2_from_E(self, E):
        S = None
        for fr, m in self.parts:
            Si = fr * m.pk2_from_E(E)
            S = Si if S is None else S + Si
        return S


@register_material("growth_iso")
class IsotropicGrowth(HistoryMaterial):
    """Stress-driven isotropic growth around a Neo-Hooke core: F_g =
    theta^(1/3) I, S = theta^(1/3) S_e(C_e), C_e = theta^(-2/3) C, and
    theta_new = clip(theta + dt k_growth (tr(C_e S_e) - m_target),
    theta_min, theta_max); history [theta], 1 before the first step."""

    history_shape = (1,)

    def __init__(self, youngs, nue, k_growth=0.0, m_target=0.0,
                 theta_min=0.5, theta_max=3.0, density=0.0):
        self.elastic = NeoHooke(float(youngs), float(nue))
        self.k_growth = float(k_growth)
        self.m_target = float(m_target)
        self.theta_min = float(theta_min)
        self.theta_max = float(theta_max)
        self.density = float(density)

    def init_history(self, n, dtype=torch.float64, device="cpu"):
        return torch.ones((n, 1), dtype=dtype, device=device)

    def evaluate(self, C, h, dt=None):
        dt = dt_or_zero(dt)
        theta = clip(h[0], self.theta_min, self.theta_max)
        Ce = gm.pow_ieee(theta, -2.0 / 3.0) * C
        Se = self.elastic.pk2_from_E(0.5 * (Ce - gm.eye3l(C)))
        S = gm.pow_ieee(theta, 1.0 / 3.0) * Se
        trM = trace_of_product(Ce, Se)
        theta_new = clip(theta + dt * self.k_growth * (trM - self.m_target),
                         self.theta_min, self.theta_max)
        return S, theta_new[None]


# the clamps of the remodelling stretch lam_r, on z = ln lam_r
_LOG_LR_MIN, _LOG_LR_MAX = math.log(0.2), math.log(5.0)


@register_material("growthremodel_cm")
class GrowthRemodelCM(HistoryMaterial):
    """Homogenized constrained-mixture growth and remodelling: a
    compressible Neo-Hooke elastin (its mass fraction phi_elastin) and two
    collagen fibre families, psi_f = kf/4 (lam_e^2 - 1)^2 in tension,
    lam_e = lam G / lam_r.  Each step updates lam_r by backward Euler of
    dlam_r / lam_r = k_remodel (sigma / sigma_h - 1) dt (8 Newton
    iterations in z = ln lam_r, z clamped to [ln 0.2, ln 5]) and then the
    mass rho by rho (1 + dt k_sigma clip(sigma / sigma_h - 1, -2, 2)),
    clipped to [1e-4, 10]; the stress is taken at the updated state, so its
    tangent is not symmetric.  History [rho_1, lam_r_1, rho_2, lam_r_2]."""

    history_shape = (4,)

    def __init__(self, youngs_elastin, nue, k_fiber, sigma_h,
                 k_sigma=1.0, k_remodel=1.0, prestretch=1.1,
                 a1=(1.0, 0.0, 0.0), a2=(0.0, 1.0, 0.0),
                 rho0=0.3, phi_elastin=0.4, density=0.0):
        self.Ee = float(youngs_elastin)
        self.nue = float(nue)
        self.kf = float(k_fiber)
        self.sh = float(sigma_h)
        self.ks = float(k_sigma)
        self.kr = float(k_remodel)
        self.G = float(prestretch)
        self.a1 = tuple(float(x) for x in a1)
        self.a2 = tuple(float(x) for x in a2)
        self.rho0 = float(rho0)
        self.phi_e = float(phi_elastin)
        self.density = float(density)

    def elastic_moduli(self):
        """The elastin's (youngs, nue), for SA-AMG's operator."""
        return self.Ee, self.nue

    def init_history(self, n, dtype=torch.float64, device="cpu"):
        h0 = torch.tensor([self.rho0, 1.0, self.rho0, 1.0], dtype=dtype,
                          device=device)
        return h0.repeat(n, 1)

    def _stretch2(self, I4, lam_r):
        """lam_e^2 of the fibre of invariant a . C a at lam_r."""
        lam = gm.sqrt_rn(maximum(I4, 1e-12))
        lam_e = lam * self.G / lam_r
        return lam_e * lam_e

    def _evolve(self, I4, rho, lr, dt):
        """(rho_new, lam_r_new) of one fibre family."""
        inv_sh = 1.0 / self.sh
        z_n = gm.log_ieee(lr)
        z = z_n
        for _ in range(8):
            q = self._stretch2(I4, gm.exp_ieee(z))
            x = maximum(q - 1.0, 0.0)
            sig = q * self.kf * x
            g = z - z_n - dt * self.kr * (sig * inv_sh - 1.0)
            # d sig / dz: d q / dz = -2 q, and jnp.maximum's derivative
            dsig = -2.0 * q * (self.kf * x + q * self.kf * dmaximum(
                q - 1.0, 0.0))
            dg = 1.0 - dt * self.kr * dsig * inv_sh
            z = z - g / torch.where(torch.abs(dg) < 1e-12, 1e-12, dg)
            z = clip(z, _LOG_LR_MIN, _LOG_LR_MAX)
        lr_n = gm.exp_ieee(z)
        q = self._stretch2(I4, lr_n)
        sig_n = q * self.kf * maximum(q - 1.0, 0.0)
        dev = clip(sig_n * inv_sh - 1.0, -2.0, 2.0)
        rho_n = clip(rho * (1.0 + dt * self.ks * dev), 1e-4, 10.0)
        return rho_n, lr_n

    def _fiber_stress(self, I4, a, rho, lam_r):
        """2 rho d psi_f / d lam_e^2 (G / lam_r)^2 a (x) a."""
        x = maximum(self._stretch2(I4, lam_r) - 1.0, 0.0)
        r = self.G / lam_r
        return (2.0 * rho * (0.5 * self.kf * x) * (r * r)) * outer(a, a)

    def evaluate(self, C, h, dt=None):
        dt = dt_or_zero(dt)
        S = self.phi_e * log_neohooke(C, self.Ee, self.nue)
        rows = []
        for k, direction in enumerate((self.a1, self.a2)):
            a = unit_vector(direction, C)
            I4 = quad_form(a, C)
            rho_n, lr_n = self._evolve(I4, h[2 * k], h[2 * k + 1], dt)
            S = S + self._fiber_stress(I4, a, rho_n, lr_n)
            rows += [rho_n, lr_n]
        return S, torch.stack(rows)


@register_material("muscle_active")
class MuscleActiveStrain(HistoryMaterial):
    """Neo-Hooke passive stress plus the active fibre stress
    smax min(t / tau, 1) m (x) m; history [t], the elapsed time."""

    history_shape = (1,)

    def __init__(self, youngs, nue, smax, tau=1.0, fiber=(1.0, 0.0, 0.0),
                 density=0.0):
        self.elastic = NeoHooke(float(youngs), float(nue))
        self.smax = float(smax)
        self.tau = float(tau)
        self.fiber = tuple(float(x) for x in fiber)
        self.density = float(density)

    def evaluate(self, C, h, dt=None):
        t = h[0] + dt_or_zero(dt)
        Sp = self.elastic.pk2_from_E(0.5 * (C - gm.eye3l(C)))
        m = unit_vector(self.fiber, C)
        act = self.smax * minimum(t * (1.0 / self.tau), 1.0)
        return Sp + act * outer(m, m), t[None]
