"""Active skeletal and cardiac muscle laws.

Counterpart of fourc_tpu/materials/muscle.py: Blemker's isochoric
skeletal muscle with a tanh activation (``muscle_blemker``) and the
Bestel-Clement-Sorine active-stress evolution (``anisoactivestress``),
batched over the Gauss points in the leading-index layout: C (3, 3, ...),
history (nh, ...).

The reference forms both stresses as 2 d psi / dC by AD of an energy in
the nine entries of C; here they are in closed form, and the element
route's tangent is the forward derivative of the closed form.  Blemker's
stress takes the symmetric gradient of I5 = |C-bar a|^2,
(C-bar a) (x) a + a (x) (C-bar a), as 4C's does: the reference's
nine-entry gradient 2 (C-bar a) (x) a is unsymmetric off the fibre's
principal axes (a fault of the reference, tools/blemker_asymmetry.py),
and this stress is its symmetric part.  The branches of the energy are
selected by the reference's own conditions (``lam <= 1``,
``lam < lam_star``, ``r <= 0.6``, ``r < 1.4``), on which its derivatives
then depend: at C = I the fibre stretch sits exactly on lam = 1, where
the passive force and its derivative are those of the region lam <= 1.
As the plasticity laws, both round alike on every device
(materials/plasticity.py).
"""

from __future__ import annotations

import math

import torch

from fourc_tpu_torch.core.functions import SymbolicExpression
from fourc_tpu_torch.materials.base import (HistoryMaterial, clip,
                                            dmaximum, dt_or_zero, maximum,
                                            outer, quad_form,
                                            register_material, unit_vector)
from fourc_tpu_torch.materials.growth import log_neohooke
from fourc_tpu_torch.ops import common as gm


def _blemker_passive_force(lam, lam_star, P1, P2):
    """The Blemker normalized passive force f_p(lam) (lambda_opt = 1), the
    derivative of the reference's antiderivative region by region:
    0 (lam <= 1), P1 (e^{P2 (lam - 1)} - 1) (1 < lam < lam*),
    P3 lam + P4 (lam >= lam*)."""
    e_star = math.exp(P2 * (lam_star - 1.0))
    P3 = P1 * P2 * e_star
    P4 = P1 * (e_star - 1.0) - P3 * lam_star
    lam2 = clip(lam, 1.0, lam_star)  # the unselected exp cannot overflow
    f2 = P1 * (gm.exp_ieee(P2 * (lam2 - 1.0)) - 1.0)
    f3 = P3 * lam + P4
    return torch.where(lam <= 1.0, 0.0, torch.where(lam < lam_star, f2, f3))


def _blemker_active_force(lam, lam_ofl):
    """The Blemker normalized active force-length f_a(r), r = lam / lam_ofl:
    9 (r - 0.4)^2 (r <= 0.6), 1 - 4 (1 - r)^2 (0.6 < r < 1.4),
    9 (r - 1.6)^2 (r >= 1.4)."""
    r = lam * (1.0 / lam_ofl)
    f1 = 9.0 * (r - 0.4) * (r - 0.4)
    f2 = 1.0 - 4.0 * (1.0 - r) * (1.0 - r)
    f3 = 9.0 * (r - 1.6) * (r - 1.6)
    return torch.where(r <= 0.6, f1, torch.where(r < 1.4, f2, f3))


def _tanh(x):
    """tanh from ``cosh_sinh_ieee``, its argument held to [-20, 20] (tanh
    rounds to +-1 in float64 beyond)."""
    c, s = gm.cosh_sinh_ieee(torch.clamp(x, -20.0, 20.0))
    return s / c


@register_material("muscle_blemker")
class IsoMuscleBlemker(HistoryMaterial):
    """Blemker active muscle (isochoric) plus an optional Neo-Hooke matrix:
    psi = G1 (I5b / I4b^2 - 1) + G2 acosh^2(H1) + W3(lam) [+ NH(C)],
    H1 = max((I1b I4b - I5b) / (2 lam), 1 + eps), lam = sqrt(I4b),
    dW3/dlam = (sigma_max f_p(lam) + sigma_max f_t(t) f_a(lam)) / lam_ofl,
    f_t = alpha tanh(beta (t - t_act_start)) from t_act_start on;
    eps 1e-6 in float32, 1e-12 in float64.  History [t], the elapsed
    time."""

    history_shape = (1,)

    def __init__(self, g1, g2, p1, p2, sigma_max, lambda_ofl, lambda_star,
                 alpha, beta, t_act_start=0.0, youngs=0.0, nue=0.3,
                 density=0.0):
        self.g1, self.g2 = float(g1), float(g2)
        self.p1, self.p2 = float(p1), float(p2)
        self.sigma_max = float(sigma_max)
        self.lambda_ofl = float(lambda_ofl)
        self.lambda_star = float(lambda_star)
        self.alpha, self.beta = float(alpha), float(beta)
        self.t_act_start = float(t_act_start)
        self.youngs, self.nue = float(youngs), float(nue)
        self.density = float(density)
        self.a = (1.0, 0.0, 0.0)  # fibre direction (reference config)

    @classmethod
    def from_deck(cls, params):
        params = dict(params)
        a = params.pop("a", (1.0, 0.0, 0.0))
        m = cls(**params)
        m.a = tuple(float(x) for x in a)
        return m

    def activation(self, t):
        """sigma_max f_t(t) of a tensor of times."""
        ft = torch.where(t >= self.t_act_start, self.alpha * _tanh(
            self.beta * (t - self.t_act_start)), 0.0)
        return self.sigma_max * ft

    def stress(self, C, sigma_max_ft):
        """2 d psi / dC at the active stress sigma_max f_t (per Gauss
        point)."""
        a = unit_vector(self.a, C)
        J2 = gm.det3l(C)
        c = torch.sign(J2) * gm.pow_ieee(torch.abs(J2), -1.0 / 3.0)
        Cb = c * C
        I1 = gm.tr3l(Cb)
        Ca = [Cb[i, 0] * a[0] + Cb[i, 1] * a[1] + Cb[i, 2] * a[2]
              for i in range(3)]
        I4 = a[0] * Ca[0] + a[1] * Ca[1] + a[2] * Ca[2]
        I5 = Ca[0] * Ca[0] + Ca[1] * Ca[1] + Ca[2] * Ca[2]
        I4m = maximum(I4, 1e-12)
        d4 = dmaximum(I4, 1e-12)
        lam = gm.sqrt_rn(I4m)
        inv_2lam = 0.5 / lam
        dlam = d4 * inv_2lam  # d lam / d I4
        # d psi / d I1, I4, I5; along-fibre shear W1 = g1 (I5 / I4m^2 - 1)
        inv_I4m2 = 1.0 / (I4m * I4m)
        psi5 = self.g1 * inv_I4m2
        psi4 = -2.0 * self.g1 * I5 * inv_I4m2 / I4m * d4
        # cross-fibre shear W2 = g2 acosh^2(H1)
        eps = 1e-6 if C.dtype == torch.float32 else 1e-12
        X = (I1 * I4 - I5) * inv_2lam
        H1 = maximum(X, 1.0 + eps)
        root = gm.sqrt_rn((H1 - 1.0) * (H1 + 1.0))
        acosh = gm.log_ieee(H1 + root)
        dW2 = dmaximum(X, 1.0 + eps) * (2.0 * self.g2 * acosh / root)  # by X
        psi1 = dW2 * I4 * inv_2lam
        psi4 = psi4 + dW2 * (I1 * inv_2lam - X * dlam / lam)
        psi5 = psi5 - dW2 * inv_2lam
        # fibre force-length W3
        dW3 = (self.sigma_max * _blemker_passive_force(
            lam, self.lambda_star, self.p1, self.p2)
               + sigma_max_ft * _blemker_active_force(lam, self.lambda_ofl)
               ) * (1.0 / self.lambda_ofl)
        psi4 = psi4 + dW3 * dlam
        # d psi / d C-bar, symmetric:
        # psi1 I + psi4 a (x) a + psi5 ((C-bar a) (x) a + a (x) (C-bar a))
        Ca_t = torch.stack(torch.broadcast_tensors(*Ca))
        P = psi1 * gm.eye3l(C) + psi4 * outer(a, a) + psi5 * (
            outer(Ca_t, a) + outer(a, Ca_t))
        CinvT = gm.inv3l(C, J2).transpose(0, 1)
        PC = None
        for i in range(3):
            for j in range(3):
                term = P[i, j] * C[i, j]
                PC = term if PC is None else PC + term
        S = (2.0 * c) * (P - (1.0 / 3.0) * PC * CinvT)
        if self.youngs:
            S = S + log_neohooke(C, self.youngs, self.nue)
        return S

    def evaluate(self, C, h, dt=None):
        t = h[0] + dt_or_zero(dt)
        return self.stress(C, self.activation(t)), t[None]


@register_material("anisoactivestress")
class AnisoActiveStress(HistoryMaterial):
    """Active-stress evolution along a fibre (Bestel-Clement-Sorine):
    backward Euler of tau' = n0 sigma0 max(u, 0) - tau |u|, S = S_NH(C) +
    tau f0 (x) f0, u(t) the deck's expression of t, n0 the Frank-Starling
    window clip(-(lam - lam_lower)(lam - lam_upper) 4 / (lam_lower -
    lam_upper)^2, 0, 1) when lambda_upper > lambda_lower, else 1.
    History [tau, t], [tau0, 0] before the first step."""

    history_shape = (2,)

    def __init__(self, youngs, nue, sigma0, u_expr="1", tau0=0.0,
                 lambda_lower=0.0, lambda_upper=0.0, density=0.0):
        self.youngs, self.nue = float(youngs), float(nue)
        self.sigma0 = float(sigma0)
        self.tau0 = float(tau0)
        self.lambda_lower = float(lambda_lower)
        self.lambda_upper = float(lambda_upper)
        self.density = float(density)
        self.u_fn = SymbolicExpression(str(u_expr))
        self.f0 = (1.0, 0.0, 0.0)

    @classmethod
    def from_deck(cls, params):
        params = dict(params)
        f0 = params.pop("f0", (1.0, 0.0, 0.0))
        m = cls(**params)
        m.f0 = tuple(float(x) for x in f0)
        return m

    def init_history(self, n, dtype=torch.float64, device="cpu"):
        h = torch.zeros((n, 2), dtype=dtype, device=device)
        h[:, 0] = self.tau0
        return h

    def evaluate(self, C, h, dt=None):
        dt = dt_or_zero(dt)
        tau_n, t_n = h[0], h[1]
        t = t_n + dt
        u = self.u_fn.on_device(t)
        f0 = unit_vector(self.f0, C)
        if self.lambda_upper > self.lambda_lower:
            lam = gm.sqrt_rn(maximum(quad_form(f0, C), 1e-12))
            scale = 4.0 / (self.lambda_lower - self.lambda_upper) ** 2
            n0 = clip(-(lam - self.lambda_lower) * (lam - self.lambda_upper)
                      * scale, 0.0, 1.0)
        else:
            n0 = 1.0
        tau = (tau_n + dt * n0 * self.sigma0 * maximum(u, 0.0)) / (
            1.0 + dt * torch.abs(u))
        S = log_neohooke(C, self.youngs, self.nue) + tau * outer(f0, f0)
        return S, torch.stack([tau, t])
