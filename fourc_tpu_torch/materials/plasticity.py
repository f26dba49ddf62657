"""Elasto-plastic laws with Gauss-point history.

Counterpart of fourc_tpu/materials/plasticity.py: small-strain J2
(plasticlinelast), Perzyna viscoplasticity, Drucker-Prager, Lemaitre
damage, Gurson-Tvergaard-Needleman, superelastic SMA, Robinson's
viscoplasticity and thermoplastic J2 under linear kinematics (the last two
take per-Gauss-point temperatures under TSI, ``needs_temp``); log-strain J2
(plasticnlnlogneohooke) and crystal plasticity under nonlinear kinematics.
Each is batched over every Gauss point in the leading-index layout:
strains (3, 3, ...), history (nh, ...), the reference's history layout.
Every return map is branch-free (``torch.where``; ``maximum``,
``minimum``, ``clip`` and ``abs1`` keep the derivatives of ``jnp.maximum``,
``jnp.minimum``, ``jnp.clip`` and ``jnp.abs`` at a tie), so that the
element route's tangent is forward-mode AD through it, as the reference
takes ``jax.jvp``.

Every law rounds alike on every device: a division by a constant is a
product with its reciprocal (PyTorch's CUDA kernel divides a tensor by a
host scalar so, its CPU kernel divides), a sum over tensor entries or slip
systems goes term by term (a reduction kernel sums in its own order),
every square root is correctly rounded (``sqrt_rn``; the CPU's torch.sqrt
is not, for about 0.6% of float64 inputs), and exp, cosh, sinh and powers
are built from additions and products (``ops/common.py`` ``*_ieee``).  A
1-ulp difference of the stress moves a step's answer by about the
tangent's condition number times it, 1e-11 and more in the plasticity
decks, so the card then matches the CPU run to the last bit instead.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fourc_tpu_torch.materials.base import (HistoryMaterial, abs1, clip,
                                            maximum, minimum,
                                            register_material)
from fourc_tpu_torch.ops import common as gm


THIRD = 1.0 / 3.0
SQ15 = math.sqrt(1.5)


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
        dgamma = maximum(f_tr, 0.0) * (1.0 / (3.0 * mu + self.isohard
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


def _dot3l(a, b):
    """sum_ij a_ij b_ij of two (3, 3, ...) tensors, term by term."""
    out = a[0, 0] * b[0, 0]
    for i in range(3):
        for j in range(3):
            if i or j:
                out = out + a[i, j] * b[i, j]
    return out


def _mat(h, start, batch):
    """Entries start..start+8 of a history (nh, ...) as (3, 3, ...)."""
    return h[start:start + 9].reshape((3, 3) + batch)


def _flat(a, batch):
    return a.reshape((9,) + batch)


def _dt(dt):
    """The reference's default where the element route passes no dt (the
    initial state): 1."""
    return 1.0 if dt is None else float(dt)


@register_material("viscoplastic_perzyna")
class ViscoPlasticPerzyna(HistoryMaterial):
    """Small-strain Perzyna viscoplasticity (rate-dependent J2):
    dgamma = dt / eta <(q - sigma_y) / sigma_y>^m, capped at full
    relaxation; history as plasticlinelast's [eps_p (9), back stress (9,
    unchanged), kappa] = 19."""

    history_shape = (19,)

    def __init__(self, youngs, nue, yield_stress, eta=1.0, m_exp=1.0,
                 isohard=0.0, density=0.0):
        self.youngs, self.nue = float(youngs), float(nue)
        self.yield_stress, self.eta = float(yield_stress), float(eta)
        self.m_exp, self.isohard = float(m_exp), float(isohard)
        self.density = float(density)

    def evaluate_small(self, eps, h, dt=None):
        """eps (3, 3, ...), h (19, ...) -> (sigma, h_new)."""
        lam, mu = _lame(self.youngs, self.nue)
        batch = eps.shape[2:]
        eye = gm.eye3l(eps)
        eps_p, kappa = _mat(h, 0, batch), h[18]
        eps_e = eps - eps_p
        sig_tr = lam * gm.tr3l(eps_e) * eye + 2.0 * mu * eps_e
        s_tr = sig_tr - gm.tr3l(sig_tr) * THIRD * eye
        norm_s = gm.sqrt_rn(_norm3l(s_tr) + 1e-30)
        q_tr = SQ15 * norm_s
        sig_y = self.yield_stress + self.isohard * kappa
        over = maximum(q_tr - sig_y, 0.0) / sig_y
        dgamma = _dt(dt) / self.eta * gm.pow_ieee(over, self.m_exp)
        dgamma = minimum(dgamma, q_tr * (1.0 / (3.0 * mu)))
        deps_p = SQ15 * dgamma * (s_tr / norm_s)
        sig = sig_tr - 2.0 * mu * deps_p
        h_new = torch.cat([_flat(eps_p + deps_p, batch), h[9:18],
                           (kappa + dgamma)[None]])
        return sig, h_new


@register_material("plasticdruckerprager")
class PlasticDruckerPrager(HistoryMaterial):
    """Small-strain Drucker-Prager plasticity, f = sqrt(J2) + eta p -
    xi c(kappa), flow potential sqrt(J2) + etabar p (etabar = eta:
    associative), linear cohesion hardening c = c0 + H kappa; the return to
    the cone, or to the apex where the cone's return would cross
    sqrt(J2) < 0.  History [eps_p (9), kappa] = 10."""

    history_shape = (10,)

    def __init__(self, youngs, nue, cohesion, eta=0.5, etabar=None, xi=1.0,
                 isohard=0.0, density=0.0):
        self.youngs, self.nue = float(youngs), float(nue)
        self.cohesion, self.eta = float(cohesion), float(eta)
        self.etabar = None if etabar is None else float(etabar)
        self.xi, self.isohard = float(xi), float(isohard)
        self.density = float(density)

    def evaluate_small(self, eps, h, dt=None):
        """eps (3, 3, ...), h (10, ...) -> (sigma, h_new)."""
        lam, G = _lame(self.youngs, self.nue)
        K = lam + 2.0 * G / 3.0
        eta = self.eta
        etab = self.eta if self.etabar is None else self.etabar
        xi, H = self.xi, self.isohard
        batch = eps.shape[2:]
        eye = gm.eye3l(eps)
        eps_p, kappa = _mat(h, 0, batch), h[9]
        eps_e = eps - eps_p
        sig_tr = lam * gm.tr3l(eps_e) * eye + 2.0 * G * eps_e
        p_tr = gm.tr3l(sig_tr) * THIRD
        s_tr = sig_tr - p_tr * eye
        # the reference's double-where guard of the square root at s = 0
        ss = 0.5 * _norm3l(s_tr)
        nz = ss > 1e-24
        sqj2_tr = torch.where(nz, gm.sqrt_rn(torch.where(nz, ss, 1.0)), 0.0)
        sqj2_safe = torch.where(nz, sqj2_tr, 1.0)
        c_n = self.cohesion + H * kappa
        f_tr = sqj2_tr + eta * p_tr - xi * c_n
        # the cone's return
        dgam = maximum(f_tr, 0.0) * (1.0 / (G + K * eta * etab + xi ** 2 * H))
        sqj2_c = sqj2_tr - G * dgam
        plastic = f_tr > 0.0
        apex = plastic & (sqj2_c < 0.0)
        # the apex's: s = 0, eta (p_tr - K x) = xi c(kappa + xi / etab x)
        etab_safe = max(etab, 1e-30)
        x_apex = maximum((eta * p_tr - xi * c_n)
                         * (1.0 / (eta * K + xi ** 2 * H / etab_safe)), 0.0)
        scale_s = torch.where(apex, 0.0, torch.where(
            plastic, sqj2_c / sqj2_safe, 1.0))
        p_new = torch.where(apex, p_tr - K * x_apex, torch.where(
            plastic, p_tr - K * etab * dgam, p_tr))
        dk = torch.where(apex, xi / etab_safe * x_apex,
                         torch.where(plastic, xi * dgam, 0.0))
        sig = s_tr * scale_s + p_new * eye
        # the plastic strain from the elastic relation
        eps_e_new = ((sig - p_new * eye) * (1.0 / (2.0 * G))
                     + p_new * (1.0 / (3.0 * K)) * eye)
        return sig, torch.cat([_flat(eps - eps_e_new, batch),
                               (kappa + dk)[None]])


@register_material("plasticlemaitre")
class PlasticLemaitre(HistoryMaterial):
    """Small-strain J2 plasticity coupled to Lemaitre's isotropic ductile
    damage: the radial return in effective stress, then
    dD = (Y / S0)^s (dgamma / (1 - D)), Y the elastic energy release rate,
    D capped at d_crit; sigma = (1 - D) sigma_eff.  History [eps_p (9),
    kappa, D] = 11."""

    history_shape = (11,)

    def __init__(self, youngs, nue, yield_stress, isohard=0.0, s0=1.0,
                 s_exp=1.0, d_crit=0.99, density=0.0):
        self.youngs, self.nue = float(youngs), float(nue)
        self.yield_stress, self.isohard = float(yield_stress), float(isohard)
        self.s0, self.s_exp = float(s0), float(s_exp)
        self.d_crit, self.density = float(d_crit), float(density)

    def evaluate_small(self, eps, h, dt=None):
        """eps (3, 3, ...), h (11, ...) -> (sigma, h_new)."""
        lam, G = _lame(self.youngs, self.nue)
        batch = eps.shape[2:]
        eye = gm.eye3l(eps)
        eps_p, kappa, D = _mat(h, 0, batch), h[9], h[10]
        omd = maximum(1.0 - D, 1.0 - self.d_crit)
        eps_e = eps - eps_p
        sig_eff_tr = lam * gm.tr3l(eps_e) * eye + 2.0 * G * eps_e
        s_tr = sig_eff_tr - gm.tr3l(sig_eff_tr) * THIRD * eye
        ss = _norm3l(s_tr)
        nz = ss > 1e-24
        norm_s = torch.where(nz, gm.sqrt_rn(torch.where(nz, ss, 1.0)), 1e-15)
        f_tr = SQ15 * norm_s - (self.yield_stress + self.isohard * kappa)
        dgam = maximum(f_tr, 0.0) * (1.0 / (3.0 * G + self.isohard))
        deps_p = SQ15 * dgam * (s_tr / norm_s)
        sig_eff = sig_eff_tr - 2.0 * G * deps_p
        # the energy release rate sig_eff : eps_e_new / 2, effective
        Y = 0.5 * _dot3l(sig_eff, eps_e - deps_p)
        dD = gm.pow_ieee(maximum(Y, 0.0) * (1.0 / self.s0),
                         self.s_exp) * dgam / omd
        D_new = minimum(D + dD, self.d_crit)
        return (1.0 - D_new) * sig_eff, torch.cat([
            _flat(eps_p + deps_p, batch), (kappa + dgam)[None], D_new[None]])


@register_material("plasticgtn")
class PlasticGTN(HistoryMaterial):
    """Gurson-Tvergaard-Needleman porous plasticity (small strain):
    Phi = (q / sy)^2 + 2 q1 f* cosh(3 q2 p / (2 sy)) - 1 - q3 f*^2, the
    deviatoric and volumetric plastic increments from 8 unrolled Newton
    iterations with clamped iterates, the void fraction's growth and
    strain-controlled (Chu-Needleman) nucleation, Tvergaard-Needleman
    coalescence f*; f starts at f0 where the history holds 0.  History
    [eps_p (9), ebar, f] = 11."""

    history_shape = (11,)

    def __init__(self, youngs, nue, yield_stress, isohard=0.0, q1=1.5,
                 q2=1.0, q3=2.25, f0=0.0, fn=0.0, en=0.3, sn=0.1, fc=0.15,
                 ff=0.25, density=0.0):
        self.youngs, self.nue = float(youngs), float(nue)
        self.yield_stress, self.isohard = float(yield_stress), float(isohard)
        self.q1, self.q2, self.q3 = float(q1), float(q2), float(q3)
        self.f0, self.fn, self.en, self.sn = (float(f0), float(fn),
                                              float(en), float(sn))
        self.fc, self.ff, self.density = float(fc), float(ff), float(density)

    def _fstar(self, f):
        k = (1.0 / self.q1 - self.fc) / max(self.ff - self.fc, 1e-12)
        return torch.where(f > self.fc, self.fc + k * (f - self.fc), f)

    def _phi(self, q, y, fs, ch):
        """The yield function, ch = cosh of its argument."""
        qy = q / y
        return (qy * qy + 2.0 * self.q1 * fs * ch - 1.0
                - self.q3 * (fs * fs))

    def _arg(self, p, y):
        return clip(1.5 * self.q2 * p / y, -50.0, 50.0)

    def evaluate_small(self, eps, h, dt=None):
        """eps (3, 3, ...), h (11, ...) -> (sigma, h_new)."""
        lam, G = _lame(self.youngs, self.nue)
        K = lam + 2.0 * G / 3.0
        q1, q2 = self.q1, self.q2
        batch = eps.shape[2:]
        eye = gm.eye3l(eps)
        eps_p, ebar = _mat(h, 0, batch), h[9]
        f = torch.where(h[10] == 0.0, self.f0, h[10])  # the lazy f0 seed
        eps_e = eps - eps_p
        sig_tr = lam * gm.tr3l(eps_e) * eye + 2.0 * G * eps_e
        p_tr = gm.tr3l(sig_tr) * THIRD
        s_tr = sig_tr - p_tr * eye
        s2 = _norm3l(s_tr)
        ss = 1.5 * s2
        nzq = ss > 1e-24
        q_tr = torch.where(nzq, gm.sqrt_rn(torch.where(nzq, ss, 1.0)), 1e-15)
        fs = self._fstar(f)
        y_tr = self.yield_stress + self.isohard * ebar
        ch_tr, _ = gm.cosh_sinh_ieee(self._arg(p_tr, y_tr))
        yielding = self._phi(q_tr, y_tr, fs, ch_tr) > 0.0
        # unknowns deq (deviatoric) and dep (volumetric); the loop runs at
        # every Gauss point, so its iterates stay clamped
        deq_cap = q_tr * (1.0 / (3.0 * G))
        dep_cap = (abs1(p_tr) + self.yield_stress) * (1.0 / K)
        deq = torch.zeros_like(q_tr)
        dep = torch.zeros_like(q_tr)
        for _ in range(8):
            q = q_tr - 3.0 * G * deq
            p = p_tr - K * dep
            y = self.yield_stress + self.isohard * (ebar + deq)
            ch, sh = gm.cosh_sinh_ieee(self._arg(p, y))
            y2 = y * y
            dphi_dq = 2.0 * q / y2
            dphi_dp = 3.0 * q1 * q2 * fs / y * sh
            r1 = self._phi(q, y, fs, ch)
            r2 = dep * dphi_dq - deq * dphi_dp
            # the reference's 2x2 Jacobian (the hardening term dropped)
            a11 = -3.0 * G * dphi_dq
            a12 = -K * dphi_dp
            a21 = -dphi_dp + dep * (-3.0 * G) * 2.0 / y2
            a22 = (dphi_dq + deq * K * 3.0 * q1 * q2 * fs / y * ch * 1.5
                   * q2 / y)
            det = a11 * a22 - a12 * a21
            det = torch.where(torch.abs(det) < 1e-20, -1e-20, det)
            ddeq = (-r1 * a22 + r2 * a12) / det
            ddep = (-a11 * r2 + a21 * r1) / det
            deq = clip(deq + ddeq, 0.0, deq_cap)
            dep = clip(dep + ddep, -dep_cap, dep_cap)
        deq = torch.where(yielding, deq, 0.0)
        dep = torch.where(yielding, dep, 0.0)
        nhat = s_tr / torch.where(nzq, gm.sqrt_rn(torch.where(nzq, s2, 1.0)),
                                  1.0)
        deps_p = SQ15 * deq * nhat + dep * THIRD * eye
        sig = sig_tr - (2.0 * G * SQ15 * deq * nhat + K * dep * eye)
        # void growth and Chu-Needleman nucleation
        ebar_new = ebar + deq
        z = (ebar_new - self.en) * (1.0 / self.sn)
        A = (self.fn / (self.sn * math.sqrt(2.0 * math.pi))
             * gm.exp_ieee(-0.5 * (z * z)))
        f_new = clip(f + (1.0 - f) * dep + A * deq, 0.0, 0.999 / q1)
        return sig, torch.cat([_flat(eps_p + deps_p, batch), ebar_new[None],
                               f_new[None]])


@register_material("superelastic_sma")
class SuperelasticSMA(HistoryMaterial):
    """Small-strain superelastic shape-memory alloy (Auricchio-Taylor
    flag-shaped hysteresis): the martensite fraction xi in [0, 1] grows
    where q > s_as_s + h_as xi (forward) and shrinks where
    q < s_sa_f + h_sa xi (reverse), h_as = s_as_f - s_as_s,
    h_sa = s_sa_s - s_sa_f; transformation strain sqrt(3/2) eps_l xi n.
    History [eps_t (9), xi] = 10."""

    history_shape = (10,)

    def __init__(self, youngs, nue, eps_l, s_as_s, s_as_f, s_sa_s, s_sa_f,
                 density=0.0):
        self.youngs, self.nue = float(youngs), float(nue)
        self.eps_l = float(eps_l)
        self.s_as_s, self.s_as_f = float(s_as_s), float(s_as_f)
        self.s_sa_s, self.s_sa_f = float(s_sa_s), float(s_sa_f)
        self.density = float(density)
        self.G = self.youngs / (2 * (1 + self.nue))
        self.K = self.youngs / (3 * (1 - 2 * self.nue))

    def evaluate_small(self, eps, h, dt=None):
        """eps (3, 3, ...), h (10, ...) -> (sigma, h_new)."""
        G = self.G
        batch = eps.shape[2:]
        eye = gm.eye3l(eps)
        eps_t, xi = _mat(h, 0, batch), h[9]
        ee = eps - eps_t
        tr_e = gm.tr3l(ee)
        s_tr = 2.0 * G * (ee - tr_e * THIRD * eye)
        snorm = gm.sqrt_rn(_norm3l(s_tr) + 1e-30)
        q_tr = SQ15 * snorm
        nhat = s_tr / snorm
        c = 3.0 * G * self.eps_l  # the stress drop per unit dxi
        h_as = self.s_as_f - self.s_as_s
        h_sa = self.s_sa_s - self.s_sa_f
        # forward: q down onto the loading plateau; reverse: up onto the
        # unloading one
        f_as = q_tr - (self.s_as_s + h_as * xi)
        dxi_f = clip(maximum(f_as, 0.0) * (1.0 / (c + h_as)), 0.0, 1.0 - xi)
        f_sa = (self.s_sa_f + h_sa * xi) - q_tr
        dxi_r = clip(maximum(f_sa, 0.0) * (1.0 / (c + h_sa)), 0.0, xi)
        dxi = dxi_f - dxi_r
        deps_t = SQ15 * self.eps_l * dxi * nhat
        s_new = s_tr - 2.0 * G * SQ15 * self.eps_l * dxi * nhat
        sig = self.K * tr_e * eye + s_new
        return sig, torch.cat([_flat(eps_t + deps_t, batch),
                               (xi + dxi)[None]])


@register_material("robinson")
class Robinson(HistoryMaterial):
    """Robinson's viscoplasticity: F = J2(s - alpha) / K(T)^2 - 1,
    dgamma = dt A <F>^n, capped where the update lands on the threshold
    surface, backstress hardening (2/3) H deps_p and recovery -dt R alpha,
    K(T) = k0 (1 - omega_t (T - t_ref)) floored at k0 / 100.  History
    [eps_p (9), back stress (9)] = 18.

    The reference's element route calls the law as ``evaluate_small(eps,
    h, dt)`` where the law reads ``evaluate_small(eps, h, T=None,
    dt=1.0)``: the step's dt lands on T, and the flow takes dt = 1.  The
    port does not carry that fault over: ``evaluate_small`` is the law at
    the step's dt and, under TSI, the Gauss points' temperatures T (the
    reference's TSI call passes both in their places)."""

    history_shape = (18,)
    needs_temp = True

    def __init__(self, youngs, nue, k0, a_flow=1.0, n_exp=2.0, hard=0.0,
                 recov=0.0, omega_t=0.0, t_ref=0.0, density=0.0):
        self.youngs, self.nue, self.k0 = float(youngs), float(nue), float(k0)
        self.a_flow, self.n_exp = float(a_flow), float(n_exp)
        self.hard, self.recov = float(hard), float(recov)
        self.omega_t, self.t_ref = float(omega_t), float(t_ref)
        self.density = float(density)
        self.G = self.youngs / (2 * (1 + self.nue))
        self.K = self.youngs / (3 * (1 - 2 * self.nue))

    def evaluate_small(self, eps, h, dt=None, T=None):
        """eps (3, 3, ...), h (18, ...) -> (sigma, h_new) at the step dt
        (None: the reference's default 1, the initial state) and the
        temperatures T (shaped like the batch, or None: t_ref)."""
        return self.return_map(eps, h, T=T, dt=_dt(dt))

    def return_map(self, eps, h, T=None, dt=1.0):
        """The law at the temperature T (a number, a tensor shaped like the
        batch, or None: t_ref) and step dt."""
        G = self.G
        batch = eps.shape[2:]
        eye = gm.eye3l(eps)
        dT = 0.0 if T is None else T - self.t_ref
        eps_p, back = _mat(h, 0, batch), _mat(h, 9, batch)
        ee = eps - eps_p
        tr_e = gm.tr3l(ee)
        s_tr = 2.0 * G * (ee - tr_e * THIRD * eye)
        xi = s_tr - back
        j2 = 0.5 * _norm3l(xi)
        kT = self.k0 * (1.0 - self.omega_t * dT)
        kT = (maximum(kT, 0.01 * self.k0) if torch.is_tensor(kT)
              else max(kT, 0.01 * self.k0))
        F = j2 * (1.0 / (kT * kT)) - 1.0
        dgamma = dt * self.a_flow * gm.pow_ieee(maximum(F, 0.0), self.n_exp)
        norm_xi = gm.sqrt_rn(2.0 * j2 + 1e-30)
        # the cap: landing on the threshold surface sqrt(J2(xi)) = K(T)
        dg_to_surface = maximum(norm_xi - math.sqrt(2.0) * kT, 0.0) * (
            1.0 / (2.0 * G * SQ15))
        dgamma = minimum(dgamma, dg_to_surface)
        deps_p = SQ15 * dgamma * (xi / norm_xi)
        back_new = (back + (2.0 / 3.0) * self.hard * deps_p
                    - dt * self.recov * back)
        sig = self.K * tr_e * eye + s_tr - 2.0 * G * deps_p
        return sig, torch.cat([_flat(eps_p + deps_p, batch),
                               _flat(back_new, batch)])


@register_material("thermoplastic_j2")
class ThermoPlasticJ2(HistoryMaterial):
    """Small-strain J2 plasticity with linear thermal softening of the
    yield stress, sigma_y(T) = sigma_y0 (1 - omega_t (T - t_ref)) (floored
    at 1e-8 sigma_y0), and a thermal eigenstrain alpha_t (T - t_ref) I,
    radial return on the thermal-strain-free strain; linear isotropic
    hardening.  History [eps_p (9), alpha] = 10.  T is the Gauss points'
    temperatures under TSI (``needs_temp``), t_ref without them."""

    history_shape = (10,)
    needs_temp = True

    def __init__(self, youngs, nue, yield_stress, isohard=0.0, omega_t=0.0,
                 alpha_t=0.0, t_ref=0.0, density=0.0):
        self.youngs, self.nue = float(youngs), float(nue)
        self.yield_stress, self.isohard = float(yield_stress), float(isohard)
        self.omega_t, self.alpha_t = float(omega_t), float(alpha_t)
        self.t_ref, self.density = float(t_ref), float(density)
        self.G = self.youngs / (2 * (1 + self.nue))
        self.K = self.youngs / (3 * (1 - 2 * self.nue))

    def evaluate_small(self, eps, h, dt=None, T=None):
        """eps (3, 3, ...), h (10, ...), T shaped like the batch or None
        -> (sigma, h_new); the law reads no dt."""
        G = self.G
        batch = eps.shape[2:]
        eye = gm.eye3l(eps)
        dT = 0.0 if T is None else T - self.t_ref
        ee = eps - self.alpha_t * dT * eye - _mat(h, 0, batch)
        alpha = h[9]
        tr_e = gm.tr3l(ee)
        s_tr = 2.0 * G * (ee - tr_e * THIRD * eye)
        snorm = gm.sqrt_rn(_norm3l(s_tr) + 1e-30)
        sy = maximum(self.yield_stress * (1.0 - self.omega_t * dT)
                     + self.isohard * alpha, 1e-8 * self.yield_stress)
        dgam = maximum(SQ15 * snorm - sy, 0.0) * (
            1.0 / (3.0 * G + self.isohard))
        nhat = s_tr / snorm
        sig = self.K * tr_e * eye + (s_tr - 2.0 * G * dgam * SQ15 * nhat)
        eps_p = _mat(h, 0, batch) + dgam * SQ15 * nhat
        return sig, torch.cat([_flat(eps_p, batch), (alpha + dgam)[None]])


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
        dgam = maximum(f, 0.0) * (1.0 / (3.0 * G + self.isohard))
        ee = ee_tr - dgam * math.sqrt(1.5) * (s_tr / snorm)
        tau = K * tr_e * eye + 2.0 * G * (ee - gm.tr3l(ee) * THIRD * eye)
        Cinv = gm.inv3l(C)
        S = 0.5 * (gm.matmul3l(Cinv, tau) + gm.matmul3l(tau, Cinv))
        eps_p_new = eps - ee
        h_new = torch.stack([eps_p_new[i, j] for i, j in _SYM]
                            + [alpha + dgam])
        return S, h_new


# FCC slip systems: {111} planes, <110> directions (normalised below)
_FCC_N = [(1, 1, 1)] * 3 + [(-1, 1, 1)] * 3 + [(1, -1, 1)] * 3 \
    + [(1, 1, -1)] * 3
_FCC_S = [(0, 1, -1), (1, 0, -1), (1, -1, 0),
          (0, 1, -1), (1, 0, 1), (1, 1, 0),
          (0, 1, 1), (1, 0, -1), (1, 1, 0),
          (0, 1, 1), (1, 0, 1), (1, -1, 0)]


@register_material("crystal_plasticity")
class CrystalPlasticity(HistoryMaterial):
    """Rate-dependent finite-strain crystal plasticity from C alone:
    F = Fe Fp, Ce = Fp^-T C Fp^-1, SVK elasticity on Ee = (Ce - I) / 2,
    resolved shears tau_a = (Ce Se) : (s_a n_a), slip rates
    gdot_a = gdot0 |tau_a / g|^(1/m) sgn(tau_a) capped at dgam_max per
    substep, Voce hardening g' = h0 (1 - g / g_sat) sum_a |gdot_a|; ``nsub``
    Heun substeps of the third-order exponential map, S = Fp^-1 Se Fp^-T.
    Slip systems: ``"fcc"`` (12 octahedral systems) or a list of (s, n)
    pairs.  History [Fp (9, row major), g] = 10, [I, g0] before the first
    step; a history whose Fp entries are all 0 reads as Fp = I."""

    history_shape = (10,)

    def __init__(self, youngs, nue, g0, gdot0=1e-3, rate_m=0.05, h0=0.0,
                 g_sat=None, systems="fcc", nsub=10, density=0.0,
                 dgam_max=0.02):
        self.youngs, self.nue = float(youngs), float(nue)
        self.lam, self.mu = _lame(self.youngs, self.nue)
        self.g0, self.gdot0 = float(g0), float(gdot0)
        self.inv_m = 1.0 / float(rate_m)
        self.h0 = float(h0)
        self.g_sat = 10.0 * self.g0 if g_sat is None else float(g_sat)
        self.nsub, self.density = int(nsub), float(density)
        self.dgam_max = float(dgam_max)
        pairs = (list(zip(_FCC_S, _FCC_N)) if systems == "fcc"
                 else [tuple(p) for p in systems])
        s = np.asarray([p[0] for p in pairs], float)
        n = np.asarray([p[1] for p in pairs], float)
        s /= np.linalg.norm(s, axis=1, keepdims=True)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        if np.abs((s * n).sum(1)).max() >= 1e-12:
            raise ValueError("crystal_plasticity: each slip direction s "
                             "must lie in its plane n")
        self.P = (s[:, :, None] * n[:, None, :]).reshape(-1, 9)  # (nsys, 9)
        self._tables = {}

    def init_history(self, n, dtype=torch.float64, device="cpu"):
        """[I (9), g0] at every Gauss point, (n, 10)."""
        h = torch.tensor([1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0, self.g0],
                         dtype=dtype, device=device)
        return h[None].repeat(n, 1)

    def _P(self, like):
        """The Schmid tensors (nsys, 9) in ``like``'s dtype and device,
        shaped to broadcast against (9, ...) and (nsys, ...) tensors."""
        key = (like.dtype, like.device, like.dim())
        if key not in self._tables:
            P = torch.as_tensor(self.P, dtype=like.dtype, device=like.device)
            self._tables[key] = P.reshape(P.shape + (1,) * (like.dim() - 2))
        return self._tables[key]

    @staticmethod
    def _expm3(A):
        """I + A + A^2 / 2 + A^3 / 6 of (3, 3, ...) tensors."""
        A2 = gm.matmul3l(A, A)
        return (gm.eye3l(A) + A + 0.5 * A2
                + gm.matmul3l(A2, A) * (1.0 / 6.0))

    def _elastic(self, C, Fpi):
        """Ce = Fp^-T C Fp^-1 and its SVK stress Se, (3, 3, ...) each."""
        Ce = gm.matmul3l(gm.tmatmul3l(Fpi, C), Fpi)
        Ee = 0.5 * (Ce - gm.eye3l(C))
        Se = self.lam * gm.tr3l(Ee) * gm.eye3l(C) + 2.0 * self.mu * Ee
        return Ce, Se

    def resolved_shears(self, C, Fpi):
        """tau_a = (Ce Se) : (s_a n_a), (nsys, ...), at C and Fp^-1."""
        batch = C.shape[2:]
        P = self._P(C)
        Ce, Se = self._elastic(C, Fpi)
        M = gm.matmul3l(Ce, Se).reshape((9,) + batch)  # Mandel stress
        tau = P[:, 0] * M[0]
        for k in range(1, 9):
            tau = tau + P[:, k] * M[k]
        return tau

    def _rates(self, C, Fp, g, cap):
        """The slip rates (nsys, ...) at Fp and g."""
        tau = self.resolved_shears(C, gm.inv3l(Fp))
        x = abs1(tau) / g
        pos = x > 0
        mag = torch.where(pos, gm.pow_ieee(torch.where(pos, x, 1.0),
                                           self.inv_m), 0.0)
        return clip(self.gdot0 * mag, 0.0, cap) * torch.sign(tau)

    def _flow(self, gd, P, batch):
        """sum_a gd_a s_a n_a (3, 3, ...) and sum_a |gd_a|, term by
        term."""
        Lp = P[0] * gd[0]
        total = abs1(gd[0])
        for a in range(1, P.shape[0]):
            Lp = Lp + P[a] * gd[a]
            total = total + abs1(gd[a])
        return Lp.reshape((3, 3) + batch), total

    def evaluate(self, C, h, dt=None):
        """C (3, 3, ...), h (10, ...) -> (S, h_new); dt None is the
        reference's default 1."""
        batch = C.shape[2:]
        eye9 = gm.eye3l(C).expand_as(C).reshape((9,) + batch)
        habs = abs1(h[0])
        for k in range(1, 9):
            habs = habs + abs1(h[k])
        Fp = torch.where(habs > 1e-12, h[:9], eye9).reshape((3, 3) + batch)
        g = maximum(h[9], 1e-3 * self.g0)
        P = self._P(C)
        dts = _dt(dt) / self.nsub
        cap = self.dgam_max / dts
        for _ in range(self.nsub):  # Heun: the mean of two rates
            gd1 = self._rates(C, Fp, g, cap)
            Lp1, sum1 = self._flow(gd1, P, batch)
            Fp1 = gm.matmul3l(self._expm3(dts * Lp1), Fp)
            g1 = g + dts * self.h0 * (1.0 - g * (1.0 / self.g_sat)) * sum1
            gdm = 0.5 * (gd1 + self._rates(C, Fp1, g1, cap))
            Lp, summ = self._flow(gdm, P, batch)
            Fp_new = gm.matmul3l(self._expm3(dts * Lp), Fp)
            g = g + dts * self.h0 * (1.0 - g * (1.0 / self.g_sat)) * summ
            Fp = Fp_new
        Fpi = gm.inv3l(Fp)
        _, Se = self._elastic(C, Fpi)
        S = gm.matmul3l(gm.matmul3l(Fpi, Se), Fpi.transpose(0, 1))
        return S, torch.cat([Fp.reshape((9,) + batch), g[None]])
