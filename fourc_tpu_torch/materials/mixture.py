"""Constrained-mixture framework: rules, constituents, growth strategies.

Counterpart of fourc_tpu/materials/mixture.py (the reference's
homogenized mixture rules simple and growthremodel, solid constituents
with a constant prestretch, exponential remodel fibres with stress-mediated
mass turnover and an inelastic remodel stretch, and the isotropic,
anisotropic and stiffness growth strategies), batched over the Gauss
points in the leading-index layout: C (3, 3, ...), history (nh, ...) =
[g_i, lambda_r_i] per remodel fibre.

The reference takes the stress as 2 d psi / dC of the mixture's energy
by AD; here it is in closed form.  The growth and prestretch pull-backs
are constant in C: a solid constituent seen through A = F_g^-1 G gives
rho0 frac A S_m(A^T C A) A^T, from the constituent's own PK2 stress, and a
fibre rho0 frac g_i 2 psi_f'(I4e) a (x) a / (lam_r lam_ext)^2, psi_f' = 0
where I4e < 1 unless the fibre supports compression.
"""

from __future__ import annotations

import math

import torch

from fourc_tpu_torch.materials.base import (HistoryMaterial, dt_or_zero,
                                            elastic_moduli, make_material,
                                            maximum, outer, quad_form,
                                            register_material, unit_vector)
from fourc_tpu_torch.materials.growth import history_free
from fourc_tpu_torch.ops import common as gm


def _fiber_dpsi(k1, k2, I4, supports_compression=False):
    """d psi_f / d I4 of psi_f = k1 / (2 k2) (exp(k2 (I4 - 1)^2) - 1),
    zero where I4 < 1 unless the fibre supports compression."""
    x = I4 - 1.0
    dpsi = k1 * x * gm.exp_ieee(k2 * x * x)
    if not supports_compression:
        dpsi = torch.where(I4 < 1.0, 0.0, dpsi)
    return dpsi


def _fiber_cauchy(k1, k2, I4, supports_compression=False):
    """sigma = 2 d psi_f / d I4 * I4."""
    return 2.0 * _fiber_dpsi(k1, k2, I4, supports_compression) * I4


def _fiber_dcauchy_dI4(k1, k2, I4):
    """d/dI4 [2 k1 x e I4] = 2 k1 e (x + I4 (1 + 2 k2 x^2)), x = I4 - 1,
    e = exp(k2 x^2)."""
    x = I4 - 1.0
    e = gm.exp_ieee(k2 * x * x)
    return 2.0 * k1 * e * (x + I4 * (1.0 + 2.0 * k2 * x * x))


def _norm(v):
    """|v| of a vector given by its three components."""
    return gm.sqrt_rn(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


class _SolidConstituent:
    """A history-free law with a PK2 stress, optionally deposited with a
    constant prestretch G (a diagonal or a full 3x3)."""

    def __init__(self, frac, material, prestretch=None):
        self.frac = float(frac)
        self.mat = history_free(make_material(dict(material)),
                                "mixture solid constituents")
        self.G = None
        if prestretch is not None:
            p = torch.as_tensor(prestretch, dtype=torch.float64)
            self.G = torch.diag(p) if p.dim() == 1 else p

    def pull_back(self, iFg, like):
        """A = F_g^-1 G (3, 3, ...) against C ``like``."""
        if self.G is None:
            return iFg
        G = self.G.to(dtype=like.dtype, device=like.device).reshape(
            (3, 3) + (1,) * (like.dim() - 2))
        return gm.matmul3l(iFg, G)

    def stress(self, C, A):
        """A S_m(A^T C A) A^T."""
        Cp = gm.matmul3l(gm.tmatmul3l(A, C), A)
        Sm = self.mat.pk2_from_E(0.5 * (Cp - gm.eye3l(Cp)))
        return gm.matmul3l(gm.matmul3l(A, Sm), A.transpose(0, 1))


class _RemodelFiber:
    """Exponential fibre family with mass turnover and remodel stretch."""

    def __init__(self, frac, k1, k2, a=(1.0, 0.0, 0.0), lambda_pre=1.0,
                 k_sig=0.0, decay_time=1.0, basal=True, impl=False,
                 supports_compression=False):
        self.frac = float(frac)
        self.k1, self.k2 = float(k1), float(k2)
        self.a = tuple(float(x) for x in a)
        self.lambda_pre = float(lambda_pre)
        self.k_sig = float(k_sig)
        self.decay_time = float(decay_time)
        self.basal = bool(basal)
        self.impl = bool(impl)
        self.supports_compression = bool(supports_compression)
        # homeostatic stress: I4 = lambda_pre^2
        I4 = self.lambda_pre ** 2
        dpsi = (0.0 if I4 < 1.0 and not self.supports_compression else
                self.k1 * (I4 - 1.0) * math.exp(self.k2 * (I4 - 1.0) ** 2))
        self.sig_h = 2.0 * dpsi * I4

    def rates(self, lam_f, lam_r, lam_ext, g):
        """(dg/dt, dlam_r/dt)."""
        s = lam_r * lam_ext
        I4 = lam_f * lam_f / (s * s)
        sig = _fiber_cauchy(self.k1, self.k2, I4, self.supports_compression)
        dsig = sig - self.sig_h
        inv_t = 1.0 / self.decay_time
        inv_sh = 1.0 / self.sig_h if self.sig_h else math.inf
        prod = self.k_sig * dsig * inv_sh + (
            inv_t if self.basal else 0.0)
        g_dot = (prod - inv_t) * g
        dsig_dI4 = _fiber_dcauchy_dI4(self.k1, self.k2, I4)
        lam_r_dot = prod * lam_r * dsig / maximum(2.0 * dsig_dI4 * I4, 1e-12)
        return g_dot, lam_r_dot


@register_material("mixture_rule")
class MixtureRule(HistoryMaterial):
    """Homogenized constrained mixture with growth and remodelling.

    Deck::

      {type: mixture_rule, rule: simple | growthremodel, rho0: 1.0,
       growth_strategy: {kind: isotropic | anisotropic | stiffness,
                         g: [0, 0, 1]},
       constituents: [
         {kind: solid, frac: 0.3, material: {...}, prestretch: [1.1, 1, 1]},
         {kind: remodelfiber, frac: 0.7, k1: .., k2: .., a: [1, 0, 0],
          lambda_pre: 1.1, k_sig: .., decay_time: .., impl: false}]}

    History [g_i, lambda_r_i] per remodel fibre, [1, 1 / lambda_pre]
    before the first step; with dt (not at the initial state) each fibre's
    turnover ODEs advance by explicit Euler, or by 4 fixed-point
    iterations of backward Euler (``impl``), at the old growth."""

    def __init__(self, constituents, rule="simple", rho0=1.0,
                 growth_strategy=None, density=0.0):
        self.rule = str(rule).lower()
        self.rho0 = float(rho0)
        self.density = float(density)
        gs = dict(growth_strategy or {"kind": "isotropic"})
        self.growth_kind = str(gs.pop("kind", "isotropic")).lower()
        self.growth_dir = tuple(float(x) for x in gs.pop("g", (0.0, 0.0,
                                                               1.0)))
        self.solids: list[_SolidConstituent] = []
        self.fibers: list[_RemodelFiber] = []
        for c in constituents:
            c = dict(c)
            kind = str(c.pop("kind", "solid")).lower()
            if kind == "solid":
                self.solids.append(_SolidConstituent(**c))
            elif kind == "remodelfiber":
                self.fibers.append(_RemodelFiber(**c))
            else:
                raise ValueError(f"unknown mixture constituent kind {kind!r}")
        self.history_shape = (max(2 * len(self.fibers), 1),)

    def elastic_moduli(self):
        """(youngs, nue) of the first solid constituent that has them (its
        law's, or a summand's of an elasthyper), for SA-AMG's operator;
        None if none has."""
        for s in self.solids:
            for m in (s.mat, *getattr(s.mat, "summands", ())):
                moduli = elastic_moduli(m)
                if moduli is not None:
                    return moduli
        return None

    def init_history(self, n, dtype=torch.float64, device="cpu"):
        h = torch.zeros((n,) + self.history_shape, dtype=dtype, device=device)
        for i, f in enumerate(self.fibers):
            h[:, 2 * i] = 1.0
            h[:, 2 * i + 1] = 1.0 / f.lambda_pre
        return h

    def _growth_scalar(self, h):
        """The mass-fraction-weighted g_i (solids do not grow)."""
        g = sum(s.frac for s in self.solids)
        for i, f in enumerate(self.fibers):
            g = g + f.frac * h[2 * i]
        return g

    def _iFg(self, h, like):
        """F_g^-1 (3, 3, ...) of the growth strategy at the history's
        growth scalar, against C ``like``; I under rule simple."""
        eye = gm.eye3l(like)
        if self.rule != "growthremodel" or self.growth_kind == "stiffness":
            return eye
        g = self._growth_scalar(h)
        if self.growth_kind == "isotropic":
            return (torch.sign(g) * gm.pow_ieee(torch.abs(g), -1.0 / 3.0)) \
                * eye
        gv = unit_vector(self.growth_dir, like)
        return eye + (1.0 / g - 1.0) * outer(gv, gv)

    def _fiber_kinematics(self, f, iFg, C):
        """(a, a . C a, lam_ext = 1 / max(|F_g^-1 a|, 1e-12))."""
        a = unit_vector(f.a, C)
        Fa = [iFg[i, 0] * a[0] + iFg[i, 1] * a[1] + iFg[i, 2] * a[2]
              for i in range(3)]
        lam_ext = 1.0 / maximum(_norm(Fa), 1e-12)
        return a, quad_form(a, C), lam_ext

    def evaluate(self, C, h, dt=None):
        dt = dt_or_zero(dt)
        iFg = self._iFg(h, C)
        S = None
        for s in self.solids:
            Si = (self.rho0 * s.frac) * s.stress(C, s.pull_back(iFg, C))
            S = Si if S is None else S + Si
        kin = [self._fiber_kinematics(f, iFg, C) for f in self.fibers]
        for i, (f, (a, I4, lam_ext)) in enumerate(zip(self.fibers, kin)):
            g_i = h[2 * i] if self.rule == "growthremodel" else 1.0
            s2 = h[2 * i + 1] * lam_ext
            s2 = s2 * s2
            dpsi = _fiber_dpsi(f.k1, f.k2, I4 / s2, f.supports_compression)
            Si = (2.0 * (self.rho0 * f.frac * g_i * dpsi) / s2) * outer(a, a)
            S = Si if S is None else S + Si
        if S is None:
            S = torch.zeros_like(C)
        if not (self.fibers and dt):
            return S, h
        rows = []
        for i, (f, (a, I4, lam_ext)) in enumerate(zip(self.fibers, kin)):
            lam_f = gm.sqrt_rn(maximum(I4, 1e-12))
            g_n, r_n = h[2 * i], h[2 * i + 1]
            if f.impl:
                g, r = g_n, r_n
                for _ in range(4):
                    gd, rd = f.rates(lam_f, r, lam_ext, g)
                    g = g_n + dt * gd
                    r = r_n + dt * rd
            else:
                gd, rd = f.rates(lam_f, r_n, lam_ext, g_n)
                g, r = g_n + dt * gd, r_n + dt * rd
            rows += [g, r]
        return S, torch.stack(rows)
