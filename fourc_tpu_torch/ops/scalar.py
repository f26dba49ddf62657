"""Scalar-transport element operators (advection-diffusion-reaction).

Counterpart of fourc_tpu/ops/scalar.py, the element calculus of the scatra
and thermo fields: per scalar (test function w)

    int w rhoc phidot + w rhoc (u . grad phi) + D grad w . grad phi
        + w r(phi) - w f dOmega
  + int tau rhoc (u . grad w) R dOmega                         (SUPG)
  R = rhoc phidot + rhoc u . grad phi + r(phi) - f

(the second derivatives of R dropped, as the reference drops them for
linear cells).  The reference computes it in XLA, with no Pallas kernel, so
this plain PyTorch form is its port on every device.

Layout: element batches with the element index last, as the solid's
element route (ops/solid.py): nodal values (nen, E), shape-function
gradients G (nen, d, g, E) and wdet (g, E) from ``element_geometry`` (once
per mesh), N (g, nen), vectors at the Gauss points (d, g, E), scalars
there (g, E); d = 3, or 2 on a quad4 mesh.  One scalar per node: the
multi-species form (the reference's ``residual_multi``) is not ported.

Every sum over nodes, Gauss points or components goes term by term in a
fixed order, square roots are correctly rounded (``gm.sqrt_rn``) and a
division by a constant is a product with its reciprocal, as the history
laws do (materials/plasticity.py): the card and the CPU then round alike,
and a coupled Newton loop stopping at its tolerance lands on the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from fourc_tpu_torch.core.cells import CellType
from fourc_tpu_torch.ops import common as gm

TAU_KINDS = ("zero", "taylor", "franca_valentin")


def _norm(v):
    """|v| of (d, ...) vectors, summed in order, correctly rounded."""
    return gm.sqrt_rn(_dot(v, v))


def _dot(a, b):
    """sum_i a[:, i] b[i] over the component axis of a (n, d, ...) and
    b (d, ...), or of two (d, ...) tensors, summed in order."""
    if a.dim() > b.dim():
        out = a[:, 0] * b[0]
        for i in range(1, b.shape[0]):
            out = out + a[:, i] * b[i]
        return out
    out = a[0] * b[0]
    for i in range(1, b.shape[0]):
        out = out + a[i] * b[i]
    return out


def interp(N, ve):
    """sum_a N[g, a] ve[a]: nodal values (nen, E) at the Gauss points,
    (g, E), summed in node order."""
    out = N[:, 0, None] * ve[0]
    for a in range(1, N.shape[1]):
        out = out + N[:, a, None] * ve[a]
    return out


def nodal_gradient(G, ve):
    """sum_a G[a] ve[a]: the gradient (d, g, E) of nodal values (nen, E)."""
    out = G[0] * ve[0]
    for a in range(1, G.shape[0]):
        out = out + G[a] * ve[a]
    return out


def _test(N, q):
    """sum_g N[g, a] q[g]: (g, E) -> (nen, E), summed in Gauss point
    order."""
    out = N[0, :, None] * q[0]
    for g in range(1, N.shape[0]):
        out = out + N[g, :, None] * q[g]
    return out


def _test_gradient(G, Q):
    """sum_{i, g} G[a, i, g] Q[i, g]: (d, g, E) -> (nen, E), summed in the
    order i, then g (the solid's ``_integrate``)."""
    out = None
    for i in range(G.shape[1]):
        for g in range(G.shape[2]):
            term = G[:, i, g] * Q[i, g]
            out = term if out is None else out + term
    return out


def calc_tau(vel, diff, rhoc, h, dt, kind="taylor"):
    """The SUPG parameter per Gauss point, (g, E): ``zero``; ``taylor``
    (Taylor-Hughes-Zarins, 1 / sqrt((2 rhoc / dt)^2 + (2 rhoc |u| / h)^2
    + 9 (4 D / h^2)^2)); ``franca_valentin`` (h^2 / (h^2 sigma xi1
    + (4 D / m_k) xi), m_k = 1/3, sigma = rhoc / dt, xi = max(Pe, 1) with
    Pe = m_k rhoc |u| h / (2 D), xi1 = max(2 D / (m_k sigma h^2), 1)).
    dt None (or 0): the stationary form.  vel (d, g, E), h (g, E)."""
    if kind in ("zero", "none"):
        return torch.zeros_like(h)
    unorm = _norm(vel)
    h2 = h * h
    if kind == "franca_valentin":
        mk = 1.0 / 3.0
        epe = mk * rhoc * unorm * h * (1.0 / max(2.0 * diff, 1e-300))
        xi = torch.clamp(epe, min=1.0)
        if dt:
            sigma = rhoc / dt
            epe1 = (2.0 * diff) * torch.reciprocal(
                torch.clamp(mk * sigma * h2, min=1e-300))
            xi1 = torch.clamp(epe1, min=1.0)
        else:
            sigma, xi1 = 0.0, 1.0
        return h2 / torch.clamp(h2 * sigma * xi1 + (4.0 * diff / mk) * xi,
                                min=1e-300)
    if kind != "taylor":
        raise ValueError(f"unknown tau kind {kind!r} ({', '.join(TAU_KINDS)})")
    inv_dt = 2.0 * rhoc / dt if dt else 0.0
    adv = 2.0 * rhoc * unorm / torch.clamp(h, min=1e-300)
    dif = (4.0 * diff) * torch.reciprocal(torch.clamp(h2, min=1e-300))
    return torch.reciprocal(gm.sqrt_rn(inv_dt ** 2 + adv * adv
                                       + 9.0 * (dif * dif) + 1e-300))


def char_length(vel, G, wdet):
    """The element length at the Gauss points, (g, E): the streamlength
    2 |u| / sum_a |u_hat . grad N_a| where |u| > 1e-12, else V^(1/d)
    (V the element's volume); V^(1/d) everywhere without a velocity."""
    vol = wdet[0]
    for g in range(1, wdet.shape[0]):
        vol = vol + wdet[g]
    h_vol = gm.pow_ieee(vol, 1.0 / G.shape[1]).expand_as(wdet)
    if vel is None:
        return h_vol
    unorm = _norm(vel)
    uhat = vel / torch.clamp(unorm, min=1e-300)
    ug = _dot(G, uhat).abs()
    denom = ug[0]
    for a in range(1, ug.shape[0]):
        denom = denom + ug[a]
    h_stream = 2.0 * torch.reciprocal(torch.clamp(denom, min=1e-300))
    return torch.where(unorm > 1e-12, h_stream, h_vol)


def residual(G, wdet, N, phie, phidote, diff, rhoc, vel=None, reaction=None,
             source=None, tau_kind="zero", dt=None, extra_source=None):
    """Element residual of the scalar weak form, (nen, E).

    phie, phidote (nen, E): nodal scalar and rate; diff a number or a
    (d, d) tensor (anisotropic conduction; SUPG then takes its mean
    principal value); rhoc a number; vel (d, g, E) or None; reaction a
    function phi -> r(phi) at the Gauss points or None; source (g, E) or
    None (``extra_source`` is added to it: TSI's heating)."""
    if extra_source is not None:
        source = extra_source if source is None else source + extra_source
    gphi = nodal_gradient(G, phie)  # (d, g, E)
    R = rhoc * interp(N, phidote)
    if vel is not None:
        R = R + rhoc * _dot(vel, gphi)
    if reaction is not None:
        R = R + reaction(interp(N, phie))
    if source is not None:
        R = R - source
    f = _test(N, wdet * R)
    if torch.is_tensor(diff) and diff.dim() == 2:
        Dg = torch.stack([_dot(diff[d], gphi) for d in range(len(gphi))])
        diff_tau = float(torch.diagonal(diff).sum()) / diff.shape[0]
    else:
        Dg, diff_tau = diff * gphi, diff
    f = f + _test_gradient(G, wdet * Dg)
    if vel is not None and tau_kind not in ("zero", "none"):
        tau = calc_tau(vel, diff_tau, rhoc, char_length(vel, G, wdet), dt,
                       tau_kind)
        ugw = _dot(G, vel)  # u . grad w, (nen, g, E)
        q = wdet * tau * R
        supg = ugw[:, 0] * q[0]
        for g in range(1, q.shape[0]):
            supg = supg + ugw[:, g] * q[g]
        f = f + rhoc * supg
    return f


def surface_flux(Xf, q_gp, face_cell: CellType):
    """Consistent nodal loads of a prescribed flux on faces, on the host in
    float64: Xf (F, nen_f, d), q_gp (F, g) (positive into the domain) ->
    (F, nen_f)."""
    dA, _ = gm.surface_measure(Xf, face_cell.dN)
    return np.einsum("g,eg,ga,eg->ea", np.asarray(face_cell.gauss_weights),
                     dA, np.asarray(face_cell.N), q_gp)


def capacity_lumped(wdet, N, rhoc):
    """Row-sum lumped capacity per element node, (nen, E)."""
    return rhoc * _test(N, wdet)


def diffusion_diagonal(G, wdet):
    """sum_g wdet grad N_a . grad N_a per element node, (nen, E)."""
    out = None
    for g in range(G.shape[2]):
        Gg = G[:, :, g]
        term = wdet[g] * _dot(Gg.transpose(0, 1), Gg.transpose(0, 1))
        out = term if out is None else out + term
    return out


def gp_coords(X, N):
    """The Gauss points' coordinates (g, E, d) of element coordinates
    X (nen*d, E)."""
    nen, E = N.shape[1], X.shape[1]
    return torch.einsum("ga,aiE->gEi", N, X.reshape(nen, -1, E))
