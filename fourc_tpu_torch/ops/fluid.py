"""Stabilized incompressible Navier-Stokes element operators (equal-order,
residual-based: SUPG, PSPG and grad-div).

Counterpart of fourc_tpu/ops/fluid.py.  Weak form, test functions (w, q):

  momentum:   int w.rho(udot + (c.grad)u) + 2 mu eps(w):eps(u) - p div w
                  - w.rho b dOmega
  continuity: int q div u dOmega
  SUPG:       int tau_M rho (c.grad w) . R_M dOmega
  PSPG:       int tau_M grad q . R_M / rho dOmega
  grad-div:   int tau_C rho (div w)(div u) dOmega
  R_M = rho (udot + (c.grad)u) + grad p - rho b

with the convective velocity c = u - u_grid on a moving (ALE) mesh, the
viscous second derivatives dropped (linear cells), and the constant or
dynamic Smagorinsky eddy viscosity and the multifractal subgrid terms where
the caller passes them.  The reference computes it in XLA, with no Pallas
kernel, so this plain PyTorch form is its port on every device.

Layout: element batches with the element index last, as the scalar field's
(ops/scalar.py): G (nen, d, g, E) and wdet (g, E) from
``ops.solid.element_geometry``, N (g, nen), nodal velocities (nen, d, E),
nodal pressures (nen, E), vectors at the Gauss points (d, g, E), tensors
(d, d, g, E).  Every sum over nodes, Gauss points or components goes term
by term in a fixed order, square roots are correctly rounded and a
division by a constant is a product with its reciprocal: the card and the
CPU round alike, and Newton's loop lands on the same bits.

The stabilization parameters are frozen in the Newton linearization, as
the reference's ``stop_gradient``: they are computed from detached inputs,
so forward mode carries no tangent through them.
"""

from __future__ import annotations

import torch

from fourc_tpu_torch.ops import common as gm
from fourc_tpu_torch.ops.scalar import _dot, _test, _test_gradient, interp
from fourc_tpu_torch.ops.solid import _grad, _integrate


def _sum0(x):
    """x[0] + x[1] + ... over the leading axis, in order."""
    out = x[0]
    for k in range(1, x.shape[0]):
        out = out + x[k]
    return out


def element_volume(wdet):
    """sum_g wdet, (E,)."""
    return _sum0(wdet)


def interp_vec(N, ve):
    """Nodal vectors (nen, d, E) at the Gauss points, (d, g, E)."""
    out = N[None, :, 0, None] * ve[0][:, None]
    for a in range(1, N.shape[1]):
        out = out + N[None, :, a, None] * ve[a][:, None]
    return out


def _test_vec(N, q):
    """sum_g N[g, a] q[i, g]: (d, g, E) -> (nen, d, E)."""
    out = N[0, :, None, None] * q[None, :, 0]
    for g in range(1, N.shape[0]):
        out = out + N[g, :, None, None] * q[None, :, g]
    return out


def _grad_test(G, q):
    """sum_g G[a, i, g] q[g]: (g, E) -> (nen, d, E)."""
    out = G[:, :, 0] * q[0]
    for g in range(1, G.shape[2]):
        out = out + G[:, :, g] * q[g]
    return out


def _conv(c, H):
    """(c.grad) of a field with gradient H: sum_j c[j] H[:, j],
    (d, g, E), (d, d, g, E) -> (d, g, E)."""
    out = c[0] * H[:, 0]
    for j in range(1, c.shape[0]):
        out = out + c[j] * H[:, j]
    return out


def _double_dot(A, B):
    """sum_ij A[i, j] B[i, j] of (d, d, ...) tensors, in row order."""
    d = A.shape[0]
    out = None
    for i in range(d):
        for j in range(d):
            term = A[i, j] * B[i, j]
            out = term if out is None else out + term
    return out


def stab_params(c, mu, rho, G, wdet, dt):
    """(tau_M, tau_C) at the Gauss points, (g, E): Taylor-Hughes-Zarins'
    transient tau_M and Tezduyar's tau_C, from the streamlength where
    |c| > 1e-12 (at most 10 V^(1/d)) and V^(1/d) elsewhere.  c (d, g, E)
    the convective velocity and mu a number or (g, E); both are detached
    here, so the parameters are frozen under forward mode.  dt None: the
    stationary form.  In float32 the 1e-300 guards round to 0, as the
    reference's do: the streamlength is then inf where the streamline sum
    is 0, and ``where`` takes V^(1/d) there."""
    c = c.detach()
    if torch.is_tensor(mu):
        mu = mu.detach()
    d = G.shape[1]
    unorm = gm.sqrt_rn(_dot(c, c) + 1e-30)
    h_vol = gm.pow_ieee(element_volume(wdet), 1.0 / d).expand_as(wdet)
    uhat = c / unorm
    denom = _sum0(_dot(G, uhat).abs())
    h_stream = 2.0 * torch.reciprocal(torch.clamp(denom, min=1e-300))
    h = torch.where(unorm > 1e-12, torch.minimum(h_stream, 10.0 * h_vol),
                    h_vol)
    inv_dt = 2.0 * rho / dt if dt else 0.0
    adv = (2.0 * rho) * unorm / h
    dif = (4.0 * mu) * torch.reciprocal(h * h)
    tau_m = torch.reciprocal(gm.sqrt_rn(inv_dt ** 2 + adv * adv
                                        + 9.0 * (dif * dif)))
    if torch.is_tensor(mu):
        re_h = rho * unorm * h / torch.clamp(2.0 * mu, min=1e-300)
    else:  # a product with the reciprocal, as the card divides by a number
        re_h = (rho * unorm * h) * (1.0 / max(2.0 * mu, 1e-300))
    z = torch.clamp(re_h * (1.0 / 3.0), max=1.0)
    tau_c = 0.5 * h * unorm * z
    return tau_m, tau_c


def _fields(G, N, ve, pe):
    """The velocity (d, g, E), its gradient (d, d, g, E) and divergence
    (g, E), the pressure (g, E) and its gradient (d, g, E) at the Gauss
    points of nodal values ve (nen, d, E), pe (nen, E): linear maps, so the
    same code takes increments."""
    gradu = _grad(ve, G)  # du_i/dx_j
    divu = gradu[0, 0]
    for i in range(1, G.shape[1]):
        divu = divu + gradu[i, i]
    return (interp_vec(N, ve), gradu, divu, interp(N, pe),
            _grad(pe[:, None], G)[0])


def _supg(ugw, q):
    """sum_g ugw[a, g] q[i, g]: (nen, g, E), (d, g, E) -> (nen, d, E)."""
    out = ugw[:, None, 0] * q[None, :, 0]
    for g in range(1, q.shape[1]):
        out = out + ugw[:, None, g] * q[None, :, g]
    return out


def linearize(G, wdet, N, ue, pe, udote, mu, rho, body=None, dt=None,
              stab=True, grid_vel=None,
              smagorinsky_cs=0.0, cs2=None, mfs_B=None, mfs_ue_hat=None,
              rho_gp=None, cont_src_gp=None):
    """The element residual (f_mom (nen, d, E), f_cont (nen, E)) and its
    derivative ``tangent(due, dpe, dudote) -> (df_mom, df_cont)`` at this
    point, the Jacobian action that forward mode takes through
    ``residual`` (tau_M, tau_C, cs2 and the multifractal inputs frozen),
    from the intermediates kept here: a Krylov apply does only the
    tangent's operations.

    G, wdet: the geometry at the CURRENT coordinates (the caller adds the
    ALE mesh displacement); ue, udote (nen, d, E) and pe (nen, E): nodal
    velocity, its rate and pressure; body (d, g, E) a body acceleration;
    stab: SUPG, PSPG and grad-div (all three, or none: the reference's
    ``stab: zero``);
    grid_vel (nen, d, E) the ALE mesh velocity (c = u - u_grid);
    smagorinsky_cs the constant Smagorinsky Cs, cs2 (E,) a dynamic Cs^2
    (both: nu_t = Cs^2 V^(2/d) |S|); mfs_B (E,) and mfs_ue_hat (nen, d, E)
    the multifractal subgrid coefficient and filtered velocity (Picard
    inputs, detached by the caller).  ``rho_gp`` and ``cont_src_gp``, the
    reference's low-Mach density and continuity source, are refused."""
    if rho_gp is not None or cont_src_gp is not None:
        raise NotImplementedError(
            "fluid residual: rho_gp / cont_src_gp (low-Mach flow) is not "
            "ported")
    d = G.shape[1]
    u, gradu, divu, p, gradp = _fields(G, N, ue, pe)
    c = u if grid_vel is None else u - interp_vec(N, grid_vel)
    acc = interp_vec(N, udote) + _conv(c, gradu)
    if body is not None:
        acc = acc - body
    R_M = rho * acc + gradp
    f_mom = _test_vec(N, wdet * (rho * acc)) - _grad_test(G, wdet * p)
    eps = 0.5 * (gradu + gradu.transpose(0, 1))
    mu_eff = mu
    smag = bool(smagorinsky_cs) or cs2 is not None
    if smag:
        delta2 = gm.pow_ieee(element_volume(wdet), 2.0 / d)
        c2 = cs2 if cs2 is not None else smagorinsky_cs ** 2
        snorm = gm.sqrt_rn(2.0 * _double_dot(eps, eps) + 1e-30)
        mu_t = (rho * c2 * delta2) * snorm
        mu_eff = mu + mu_t
        f_mom = f_mom + 2.0 * _integrate(eps * (wdet * mu_t), G)
    f_mom = f_mom + (2.0 * mu) * _integrate(eps * wdet, G)
    if mfs_B is not None:
        du_s = mfs_B * (u - interp_vec(N, mfs_ue_hat))
        graddu_s = mfs_B * (gradu - _grad(mfs_ue_hat, G))
        extra = _conv(c, graddu_s) + _conv(du_s, gradu) \
            + _conv(du_s, graddu_s)
        f_mom = f_mom + _test_vec(N, wdet * (rho * extra))
    f_cont = _test(N, wdet * divu)
    if stab:
        tau_m, tau_c = stab_params(c, mu_eff, rho, G, wdet, dt)
        wtm = wdet * tau_m
        ugw = _dot(G, c)  # (c . grad) w_a, (nen, g, E)
        f_mom = f_mom + rho * _supg(ugw, wtm * R_M)
        f_mom = f_mom + _grad_test(G, wdet * tau_c * (rho * divu))
        f_cont = f_cont + _test_gradient(G, wtm * R_M) * (1.0 / rho)

    def tangent(due, dpe, dudote):
        du, dgradu, ddivu, dp, dgradp = _fields(G, N, due, dpe)
        dacc = interp_vec(N, dudote) + _conv(du, gradu) + _conv(c, dgradu)
        dR = rho * dacc + dgradp
        df = _test_vec(N, wdet * (rho * dacc)) - _grad_test(G, wdet * dp)
        deps = 0.5 * (dgradu + dgradu.transpose(0, 1))
        if smag:
            dmu_t = (rho * c2 * delta2) * (
                (2.0 * _double_dot(eps, deps)) / snorm)
            df = df + 2.0 * _integrate(deps * (wdet * mu_t)
                                       + eps * (wdet * dmu_t), G)
        df = df + (2.0 * mu) * _integrate(deps * wdet, G)
        if mfs_B is not None:
            ddu_s = mfs_B * du
            dgraddu_s = mfs_B * dgradu
            dextra = (_conv(du, graddu_s) + _conv(c, dgraddu_s)
                      + _conv(ddu_s, gradu) + _conv(du_s, dgradu)
                      + _conv(ddu_s, graddu_s) + _conv(du_s, dgraddu_s))
            df = df + _test_vec(N, wdet * (rho * dextra))
        dcont = _test(N, wdet * ddivu)
        if stab:
            df = df + rho * (_supg(_dot(G, du), wtm * R_M)
                             + _supg(ugw, wtm * dR))
            df = df + _grad_test(G, wdet * tau_c * (rho * ddivu))
            dcont = dcont + _test_gradient(G, wtm * dR) * (1.0 / rho)
        return df, dcont

    return f_mom, f_cont, tangent


def residual(*args, **kwargs):
    """Element residual (f_mom (nen, d, E), f_cont (nen, E)); the
    arguments of ``linearize``."""
    f_mom, f_cont, _ = linearize(*args, **kwargs)
    return f_mom, f_cont


def velocity_lumped_mass(wdet, N, rho):
    """Row-sum lumped mass per element node (the velocity dofs), (nen, E)."""
    return rho * _test(N, wdet)
