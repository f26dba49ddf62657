"""Solid element operators: setup-time matrices and loads, the plain
PyTorch twins of the element-batch kernels, and the element route.

Counterpart of the subset of fourc_tpu/ops/solid.py that the ported slices
need.  At setup, in float64: the lumped and consistent mass, the
linear-kinematics element stiffness (closed-form B^T D B, where the
reference takes jvps of its element residual) and the surface traction
force, as numpy on the host; and, for meshes whose elements all differ
(general geometry), the per-element lumped mass and the linear-elastic
element stiffness (whole, or only its diagonal and absolute row sums) as
torch, chunk by chunk on the caller's device (the (E, 24, 24) matrices of a
1M-dof mesh never exist at once on the device).

On the hot path of a mesh of general topology, on element batches in the
dof map's layout: (nen*3, E) arrays, row a*3+i = component i of local node
a, one column per element.

- ``hex8_force_ref`` and ``hex8_tangent_ref``: the twins of the CUDA
  kernels of ops/solid_kernels.py (the reference's
  ``_internal_force_einsum`` for hex8, nonlinear kinematics, Neo-Hooke or
  SVK, and its hand-propagated derivative).  They run on CPU tensors only;
  a CUDA tensor goes to the kernels.
- ``element_force`` and ``element_tangent``: the element route, the
  reference's ``_internal_force_einsum`` for 3D nonlinear or linear
  kinematics and its ``jax.jvp``, for any ported cell and any material
  with a ``pk2_from_E`` or Gauss-point history (the blocks no kernel
  carries: tet4, wedge6, ElastHyper, the history laws, and every block
  under ``kinem`` linear).
  The reference computes these blocks in XLA, not in a Pallas kernel, so
  this plain PyTorch route is their port on every device.  The geometry
  (``element_geometry``) is computed once per mesh; the tangent
  propagates the kinematics by hand and the stress by forward-mode AD
  (``torch.func.jvp`` of ``pk2_from_E``).
- ``tech_force`` and ``tech_tangent``: the element technologies F-bar and
  EAS9 "mild" on the same batches (the reference's ``_internal_force_fbar``
  and ``_internal_force_eas``, which it computes in XLA with no Pallas
  kernel); their tangents are ``torch.func.jvp`` of the force, as the
  reference takes ``jax.jvp``.
- ``gp_stresses`` and ``extrapolate_to_nodes``: Cauchy stresses at the
  Gauss points and their extrapolation to the element nodes, for the nodal
  stresses of a result test.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fourc_tpu_torch.core.cells import CellType, get_cell, origin_dN
from fourc_tpu_torch.ops import common as gm
from fourc_tpu_torch.ops import lattice as _lat


def lumped_mass(Xe, cell: CellType, rho: float):
    """Row-sum lumped mass per element node: (E, nen)."""
    _, detJ = gm.iso_gradients(Xe, cell.dN)
    wdet = gm.weighted(detJ, cell.gauss_weights)  # (E, g)
    return rho * np.einsum("eg,ga->ea", wdet, cell.N)


def consistent_mass_matvec(Xe, ve, cell: CellType, rho: float):
    """(M v) element contribution: ve (E, nen, c) -> (E, nen, c)."""
    _, detJ = gm.iso_gradients(Xe, cell.dN)
    wdet = gm.weighted(detJ, cell.gauss_weights)
    vg = gm.interp_field(ve, cell.N)  # (E, g, c)
    return rho * np.einsum("eg,ga,egc->eac", wdet, cell.N, vg)


def element_stiffness(Xe, cell: CellType, material):
    """Linear-kinematics element stiffness (E, nen*3, nen*3) of a linear
    elastic material:
    K[a,i,b,k] = sum_g wdet (lam G_ai G_bk + mu delta_ik G_a.G_b
                             + mu G_ak G_bi)."""
    lam, mu = material.lame()
    G, detJ = gm.iso_gradients(Xe, cell.dN)  # (E, g, a, 3)
    wdet = gm.weighted(detJ, cell.gauss_weights)
    K = lam * np.einsum("eg,egai,egbk->eaibk", wdet, G, G)
    K = K + mu * np.einsum("eg,egaj,egbj,ik->eaibk", wdet, G, G, np.eye(3))
    K = K + mu * np.einsum("eg,egak,egbi->eaibk", wdet, G, G)
    E, nen = G.shape[0], G.shape[2]
    return K.reshape(E, 3 * nen, 3 * nen)


def surface_traction_force(Xf, traction, face_cell: CellType):
    """Consistent nodal forces of a traction given at face Gauss points.
    Xf (F, nen_f, 3), traction (F, ngp, 3) -> (F, nen_f, 3)."""
    dA, _ = gm.surface_measure(Xf, face_cell.dN)
    t = np.broadcast_to(traction, dA.shape + (Xf.shape[-1],))
    return np.einsum("g,eg,ga,egd->ead", face_cell.gauss_weights, dA,
                     face_cell.N, t)


ELEMENT_CHUNK = 16384  # elements per chunk of the per-element torch setup


@functools.cache
def cell_tables(name, device, dtype):
    """A cell's reference gradients dN (g, nen, 3), Gauss weights w (g,)
    and shape functions N (g, nen) at the Gauss points, as tensors."""
    cell = get_cell(name)
    return tuple(torch.as_tensor(np.asarray(t), dtype=dtype,
                                 device=device).contiguous()
                 for t in (cell.dN, cell.gauss_weights, cell.N))


def hex8_force_ref(X24, u24, lam, mu, model="neohooke", mcoef=0.0,
                   stiff=True):
    """Total-Lagrangian internal force of a hex8 element batch (when
    ``stiff``) plus ``mcoef * sum_g wdet_g N N^T u`` (consistent mass, when
    mcoef != 0): X24, u24 (24, E) -> (24, E)."""
    E = X24.shape[1]
    fe = _lat.force_gen_elements(
        X24.reshape(8, 3, E), u24.reshape(8, 3, E),
        *cell_tables("hex8", X24.device, X24.dtype), lam, mu, model, mcoef,
        stiff)
    return fe.reshape(24, E)


def hex8_tangent_ref(X24, u24, v24, lam, mu, model="neohooke", mcoef=0.0):
    """Directional derivative of hex8_force_ref along v24, plus
    ``mcoef * sum_g wdet_g N N^T v``: (24, E) -> (24, E)."""
    E = X24.shape[1]
    fe = _lat.jvp_gen_elements(
        X24.reshape(8, 3, E), u24.reshape(8, 3, E), v24.reshape(8, 3, E),
        *cell_tables("hex8", X24.device, X24.dtype), lam, mu, model, mcoef)
    return fe.reshape(24, E)


def _chunks(Xe, cell: CellType, chunk):
    """Per chunk of elements: (slice, G (e, g, a, 3), wdet (e, g)), float64
    on Xe's device.  Xe (E, nen, 3) is a float64 tensor."""
    dN = torch.as_tensor(cell.dN, dtype=Xe.dtype, device=Xe.device)
    w = torch.as_tensor(cell.gauss_weights, dtype=Xe.dtype, device=Xe.device)
    for c0 in range(0, Xe.shape[0], chunk):
        sl = slice(c0, min(c0 + chunk, Xe.shape[0]))
        J = torch.einsum("eai,gaj->egij", Xe[sl], dN)
        G = torch.einsum("gaj,egji->egai", dN, torch.linalg.inv(J))
        yield sl, G, torch.linalg.det(J) * w


def element_lumped_mass(Xe, cell: CellType, rho: float,
                        chunk=ELEMENT_CHUNK):
    """Row-sum lumped mass per element node (E, nen) of a float64 tensor of
    element coordinates Xe (E, nen, 3)."""
    N = torch.as_tensor(cell.N, dtype=Xe.dtype, device=Xe.device)
    out = Xe.new_empty(Xe.shape[:2])
    for sl, _, wdet in _chunks(Xe, cell, chunk):
        out[sl] = rho * (wdet @ N)
    return out


def lattice_lumped_mass(lat_coords, nshape, cell: CellType, rho: float):
    """Row-sum lumped mass of a hex8 lattice from every element's own
    geometry: float64 node coordinates (px, py, pz, 3) -> nodal mass
    (px, py, pz, 3), the same for the 3 components."""
    ml = element_lumped_mass(_lat.element_corners(lat_coords, nshape), cell,
                             rho)
    return _lat.assemble_elements(ml[:, :, None].expand(-1, -1, 3), nshape)


def element_stiffness_chunks(Xe, cell: CellType, lam: float, mu: float,
                             chunk=ELEMENT_CHUNK):
    """Per chunk of elements: (slice, K (e, nen*3, nen*3)), the
    linear-elastic element stiffness of ``element_stiffness`` for a float64
    tensor of element coordinates Xe (E, nen, 3), on Xe's device."""
    nen = Xe.shape[1]
    eye = torch.eye(3, dtype=Xe.dtype, device=Xe.device)
    for sl, G, wdet in _chunks(Xe, cell, chunk):
        K = lam * torch.einsum("eg,egai,egbk->eaibk", wdet, G, G)
        K += mu * torch.einsum("eg,egaj,egbj,ik->eaibk", wdet, G, G, eye)
        K += mu * torch.einsum("eg,egak,egbi->eaibk", wdet, G, G)
        yield sl, K.reshape(-1, 3 * nen, 3 * nen)


def element_stiffness_rows(Xe, cell: CellType, lam: float, mu: float,
                           chunk=ELEMENT_CHUNK):
    """Diagonal and absolute row sums (two (E, nen*3) tensors) of the
    element stiffness of ``element_stiffness_chunks``."""
    E, nen = Xe.shape[:2]
    diag, rowabs = Xe.new_empty((E, 3 * nen)), Xe.new_empty((E, 3 * nen))
    for sl, K in element_stiffness_chunks(Xe, cell, lam, mu, chunk):
        diag[sl] = torch.diagonal(K, dim1=1, dim2=2)
        rowabs[sl] = K.abs().sum(dim=2)
    return diag, rowabs


# ---------------------------------------------------------------------------
# the element route: any cell, any material with pk2_from_E
# ---------------------------------------------------------------------------


def element_geometry(X, cell: CellType, chunk=4 * ELEMENT_CHUNK):
    """Element batch coordinates X (nen*d, E) -> G (nen, d, g, E), the
    physical gradients of the shape functions at the Gauss points, and
    wdet (g, E), det J times the Gauss weight; in X's dtype and device,
    chunk by chunk of elements.  d = 3, or 2 for a quad4 mesh."""
    dN, w, _ = cell_tables(cell.name, X.device, X.dtype)
    nen, E, d = cell.nen, X.shape[1], cell.dim
    det, inv = (gm.det3l, gm.inv3l) if d == 3 else (gm.det2l, gm.inv2l)
    Xt = X.reshape(nen, d, E)
    G = X.new_empty((nen, d, cell.ngp, E))
    wdet = X.new_empty((cell.ngp, E))
    for c0 in range(0, E, chunk):
        sl = slice(c0, min(c0 + chunk, E))
        J = torch.einsum("aiE,gaj->ijgE", Xt[:, :, sl], dN)  # (d, d, g, e)
        detJ = det(J)
        G[:, :, :, sl] = torch.einsum("gaj,jigE->aigE", dN, inv(J, detJ))
        wdet[:, sl] = detJ * w[:, None]
    return G, wdet


def _grad(ut, G):
    """Gradient of a nodal field at the Gauss points: ut (nen, c, E),
    G (nen, d, g, E) -> H (c, d, g, E), H[c, d] = sum_a u[a, c] G[a, d]."""
    H = ut[0, :, None, None] * G[0][None]
    for a in range(1, G.shape[0]):
        H = H + ut[a, :, None, None] * G[a][None]
    return H


def _integrate(Q, G):
    """f[a, i] = sum_{j, g} Q[i, j, g] G[a, j, g]: Q (d, d, g, E) (the
    weighted first Piola-Kirchhoff stress), G (nen, d, g, E) ->
    (nen, d, E).  Summed term by term in a fixed order (j, then g), so that
    every device rounds alike (a reduction kernel sums in its own order)."""
    out = None
    for j in range(G.shape[1]):
        for g in range(G.shape[2]):
            term = Q[None, :, j, g] * G[:, None, j, g]
            out = term if out is None else out + term
    return out


def _mass(wdet, N, vt):
    """Consistent mass matvec of unit density: sum_g wdet N_a N_b v_b,
    vt (nen, 3, E) -> (nen, 3, E)."""
    vg = torch.einsum("ga,aiE->igE", N, vt)  # (3, g, E)
    return torch.einsum("gE,ga,igE->aiE", wdet, N, vg)


def _green_lagrange(H):
    """E = (H + H^T + H^T H) / 2, formed without C - I."""
    return 0.5 * (H + H.transpose(0, 1) + gm.tmatmul3l(H, H))


def _sym(H):
    return 0.5 * (H + H.transpose(0, 1))


def reads_temperature(material) -> bool:
    """A law whose stress takes the Gauss points' temperatures: a
    thermo-elastic one (``pk2_from_E(E, T)``) or a history law that
    ``needs_temp`` (``evaluate_small(eps, h, dt, T)``); the element route
    hands every other law no temperature, as the reference's."""
    return (getattr(material, "kind", None) == "thermo_solid"
            or getattr(material, "needs_temp", False))


def is_prestressed(material) -> bool:
    """A MULF block (``materials.elastic.MulfPrestress``): its history
    is the prestretch F0, its kinematics ``MulfPrestress.total_gradient``."""
    return getattr(material, "prestress", None) == "mulf"


def _prestretch(history):
    """F0 (3, 3, g, E) of a MULF block's history (E, g, 9), row-major."""
    E, g, _ = history.shape
    return history.permute(2, 1, 0).reshape(3, 3, g, E)


def _stress(material, H, kinem, history=None, dt=None, temps=None):
    """The stress of the element route at the displacement gradient H
    (3, 3, g, E) and the new history: the reference's ``_gp_stress``.
    Nonlinear kinematics: S at the Green-Lagrange strain E (``pk2_from_E``;
    a history law's ``evaluate`` at C = 2E + I); linear: the stress at
    eps = sym H (``pk2_from_E``, or a history law's ``evaluate_small``).
    ``history`` (E, g, nh) is the block's, as the reference keeps it; the
    new history comes back in that layout (None without history).
    ``temps`` (g, E), the Gauss points' temperatures, reach a law that
    ``reads_temperature``."""
    T = temps if temps is not None and reads_temperature(material) else None
    if history is None:
        arg = _sym(H) if kinem == "linear" else _green_lagrange(H)
        S = material.pk2_from_E(arg) if T is None else \
            material.pk2_from_E(arg, T)
        return S, None
    h = history.permute(2, 1, 0)  # (nh, g, E)
    if kinem == "linear":
        S, h_new = (material.evaluate_small(_sym(H), h, dt) if T is None
                    else material.evaluate_small(_sym(H), h, dt, T=T))
    else:
        Egl = _green_lagrange(H)
        S, h_new = material.evaluate(2.0 * Egl + gm.eye3l(Egl), h, dt)
    return S, h_new.permute(2, 1, 0)


def _first_pk(material, H, kinem, history=None, dt=None, temps=None):
    """(P, new history): the stress that the element route integrates
    against the shape-function gradients, P = F S (sigma under linear
    kinematics); a MULF block's at its total deformation gradient
    (``MulfPrestress.first_pk``), its history the prestretch kept."""
    if is_prestressed(material):
        return material.first_pk(H, _prestretch(history)), history
    S, h_new = _stress(material, H, kinem, history, dt, temps)
    P = S if kinem == "linear" else gm.matmul3l(H + gm.eye3l(H), S)
    return P, h_new


def element_force(G, wdet, u, material, mcoef=0.0, N=None, stiff=True,
                  kinem="nonlinear", history=None, dt=None,
                  with_history=False, temps=None):
    """Total-Lagrangian internal force f = sum_g wdet_g P(F_g) G_g of an
    element batch (when ``stiff``) plus ``mcoef * sum_g wdet_g N N^T u``
    (the consistent mass, when mcoef != 0; N (g, nen) is then required):
    u (nen*3, E) -> (nen*3, E).  With ``kinem`` "linear" the stress is the
    law's at the small strain, sigma = S(eps), eps = sym grad u (the
    reference's ``stress_small``: exact for SVK, nonlinear in eps for
    Neo-Hooke), and f = sum_g wdet_g sigma G_g.  A law with history takes
    the block's ``history`` (E, g, nh) and ``dt`` (``_stress``), a law
    that reads them the temperatures ``temps`` (g, E); with
    ``with_history`` the result is (f, the new history)."""
    nen, _, _, E = G.shape
    ut = u.reshape(nen, 3, E)
    out = torch.zeros_like(ut)
    h_new = None
    if stiff:
        P, h_new = _first_pk(material, _grad(ut, G), kinem, history, dt,
                             temps)
        out = out + _integrate(P * wdet, G)
    if mcoef:
        out = out + mcoef * _mass(wdet, N, ut)
    out = out.reshape(nen * 3, E)
    return (out, h_new) if with_history else out


def _history_law(material, kinem, history, dt, temps=None):
    """The stress of a history law as a function of the strain (eps, or
    E with C = 2E + I) at the old history (E, g, nh) and the temperatures
    ``temps`` (g, E) of a law that reads them."""
    h = history.permute(2, 1, 0)
    if kinem == "linear":
        if temps is not None and reads_temperature(material):
            return lambda e: material.evaluate_small(e, h, dt, T=temps)[0]
        return lambda e: material.evaluate_small(e, h, dt)[0]
    return lambda e: material.evaluate(2.0 * e + gm.eye3l(e), h, dt)[0]


# the symmetric unit directions of ``history_moduli``: (i, j) is e_ij for
# i == j, e_ij + e_ji otherwise
_SYM_DIRECTIONS = ((0, 0), (1, 1), (2, 2), (0, 1), (1, 2), (0, 2))


def history_moduli(G, u, material, kinem, history, dt=None, temps=None):
    """The linearization of a history law's stress at u and the old
    history, for ``element_tangent``'s ``moduli``: the stress S (None
    under linear kinematics) and its forward derivatives along the six
    symmetric unit strains, (6, 3, 3, g, E).  A Newton iterate takes it
    once, and every Krylov apply of its tangent then costs a contraction
    instead of a forward pass through the return map (the stress is
    linear in a symmetric strain direction, so the apply is the
    directional derivative to rounding)."""
    nen, _, _, E = G.shape
    H = _grad(u.reshape(nen, 3, E), G)
    law = _history_law(material, kinem, history, dt, temps)
    e = _sym(H) if kinem == "linear" else _green_lagrange(H)
    dirs = torch.zeros((len(_SYM_DIRECTIONS),) + e.shape, dtype=e.dtype,
                       device=e.device)
    for k, (i, j) in enumerate(_SYM_DIRECTIONS):
        dirs[k, i, j] = 1.0
        dirs[k, j, i] = 1.0
    S, C = torch.func.vmap(lambda d: torch.func.jvp(law, (e,), (d,)))(dirs)
    return (S[0] if kinem != "linear" else None), C


def _contract(moduli, de):
    """sum_k de_k C_k over the symmetric components of de (3, 3, ...)."""
    out = de[0, 0] * moduli[0]
    for k, (i, j) in enumerate(_SYM_DIRECTIONS[1:], start=1):
        out = out + de[i, j] * moduli[k]
    return out


def _law_derivative(material, law, e, de):
    """(law(e), its derivative along de): forward mode, or, for a law
    whose stress is affine in the strain (``affine_in_strain``), its
    ``pk2_from_E`` at de, forward mode's tangent to the bit without the
    host time of a forward pass (``tools/affine_tangent_ab.py``)."""
    if getattr(material, "affine_in_strain", False):
        return law(e), material.pk2_from_E(de)
    return torch.func.jvp(law, (e,), (de,))


def temperature_moduli(G, wdet, u, material, kinem, temps, history=None,
                       dt=None):
    """The stress's derivative in the Gauss points' temperatures at u and
    temps, weighted for integration: wdet dP/dT (3, 3, g, E), by forward
    mode along unit temperatures (each Gauss point's stress reads its own
    T only, so its derivative along any dtemps is dtemps times this)."""
    nen, _, _, E = G.shape
    H = _grad(u.reshape(nen, 3, E), G)
    dS = torch.func.jvp(
        lambda T: _stress(material, H, kinem, history, dt, T)[0],
        (temps,), (torch.ones_like(temps),))[1]
    dP = dS if kinem == "linear" else gm.matmul3l(H + gm.eye3l(H), dS)
    return dP * wdet


def element_temperature_derivative(G, moduli, dtemps):
    """The derivative of ``element_force`` (its stress part) along the
    Gauss points' temperatures dtemps (g, E), from the
    ``temperature_moduli`` at the point of linearization: TSI's thermal
    expansion block K_st."""
    nen, _, _, E = G.shape
    return _integrate(dtemps * moduli, G).reshape(nen * 3, E)


def element_tangent(G, wdet, u, v, material, mcoef=0.0, N=None,
                    kinem="nonlinear", history=None, dt=None, moduli=None,
                    temps=None):
    """Directional derivative of ``element_force`` along v plus
    ``mcoef * sum_g wdet_g N N^T v``: with dH = grad v and F = I + H,
    dE = (dH^T F + F^T dH) / 2, dS = the stress's derivative along dE
    (forward-mode AD of ``pk2_from_E``, or of a history law's return map
    at the old history, as the reference's ``jax.jvp``) and
    dP = dH S + F dS; with ``kinem`` "linear" dP = the stress's derivative
    at eps along sym dH.  ``moduli``, a history law's
    ``history_moduli`` at u, replaces the forward pass by its
    contraction; ``temps`` (g, E) as in ``element_force``.  A MULF block
    differentiates its ``first_pk`` (the base law by forward mode)."""
    nen, _, _, E = G.shape
    ut, vt = u.reshape(nen, 3, E), v.reshape(nen, 3, E)
    H, dH = _grad(ut, G), _grad(vt, G)
    if is_prestressed(material):
        dP = material.first_pk_derivative(H, dH, _prestretch(history))
    elif moduli is not None:
        if kinem == "linear":
            dP = _contract(moduli[1], _sym(dH))
        else:
            F = H + gm.eye3l(H)
            dS = _contract(moduli[1], _sym(gm.tmatmul3l(F, dH)))
            dP = gm.matmul3l(dH, moduli[0]) + gm.matmul3l(F, dS)
    else:
        if history is not None:
            # a forward pass through the return map per apply: what
            # ``FieldBlock.hessian_at`` differentiates along u (through
            # the moduli it would nest a six-direction linearization in
            # every apply, not measured)
            law = _history_law(material, kinem, history, dt, temps)
        elif temps is not None and reads_temperature(material):
            def law(e):
                return material.pk2_from_E(e, temps)
        else:
            law = material.pk2_from_E
        if kinem == "linear":
            dP = _law_derivative(material, law, _sym(H), _sym(dH))[1]
        else:
            F = H + gm.eye3l(H)
            dE = _sym(gm.tmatmul3l(F, dH))
            S, dS = _law_derivative(material, law, _green_lagrange(H), dE)
            dP = gm.matmul3l(dH, S) + gm.matmul3l(F, dS)
    out = _integrate(dP * wdet, G)
    if mcoef:
        out = out + mcoef * _mass(wdet, N, vt)
    return out.reshape(nen * 3, E)


# ---------------------------------------------------------------------------
# element technologies: F-bar and EAS9 "mild"
# ---------------------------------------------------------------------------

TECHS = ("fbar", "eas_mild")
N_EAS = 9  # enhanced strain parameters per element


def origin_geometry(X, cell: CellType):
    """Element batch coordinates X (nen*3, E) -> (G0 (nen, 3, E), J0inv
    (3, 3, E), j0 (E,)): the physical gradients, inverse Jacobian and
    Jacobian determinant at xi = 0 (``origin_dN``), the centre that F-bar
    and EAS read."""
    dN0 = torch.as_tensor(origin_dN(cell.name), dtype=X.dtype,
                          device=X.device)
    J0 = torch.einsum("aiE,aj->ijE", X.reshape(cell.nen, 3, -1), dN0)
    j0 = gm.det3l(J0)
    J0inv = gm.inv3l(J0, j0)
    return torch.einsum("aj,jiE->aiE", dN0, J0inv), J0inv, j0


def eas9_param_modes(cell: CellType) -> np.ndarray:
    """The 9 parametric strain modes of EAS "mild" (Simo-Rifai), (9, 3, 3,
    g): each normal strain linear in its own parametric coordinate, each
    shear in its two coordinates (symmetric)."""
    xi = np.asarray(cell.gauss_points)
    M = np.zeros((N_EAS, 3, 3, xi.shape[0]))
    for k in range(3):
        M[k, k, k] = xi[:, k]
    k = 3
    for i, j in ((0, 1), (1, 2), (0, 2)):
        for c in (i, j):
            M[k, i, j] = M[k, j, i] = 0.5 * xi[:, c]
            k += 1
    return M


def eas_modes(X, cell: CellType):
    """The mapped enhancement fields of an element batch, (9, 3, 3, g, E):
    M~_k = (j0 / det J) J0^-T M^p_k J0^-1, which makes int M~ : const dV = 0
    hold exactly (the patch test)."""
    _, J0inv, j0 = origin_geometry(X, cell)
    dN = torch.as_tensor(cell.dN, dtype=X.dtype, device=X.device)
    detJ = gm.det3l(torch.einsum("aiE,gaj->ijgE",
                                 X.reshape(cell.nen, 3, -1), dN))
    Mp = torch.as_tensor(eas9_param_modes(cell), dtype=X.dtype,
                         device=X.device)
    return (torch.einsum("miE,kmng,njE->kijgE", J0inv, Mp, J0inv)
            * (j0[None] / detJ)[None, None, None])


def _modes_times(Mt, alpha):
    """sum_k M~_k alpha_k: (9, 3, 3, g, E), (9, E) -> (3, 3, g, E)."""
    out = Mt[0] * alpha[0]
    for k in range(1, Mt.shape[0]):
        out = out + Mt[k] * alpha[k]
    return out


def _eas_stress(Ec, wdet, Mt, material):
    """The stress at the enhanced strain Ec + sum_k M~_k alpha_k, with alpha
    from the reference's batched local Newton on int M~ : S dV = 0: alpha
    starts at 0 in every call (no history), each iteration solves the
    (E, 9, 9) local systems, whose columns are the stress's forward
    derivatives along M~_l.  Differentiating this unrolled computation
    (nested forward mode) gives the reference's tangent, also where the
    local iterations have not converged.  The reference's fixed count of
    local iterations: 1 for SVK, whose local problem is linear, else 3."""
    alpha = Ec.new_zeros((N_EAS, Ec.shape[-1]))
    svk = type(material).__name__ == "StVenantKirchhoff"
    for _ in range(1 if svk else 3):
        Etot = Ec + _modes_times(Mt, alpha)
        S, dS = torch.func.vmap(
            lambda t: torch.func.jvp(material.pk2_from_E, (Etot,), (t,)))(Mt)
        r = (Mt * (S[0] * wdet)[None]).sum(dim=(1, 2, 3))  # (9, E)
        A = torch.einsum("kijgE,lijgE->Ekl", Mt, dS * wdet)
        # solve_ex: no singularity check, whose host sync cost 23 ms per
        # call at n=56 on the card; a singular system gives a non-finite
        # residual, which Newton never counts as converged
        alpha = alpha + torch.linalg.solve_ex(A, -r.T)[0].T
    return material.pk2_from_E(Ec + _modes_times(Mt, alpha))


def _fbar_kinematics(H, H0):
    """F = I + H, J = det F, lr = (2/3)(log J0 - log J) and the F-bar
    Green-Lagrange strain E_bar = s^2 E_H + (s^2 - 1) I / 2 with
    s^2 - 1 = expm1(lr) (cancellation-free, as the reference has it)."""
    F = H + gm.eye3l(H)
    J = gm.det3l(F)
    J0 = gm.det3l(H0 + gm.eye3l(H0))
    lr = (2.0 / 3.0) * (torch.log(J0)[None] - torch.log(J))
    s2m1 = torch.expm1(lr)
    Ebar = (1.0 + s2m1) * _green_lagrange(H) + 0.5 * s2m1 * gm.eye3l(H)
    return F, J, J0, lr, s2m1, Ebar


def tech_force(tech, G, wdet, geo, u, material, kinem="nonlinear"):
    """Internal force of an element batch under ``tech``: u (nen*3, E) ->
    (nen*3, E).  ``geo`` is the technology's geometry: G0 (nen, 3, E) of
    ``origin_geometry`` for F-bar, M~ of ``eas_modes`` for EAS.

    F-bar (nonlinear kinematics only): the spatial form
    f_a = sum_g wdet_g (J / J0) F_bar S(E_bar) F_bar^T . grad_x N_a, with
    F_bar = (J0 / J)^(1/3) F, J0 the determinant at the element centre.
    EAS: the stress at the enhanced strain (``_eas_stress``), then
    f = sum_g wdet_g F S G_g (nonlinear) or sum_g wdet_g S G_g (linear)."""
    nen, _, _, E = G.shape
    ut = u.reshape(nen, 3, E)
    H = _grad(ut, G)
    if tech == "fbar":
        if kinem != "nonlinear":
            raise ValueError("TECH fbar requires 3D nonlinear kinematics")
        H0 = _grad(ut, geo[:, :, None])[:, :, 0]
        F, J, J0, lr, _, Ebar = _fbar_kinematics(H, H0)
        S = material.pk2_from_E(Ebar)
        Fbar = torch.exp(0.5 * lr) * F
        tau = gm.matmul3l(gm.matmul3l(Fbar, S), Fbar.transpose(0, 1)) \
            * (J / J0[None])
        Finv = gm.inv3l(F, J)
        gx = sum(G[:, k:k + 1] * Finv[k][None] for k in range(3))
        out = _integrate(tau * wdet, gx)
    elif tech == "eas_mild":
        Ec = _sym(H) if kinem == "linear" else _green_lagrange(H)
        S = _eas_stress(Ec, wdet, geo, material)
        P = S if kinem == "linear" else gm.matmul3l(H + gm.eye3l(H), S)
        out = _integrate(P * wdet, G)
    else:
        raise ValueError(f"unknown element technology {tech!r}")
    return out.reshape(nen * 3, E)


def tech_tangent(tech, G, wdet, geo, u, v, material, mcoef=0.0, N=None,
                 kinem="nonlinear"):
    """Directional derivative of ``tech_force`` along v (forward-mode AD of
    the force, as the reference takes ``jax.jvp``; F-bar's is
    nonsymmetric) plus ``mcoef * sum_g wdet_g N N^T v``."""
    _, out = torch.func.jvp(
        lambda x: tech_force(tech, G, wdet, geo, x, material, kinem),
        (u,), (v,))
    if mcoef:
        nen, E = G.shape[0], G.shape[-1]
        out = out + mcoef * _mass(wdet, N, v.reshape(nen, 3, E)).reshape(
            nen * 3, E)
    return out


# ---------------------------------------------------------------------------
# stresses at the Gauss points and at the nodes (result tests)
# ---------------------------------------------------------------------------


def gp_stresses(G, u, material, kinem="nonlinear", tech="none", G0=None):
    """Cauchy stress at the Gauss points, (3, 3, g, E): sigma = F S F^T / J,
    or under ``kinem`` linear the law's stress at the small strain.  Under
    F-bar (G0: ``origin_geometry``'s gradients) the stress is taken at
    F_bar = (J0 / J)^(1/3) F, as the residual takes it; EAS's output is the
    standard one (the reference's)."""
    nen, _, _, E = G.shape
    ut = u.reshape(nen, 3, E)
    H = _grad(ut, G)
    if kinem == "linear":
        return material.pk2_from_E(_sym(H))
    F = H + gm.eye3l(H)
    Egl = _green_lagrange(H)
    if tech == "fbar":
        H0 = _grad(ut, G0[:, :, None])[:, :, 0]
        _, _, _, _, s2m1, Egl = _fbar_kinematics(H, H0)
        F = torch.sqrt(1.0 + s2m1) * F
    S = material.pk2_from_E(Egl)
    return gm.matmul3l(gm.matmul3l(F, S), F.transpose(0, 1)) / gm.det3l(F)


def extrapolate_to_nodes(gp_vals, cell: CellType):
    """Gauss-point values (..., g, E) -> nodal values (nen, ..., E) of the
    polynomial through them: the pseudo-inverse of the Gauss-point shape
    matrix N (g, nen), the reference's (exact for hex8; tet4's single
    Gauss point broadcasts)."""
    Mx = torch.as_tensor(np.linalg.pinv(np.asarray(cell.N)),
                         dtype=gp_vals.dtype, device=gp_vals.device)
    return torch.einsum("ag,...gE->a...E", Mx, gp_vals)
