"""Hex8 lattice: layout, stencil collapse and the kernels' twins.

Counterpart of fourc_tpu/ops/lattice.py and of the general-geometry part of
fourc_tpu/ops/lattice_pallas.py.  On a hex8 lattice local node a of element
(i, j, k) is lattice point (i, j, k) + offset_a.  On a uniform lattice the
internal force, the tangent apply, the consistent mass and every GMG level
operator are 3D stencils over the node lattice.  On a general-geometry
lattice (box topology, arbitrary node positions, e.g. a jittered box) the
node coordinates ride along as a second lattice and every element's
Jacobians are computed from its 8 corners at each Gauss point.

Layout: one padded, component-first lattice ``(3, px+2, py+2, pz+2)`` with a
zero ghost shell on every side.  Real node (i, j, k) lives at
``[:, 1+i, 1+j, 1+k]``.  Every operator here and in ops/lattice_kernels.py
takes and returns this layout and leaves the ghost shell zero.

The functions ``stencil_matvec_ref``, ``neo_force_ref``, ``neo_jvp_ref``,
``neo_force_gen_ref`` and ``neo_jvp_gen_ref`` are the plain PyTorch twins of
the five CUDA kernels: the same math, in shift form over the real element
grid (no ghost-element masks needed).  The tangents are the hand-propagated
dual of the force, not autograd, so they check the same algebra the tangent
kernels run.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from fourc_tpu_torch.core.mesh import HEX8_OFFSETS
from fourc_tpu_torch.ops import common as gm


@dataclass(frozen=True)
class LatticeSpec:
    """One structured hex8 block: real node counts and element spacings
    (``h`` is None on a general-geometry lattice)."""

    pshape: tuple  # (px, py, pz)
    h: tuple | None  # (hx, hy, hz)

    @property
    def nshape(self):
        return tuple(p - 1 for p in self.pshape)

    @property
    def lshape(self):
        """Shape of the padded lattice layout."""
        return (3,) + tuple(p + 2 for p in self.pshape)

    @property
    def ndof(self):
        return int(np.prod(self.pshape)) * 3


def detect_lattice(disc) -> LatticeSpec | None:
    """LatticeSpec of a single-block uniform axis-aligned hex8 box, else
    None (same test as the reference)."""
    ss = disc.structured_shape
    if ss is None or len(ss) != 4 or ss[3] != 1 or len(disc.blocks) != 1:
        return None
    if next(iter(disc.blocks.values())).cell != "hex8":
        return None
    px, py, pz = ss[0] + 1, ss[1] + 1, ss[2] + 1
    coords = np.asarray(disc.coords)
    if coords.shape[0] != px * py * pz:
        return None
    lat = coords.reshape(px, py, pz, 3)
    hx = lat[1, 0, 0] - lat[0, 0, 0]
    hy = lat[0, 1, 0] - lat[0, 0, 0]
    hz = lat[0, 0, 1] - lat[0, 0, 0]
    off_axis = (hx[1], hx[2], hy[0], hy[2], hz[0], hz[1])
    if max(abs(float(x)) for x in off_axis) >= 1e-12:
        return None
    h = (float(hx[0]), float(hy[1]), float(hz[2]))
    if min(h) <= 0:
        return None
    ii, jj, kk = np.meshgrid(np.arange(px), np.arange(py), np.arange(pz),
                             indexing="ij")
    want = lat[0, 0, 0] + np.stack([ii * h[0], jj * h[1], kk * h[2]], axis=-1)
    eps = 64 * np.finfo(np.float32).eps * max(1.0, np.abs(coords).max())
    if not np.allclose(lat, want, rtol=0.0, atol=eps):
        return None
    return LatticeSpec(pshape=(px, py, pz), h=h)


def general_lattice(dofmap) -> LatticeSpec | None:
    """LatticeSpec (h None) of a one-block hex8 lattice dof map, whatever
    the node positions; None for anything else."""
    if len(dofmap.blocks) != 1:
        return None
    blk = next(iter(dofmap.blocks.values()))
    if blk.cell != "hex8" or blk.structured is None:
        return None
    return LatticeSpec(pshape=tuple(blk.structured["pshape"]), h=None)


def coord_lattice(coords, spec: LatticeSpec, dtype, device) -> torch.Tensor:
    """Node coordinates (n_nodes, 3) -> padded lattice in the layout of a dof
    vector (the kernels read only the corners of real elements)."""
    x = torch.as_tensor(np.asarray(coords, np.float64).reshape(-1))
    return to_lattice(x, spec).to(device=device, dtype=dtype).contiguous()


def element_corners(lat_coords: torch.Tensor, nshape) -> torch.Tensor:
    """Lattice coordinates (px, py, pz, 3) -> element corners (E, 8, 3),
    elements in lattice order, corners in hex8 node order."""
    nx, ny, nz = nshape
    return torch.stack([lat_coords[ox:ox + nx, oy:oy + ny, oz:oz + nz]
                        for ox, oy, oz in HEX8_OFFSETS],
                       dim=3).reshape(nx * ny * nz, 8, 3)


def assemble_elements(vals: torch.Tensor, nshape) -> torch.Tensor:
    """Per-element node values (E, 8, c) summed into the node lattice
    (px, py, pz, c); elements in lattice order."""
    nx, ny, nz = nshape
    v = vals.reshape(nx, ny, nz, 8, -1)
    out = vals.new_zeros((nx + 1, ny + 1, nz + 1, v.shape[-1]))
    for a, (ox, oy, oz) in enumerate(HEX8_OFFSETS):
        out[ox:ox + nx, oy:oy + ny, oz:oz + nz] += v[:, :, :, a]
    return out


def to_lattice(v: torch.Tensor, spec: LatticeSpec) -> torch.Tensor:
    """Flat node-major dof vector -> padded component-first lattice."""
    px, py, pz = spec.pshape
    x = v.reshape(px, py, pz, 3).permute(3, 0, 1, 2)
    return F.pad(x, (1, 1, 1, 1, 1, 1))


def from_lattice(x: torch.Tensor, spec: LatticeSpec) -> torch.Tensor:
    """Padded lattice -> flat node-major dof vector."""
    return x[:, 1:-1, 1:-1, 1:-1].permute(1, 2, 3, 0).reshape(-1)


def collapse_stencil(Ke):
    """One congruent-element (24, 24) matrix -> (8, 3, 8, 3) node-block
    stencil K[a, i, b, j] in hex8 node order."""
    Ke = np.asarray(Ke)
    if Ke.shape != (24, 24):
        raise ValueError(f"expected a (24, 24) element matrix, got {Ke.shape}")
    return Ke.reshape(8, 3, 8, 3)


def uniform_geometry(cell, spec: LatticeSpec):
    """Cartesian shape gradients G (ngp, 8, 3), G[g,a,j] = dN[g,a,j] 2/h_j,
    and weighted jacobians wdet (ngp,) = w_g hx hy hz / 8 (float64)."""
    h = np.asarray(spec.h, np.float64)
    G = np.asarray(cell.dN, np.float64) * (2.0 / h)[None, None, :]
    wdet = np.asarray(cell.gauss_weights, np.float64) * float(np.prod(h)) / 8
    return G, wdet


def assemble_uniform(vals, nshape):
    """Sum one per-element (8, 3) node table over every element of a
    uniform lattice with ``nshape`` elements -> (px, py, pz, 3), numpy."""
    nx, ny, nz = nshape
    out = np.zeros((nx + 1, ny + 1, nz + 1, 3))
    for a, (ox, oy, oz) in enumerate(HEX8_OFFSETS):
        out[ox:ox + nx, oy:oy + ny, oz:oz + nz] += vals[a]
    return out


def material_model(material) -> str | None:
    """Kernel material model name, or None if the law has no kernel."""
    from fourc_tpu_torch.materials.elastic import NeoHooke, StVenantKirchhoff

    if isinstance(material, NeoHooke):
        return "neohooke"
    if isinstance(material, StVenantKirchhoff):
        return "svk"
    return None


# ---------------------------------------------------------------------------
# plain PyTorch twins of the CUDA kernels
# ---------------------------------------------------------------------------


def _corners(x):
    """The 8 corner values of every real element: list of (3, nx, ny, nz)."""
    _, X, Y, Z = x.shape
    nx, ny, nz = X - 3, Y - 3, Z - 3
    return [x[:, 1 + ox:1 + ox + nx, 1 + oy:1 + oy + ny, 1 + oz:1 + oz + nz]
            for ox, oy, oz in HEX8_OFFSETS]


def _assemble(fe, like):
    """Element vectors fe (8, 3, nx, ny, nz) -> summed into node lattice."""
    out = torch.zeros_like(like)
    nx, ny, nz = fe.shape[2:]
    for a, (ox, oy, oz) in enumerate(HEX8_OFFSETS):
        out[:, 1 + ox:1 + ox + nx, 1 + oy:1 + oy + ny,
            1 + oz:1 + oz + nz] += fe[a]
    return out


def _as(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def stencil_matvec_ref(K, v):
    """y = A v for the uniform (8, 3, 8, 3) node-block stencil K."""
    ue = torch.stack(_corners(v))  # (8, 3, nx, ny, nz)
    fe = torch.einsum("aibj,bj...->ai...", _as(K, v), ue)
    return _assemble(fe, v)


def _strain_A(H):
    """A = 2E = H + H^T + H^T H."""
    return H + H.transpose(0, 1) + torch.einsum("ki...,kj...->ij...", H, H)


def _neo_stress(A, lam, mu):
    """S = C^-1 (mu A + lam lnJ I), lnJ = log1p(det C - 1) / 2."""
    eye = gm.eye3l(A)
    trA = gm.tr3l(A)
    trA2 = torch.einsum("ij...,ji...->...", A, A)
    detC_m1 = trA + 0.5 * (trA * trA - trA2) + gm.det3l(A)
    lnJ = 0.5 * torch.log1p(detC_m1)
    Cinv = gm.inv3l(A + eye, 1.0 + detC_m1)
    S = gm.matmul3l(Cinv, mu * A + lam * lnJ * eye)
    return S, (Cinv, detC_m1, lnJ)


def _neo_stress_dual(A, Ad, aux, lam, mu):
    Cinv, detC_m1, lnJ = aux
    eye = gm.eye3l(A)
    trA, trAd = gm.tr3l(A), gm.tr3l(Ad)
    trA2d = 2.0 * torch.einsum("ij...,ij...->...", A, Ad)
    detAd = torch.einsum("ij...,ij...->...", gm.cof3l(A), Ad)
    detC_m1_d = trAd + trA * trAd - 0.5 * trA2d + detAd
    lnJd = 0.5 * detC_m1_d / (1.0 + detC_m1)
    Cinvd = -gm.matmul3l(gm.matmul3l(Cinv, Ad), Cinv)
    M = mu * A + lam * lnJ * eye
    Md = mu * Ad + lam * lnJd * eye
    return gm.matmul3l(Cinvd, M) + gm.matmul3l(Cinv, Md)


def _svk_stress(A, lam, mu):
    return lam * 0.5 * gm.tr3l(A) * gm.eye3l(A) + mu * A, None


def _svk_stress_dual(A, Ad, aux, lam, mu):
    return lam * 0.5 * gm.tr3l(Ad) * gm.eye3l(Ad) + mu * Ad


STRESS = {"neohooke": (_neo_stress, _neo_stress_dual),
          "svk": (_svk_stress, _svk_stress_dual)}


def neo_force_ref(u, G, wdet, lam, mu, model="neohooke"):
    """Total-Lagrangian internal force f = sum_g wdet_g P(F_g) G_g."""
    stress = STRESS[model][0]
    G, wdet = _as(G, u), _as(wdet, u)
    ue = torch.stack(_corners(u))
    fe = torch.zeros_like(ue)
    for g in range(G.shape[0]):
        H = torch.einsum("ai...,aj->ij...", ue, G[g])
        S, _ = stress(_strain_A(H), lam, mu)
        P = gm.matmul3l(H + gm.eye3l(H), S)
        fe += wdet[g] * torch.einsum("ij...,aj->ai...", P, G[g])
    return _assemble(fe, u)


def _tangent_stress(H, Hd, lam, mu, model):
    """Pd = d/dt P(H + t Hd) at t = 0; H None means u = 0, where every law
    is linear elasticity: Pd = lam tr(Hd) I + mu (Hd + Hd^T)."""
    if H is None:
        return _svk_stress_dual(None, Hd + Hd.transpose(0, 1), None, lam, mu)
    stress, dual = STRESS[model]
    A = _strain_A(H)
    Ad = (Hd + Hd.transpose(0, 1)
          + torch.einsum("ki...,kj...->ij...", Hd, H)
          + torch.einsum("ki...,kj...->ij...", H, Hd))
    S, aux = stress(A, lam, mu)
    Sd = dual(A, Ad, aux, lam, mu)
    return gm.matmul3l(Hd, S) + gm.matmul3l(H + gm.eye3l(H), Sd)


def _mass_gp(ve, Ng, c):
    """One Gauss point of the consistent mass: c N (N^T v), per element."""
    vbar = torch.einsum("b,bc...->c...", Ng, ve)
    return c * Ng[:, None, None, None, None] * vbar


def neo_jvp_ref(u, v, G, wdet, lam, mu, model="neohooke", N=None, mcoef=0.0):
    """Tangent apply K(u) v, the hand-propagated dual of neo_force_ref,
    plus ``mcoef * sum_g wdet_g N N^T v`` (consistent mass) when mcoef != 0.
    """
    G, wdet = _as(G, u), _as(wdet, u)
    ue, ve = torch.stack(_corners(u)), torch.stack(_corners(v))
    fe = torch.zeros_like(ue)
    for g in range(G.shape[0]):
        H = torch.einsum("ai...,aj->ij...", ue, G[g])
        Hd = torch.einsum("ai...,aj->ij...", ve, G[g])
        Pd = _tangent_stress(H, Hd, lam, mu, model)
        fe += wdet[g] * torch.einsum("ij...,aj->ai...", Pd, G[g])
        if mcoef:
            fe += _mass_gp(ve, _as(N, u)[g], mcoef * wdet[g])
    return _assemble(fe, u)


def _geom_gp(xe, dN_g, w_g):
    """Geometry of one Gauss point of every real element from its corner
    coordinates xe (8, 3, nx, ny, nz): cartesian shape gradients
    G (8, 3, nx, ny, nz) and the weighted Jacobian determinant wdet."""
    J = torch.einsum("ai...,aj->ij...", xe, dN_g)  # J_ij = dx_i / dxi_j
    det = gm.det3l(J)
    Jinv = gm.inv3l(J, det)
    return torch.einsum("aj,ji...->ai...", dN_g, Jinv), det * w_g


def neo_force_gen_ref(x, u, dN, w, N, lam, mu, model="neohooke", mcoef=0.0,
                      stiff=True):
    """General-geometry internal force sum_g wdet_g P(F_g) G_g (when
    ``stiff``) plus the consistent mass applied to u,
    ``mcoef * sum_g wdet_g N N^T u`` (when mcoef != 0).  x is the coordinate
    lattice; dN (8, 8, 3), w (8,) and N (8, 8) are the hex8 reference
    gradients, Gauss weights and shape functions at the Gauss points."""
    stress = STRESS[model][0]
    dN, w, N = _as(dN, u), _as(w, u), _as(N, u)
    xe, ue = torch.stack(_corners(x)), torch.stack(_corners(u))
    fe = torch.zeros_like(ue)
    for g in range(dN.shape[0]):
        G, wdet = _geom_gp(xe, dN[g], w[g])
        if stiff:
            H = torch.einsum("ai...,aj...->ij...", ue, G)
            S, _ = stress(_strain_A(H), lam, mu)
            P = gm.matmul3l(H + gm.eye3l(H), S)
            fe += wdet * torch.einsum("ij...,aj...->ai...", P, G)
        if mcoef:
            fe += _mass_gp(ue, N[g], mcoef * wdet)
    return _assemble(fe, u)


def neo_jvp_gen_ref(x, u, v, dN, w, N, lam, mu, model="neohooke",
                    mcoef=0.0):
    """General-geometry tangent apply K(u) v, the hand-propagated dual of
    neo_force_gen_ref, plus ``mcoef * sum_g wdet_g N N^T v`` when
    mcoef != 0.  ``u=None`` means u = 0: the linear-elastic operator (the
    exact-geometry GMG level operator), which reads no u."""
    dN, w, N = _as(dN, v), _as(w, v), _as(N, v)
    xe, ve = torch.stack(_corners(x)), torch.stack(_corners(v))
    ue = None if u is None else torch.stack(_corners(u))
    fe = torch.zeros_like(ve)
    for g in range(dN.shape[0]):
        G, wdet = _geom_gp(xe, dN[g], w[g])
        H = None if ue is None else torch.einsum("ai...,aj...->ij...", ue, G)
        Hd = torch.einsum("ai...,aj...->ij...", ve, G)
        Pd = _tangent_stress(H, Hd, lam, mu, model)
        fe += wdet * torch.einsum("ij...,aj...->ai...", Pd, G)
        if mcoef:
            fe += _mass_gp(ve, N[g], mcoef * wdet)
    return _assemble(fe, v)
