"""Solid element matrices and loads, evaluated once at setup in float64.

Counterpart of the subset of fourc_tpu/ops/solid.py that the lattice slices
need at setup: the lumped and consistent mass, the linear-kinematics
element stiffness (closed-form B^T D B, where the reference takes jvps of
its element residual) and the surface traction force, as numpy on the host;
and, for meshes whose elements all differ (general geometry), the
per-element lumped mass and the diagonal and absolute row sums of the
element stiffness as torch, chunk by chunk on the caller's device (the
(E, 24, 24) matrices of a 1M-dof mesh never exist at once).  The hot path
never calls them.
"""

from __future__ import annotations

import numpy as np
import torch

from fourc_tpu_torch.core.cells import CellType
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


def element_stiffness_rows(Xe, cell: CellType, lam: float, mu: float,
                           chunk=ELEMENT_CHUNK):
    """Diagonal and absolute row sums (two (E, nen*3) tensors) of the
    linear-elastic element stiffness of ``element_stiffness``, for a float64
    tensor of element coordinates Xe (E, nen, 3)."""
    E, nen = Xe.shape[:2]
    diag, rowabs = Xe.new_empty((E, 3 * nen)), Xe.new_empty((E, 3 * nen))
    eye = torch.eye(3, dtype=Xe.dtype, device=Xe.device)
    for sl, G, wdet in _chunks(Xe, cell, chunk):
        K = lam * torch.einsum("eg,egai,egbk->eaibk", wdet, G, G)
        K += mu * torch.einsum("eg,egaj,egbj,ik->eaibk", wdet, G, G, eye)
        K += mu * torch.einsum("eg,egak,egbi->eaibk", wdet, G, G)
        K = K.reshape(-1, 3 * nen, 3 * nen)
        diag[sl] = torch.diagonal(K, dim1=1, dim2=2)
        rowabs[sl] = K.abs().sum(dim=2)
    return diag, rowabs
