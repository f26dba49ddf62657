"""Solid element matrices and loads, evaluated once on the host in float64.

Counterpart of the subset of fourc_tpu/ops/solid.py that the lattice slice
needs at setup: the lumped and consistent mass, the linear-kinematics
element stiffness (closed-form B^T D B, where the reference takes jvps of
its element residual) and the surface traction force.  All functions take
and return numpy arrays; the hot path never calls them.
"""

from __future__ import annotations

import numpy as np

from fourc_tpu_torch.core.cells import CellType
from fourc_tpu_torch.ops import common as gm


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
