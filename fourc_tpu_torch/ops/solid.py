"""Solid element operators: setup-time matrices and loads, and the plain
PyTorch twins of the element-batch kernels.

Counterpart of the subset of fourc_tpu/ops/solid.py that the ported slices
need.  At setup, in float64: the lumped and consistent mass, the
linear-kinematics element stiffness (closed-form B^T D B, where the
reference takes jvps of its element residual) and the surface traction
force, as numpy on the host; and, for meshes whose elements all differ
(general geometry), the per-element lumped mass and the linear-elastic
element stiffness (whole, or only its diagonal and absolute row sums) as
torch, chunk by chunk on the caller's device (the (E, 24, 24) matrices of a
1M-dof mesh never exist at once on the device).

On the hot path of a mesh of general topology: ``hex8_force_ref`` and
``hex8_tangent_ref``, the twins of the CUDA kernels of
ops/solid_kernels.py (the reference's ``_internal_force_einsum`` for hex8,
nonlinear kinematics, Neo-Hooke or SVK, and its hand-propagated
derivative), on element batches in the kernels' layout: (24, E) arrays, row
a*3+i = component i of local node a, one column per element.  They run on
CPU tensors only; a CUDA tensor goes to the kernels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fourc_tpu_torch.core.cells import CellType, get_cell
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
def hex8_tables(device, dtype):
    """The hex8 reference gradients dN (8, 8, 3), Gauss weights w (8,) and
    shape functions N (8, 8) at the Gauss points, as tensors."""
    cell = get_cell("hex8")
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
        *hex8_tables(X24.device, X24.dtype), lam, mu, model, mcoef, stiff)
    return fe.reshape(24, E)


def hex8_tangent_ref(X24, u24, v24, lam, mu, model="neohooke", mcoef=0.0):
    """Directional derivative of hex8_force_ref along v24, plus
    ``mcoef * sum_g wdet_g N N^T v``: (24, E) -> (24, E)."""
    E = X24.shape[1]
    fe = _lat.jvp_gen_elements(
        X24.reshape(8, 3, E), u24.reshape(8, 3, E), v24.reshape(8, 3, E),
        *hex8_tables(X24.device, X24.dtype), lam, mu, model, mcoef)
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
