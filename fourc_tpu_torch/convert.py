"""Convert the JAX package's state and solver data into this port's layout.

Everything is numpy in, numpy out: the caller turns JAX arrays into numpy
(``np.asarray``) and makes the port's tensors from the result; this module
never imports JAX.  The JAX package keeps dof vectors
either flat (node-major) or in its "wide" lattice layout
``(3, nb*8 + 16, py+2, pz+2)``, whose real nodes sit at
``[:, 8+1+i, 1+j, 1+k]``; the port has one padded lattice layout
``(3, px+2, py+2, pz+2)`` with real nodes at ``[:, 1+i, 1+j, 1+k]``.
There are no weights to carry: the model is the mesh and the material
constants.
"""

from __future__ import annotations

import numpy as np

from fourc_tpu_torch.core.mesh import HEX8_OFFSETS
from fourc_tpu_torch.physics.solid_lattice import STATE_FIELDS

JAX_WIDE_GUARD = 8  # x guard band of the JAX wide layout (BX)


def lattice_from_jax(x, pshape):
    """A JAX dof vector (flat or wide) -> the port's padded lattice; with
    ``pshape=None`` (a mesh of general topology) the flat vector as it is."""
    x = np.asarray(x)
    if pshape is None:
        return x.copy()
    px, py, pz = pshape
    if x.ndim == 1:
        lat = np.moveaxis(x.reshape(px, py, pz, 3), -1, 0)
        return np.pad(lat, ((0, 0), (1, 1), (1, 1), (1, 1)))
    if x.shape[1] == px + 2:
        return x.copy()
    return x[:, JAX_WIDE_GUARD:JAX_WIDE_GUARD + px + 2].copy()


def flat_from_lattice(x):
    """The port's padded lattice -> flat node-major dof vector."""
    return np.moveaxis(np.asarray(x)[:, 1:-1, 1:-1, 1:-1], 0, -1).reshape(-1)


def state_from_jax(state, pshape):
    """JAX solid state dict -> port state arrays (lattice layout, or flat
    dof vectors with ``pshape=None``), plus the time, the step counter and
    the Gauss-point history (block key -> (E, g, nh), the same layout in
    both packages)."""
    out = {k: lattice_from_jax(state[k], pshape) for k in STATE_FIELDS}
    out["t"] = float(np.asarray(state["t"]))
    out["step"] = int(np.asarray(state["step"]))
    out["hist"] = {key: np.array(h, np.float64)
                   for key, h in (state.get("hist") or {}).items()}
    return out


def free_from_jax(free_w, pshape):
    """Dirichlet free-dof weights (flat 0/1) -> bool lattice, ghosts False."""
    return lattice_from_jax(np.asarray(free_w, np.float64), pshape) > 0


def lattice_coords_from_elements(Xe, shape):
    """Element corner coordinates (E, 8, 3) of an nx*ny*nz lattice ->
    node coordinates (px, py, pz, 3)."""
    nx, ny, nz = shape
    Xe = np.asarray(Xe, np.float64).reshape(nx, ny, nz, 8, 3)
    out = np.empty((nx + 1, ny + 1, nz + 1, 3))
    for a, (ox, oy, oz) in enumerate(HEX8_OFFSETS):
        out[ox:ox + nx, oy:oy + ny, oz:oz + nz] = Xe[:, :, :, a]
    return out


def gmg_levels_from_jax(gmg):
    """Per-level data of a JAX StructuredGMG: Jacobi inverse diagonal and
    free mask as lattices, Gershgorin bound, Chebyshev bounds and degree;
    the stencil K (8, 3, 8, 3) of a uniform level, or the node coordinates
    (px, py, pz, 3) of a general-geometry level (K None)."""
    levels = []
    for lv in gmg.levels:
        levels.append({
            "K": (np.asarray(lv._Kstencil, np.float64) if lv.uniform
                  else None),
            "coords": (None if lv.uniform else
                       lattice_coords_from_elements(lv.Xe, lv.shape)),
            "dinv": lattice_from_jax(lv.dinv, lv.pshape),
            "free": free_from_jax(lv.w, lv.pshape),
            "gersh_lmax": float(lv.gersh_lmax),
            "lmax": float(lv.lmax),
            "lmin": float(lv.lmin),
            "degree": int(lv.degree),
        })
    return levels


def amg_from_jax(M):
    """The V-cycle data of a JAX SmoothedAggregationAMG as numpy arrays,
    under the keys that linalg/amg.py:amg_from_data reads (those of both
    packages' npz files): per level ``dinv``, ``lmax`` and the ``nbr``,
    ``blk`` and column count of its A, P and R tables, and the dense coarse
    factor."""
    data = {"n_levels": np.asarray(len(M.levels)),
            "coarse_inv": np.asarray(M._coarse_inv),
            "cheby_degree": np.asarray(M.cheby_degree),
            "ndpn": np.asarray(M.ndpn)}
    for i, lev in enumerate(M.levels):
        data[f"l{i}_dinv"] = np.asarray(lev["dinv"])
        data[f"l{i}_lmax"] = np.asarray(lev["lmax"])
        for nm in ("A", "P", "R"):
            op = lev[nm]
            if op is None:
                continue
            data[f"l{i}_{nm}_nbr"] = np.asarray(op.nbr)
            data[f"l{i}_{nm}_blk"] = np.asarray(op.blk)
            data[f"l{i}_{nm}_ncols"] = np.asarray(op.n_cols)
    return data


def scalar_state_from_jax(state):
    """JAX scalar-field state (scatra or thermo) -> the port's: ``phi``,
    ``phidot`` and ``phi_nm1`` (one scalar per node, the same flat layout
    in both packages), the time and the step counter."""
    out = {k: np.array(state[k], np.float64)
           for k in ("phi", "phidot", "phi_nm1")}
    out["t"] = float(np.asarray(state["t"]))
    out["step"] = int(np.asarray(state["step"]))
    return out


def tsi_state_from_jax(state):
    """JAX TSI state -> the port's: the structure's flat ``d``, ``v``,
    ``a``, ``fint``, ``fext`` and its Gauss-point history (block key ->
    (E, g, nh)), the nodal temperatures ``T`` and their rates ``Tdot``,
    the time and the step counter."""
    out = state_from_jax(state, None)
    for k in ("T", "Tdot"):
        out[k] = np.array(state[k], np.float64)
    return out


def fluid_state_from_jax(state):
    """JAX fluid state (also fluid_ale's) -> the port's: ``x``, ``xdot``
    and ``x_nm1`` (interleaved [u, p] per node, the same flat layout in
    both packages), the Windkessel distal pressures ``pwk`` and the mesh
    displacement ``mesh_disp`` (n_nodes, d) where the state has them, the
    time and the step counter."""
    out = {k: np.array(state[k], np.float64) for k in ("x", "xdot", "x_nm1")}
    for k in ("pwk", "mesh_disp"):
        if k in state:
            out[k] = np.array(state[k], np.float64)
    out["t"] = float(np.asarray(state["t"]))
    out["step"] = int(np.asarray(state["step"]))
    return out


def ale_state_from_jax(state):
    """JAX ALE state -> the port's: the mesh displacement ``d`` and
    velocity ``v`` (n_nodes, d), the time and the step counter."""
    out = {k: np.array(state[k], np.float64) for k in ("d", "v")}
    out["t"] = float(np.asarray(state["t"]))
    out["step"] = int(np.asarray(state["step"]))
    return out
