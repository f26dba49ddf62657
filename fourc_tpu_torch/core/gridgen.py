"""Structured hex8 box generator.

Counterpart of fourc_tpu/core/gridgen.py:box for hex8 cells, with the
connectivity and the face quads built by vectorised numpy instead of Python
loops, so the n=72 flagship box (1,167,051 dofs) builds without a
per-element Python loop.
"""

from __future__ import annotations

import numpy as np

from fourc_tpu_torch.core.mesh import (Discretization, ElementBlock,
                                       FaceBlock, lattice_conn)


def box(nx: int, ny: int, nz: int, lo=(0.0, 0.0, 0.0), hi=(1.0, 1.0, 1.0),
        cell: str = "hex8", name: str = "structure",
        mat_id: int = 1) -> Discretization:
    """nx*ny*nz-element rectangular cuboid of hex8 cells."""
    if cell != "hex8":
        raise NotImplementedError(f"box cell {cell!r} is not ported (hex8 is)")
    # lo + (hi - lo) * i / n, the reference's native formula, so that the
    # coordinates are the reference's to the last bit
    xs, ys, zs = (lo[a] + (hi[a] - lo[a]) * np.arange(n + 1.0) / n
                  for a, n in enumerate((nx, ny, nz)))
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    disc = Discretization(name=name, coords=coords)
    disc.blocks["hex8"] = ElementBlock("hex8", lattice_conn(nx, ny, nz),
                                       mat_id)
    disc.structured_shape = (nx, ny, nz, 1)
    _add_box_sets(disc, lo, hi)
    return disc


def _face_quads(nodes_on_face, coords, axes):
    """quad4 connectivity of a lattice face (same order as the reference:
    first in-face axis slowest)."""
    a, b = axes
    key = np.round(coords[nodes_on_face][:, [a, b]], 12)
    ua, ia = np.unique(key[:, 0], return_inverse=True)
    ub, ib = np.unique(key[:, 1], return_inverse=True)
    grid = -np.ones((ua.size, ub.size), dtype=np.int64)
    grid[ia, ib] = nodes_on_face
    q = np.stack([grid[:-1, :-1], grid[1:, :-1], grid[1:, 1:], grid[:-1, 1:]],
                 axis=-1).reshape(-1, 4)
    return q[(q >= 0).all(axis=1)].astype(np.int32)


def _add_box_sets(disc: Discretization, lo, hi):
    c = disc.coords
    tol = 1e-9 * max(1.0, float(np.abs(c).max()))
    for d, nm_lo, nm_hi in [(0, "xmin", "xmax"), (1, "ymin", "ymax"),
                            (2, "zmin", "zmax")]:
        lo_ids = np.where(np.abs(c[:, d] - lo[d]) < tol)[0].astype(np.int32)
        hi_ids = np.where(np.abs(c[:, d] - hi[d]) < tol)[0].astype(np.int32)
        disc.node_sets[nm_lo] = lo_ids
        disc.node_sets[nm_hi] = hi_ids
        axes = tuple(a for a in range(3) if a != d)
        disc.face_sets[nm_lo] = [FaceBlock("quad4",
                                           _face_quads(lo_ids, c, axes))]
        disc.face_sets[nm_hi] = [FaceBlock("quad4",
                                           _face_quads(hi_ids, c, axes))]
    disc.node_sets["all"] = np.arange(disc.n_nodes, dtype=np.int32)
