"""Structured generators: the box of hex8, tet4 and wedge6 cells, the
rectangle of quad4 cells.

Counterpart of fourc_tpu/core/gridgen.py:box for linear 3D cells, with the
connectivity and the face quads built by vectorised numpy instead of Python
loops, so the n=72 flagship box (1,167,051 dofs) builds without a
per-element Python loop.  A tet4 box splits every hex8 of the lattice into
6 tets and a wedge6 box into 2 wedges, with no new nodes, in the
reference's order: all hexes' first piece, then all hexes' second, and so
on.  The face sets are quad4 lattice faces for every cell type.  A
rectangle's node sets are the reference's, node for node, and its face sets
line2 edges in the reference's orientation.
"""

from __future__ import annotations

import numpy as np

from fourc_tpu_torch.core.mesh import (Discretization, ElementBlock,
                                       FaceBlock, lattice_conn)

# local hex8 nodes of each piece of a split hex (reference order)
_HEX_PIECES = {
    "hex8": ((0, 1, 2, 3, 4, 5, 6, 7),),
    "tet4": ((0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6), (0, 7, 4, 6),
             (0, 4, 5, 6), (0, 5, 1, 6)),
    "wedge6": ((0, 1, 2, 4, 5, 6), (0, 2, 3, 4, 6, 7)),
}


def box(nx: int, ny: int, nz: int, lo=(0.0, 0.0, 0.0), hi=(1.0, 1.0, 1.0),
        cell: str = "hex8", name: str = "structure",
        mat_id: int = 1) -> Discretization:
    """Rectangular cuboid of nx*ny*nz hexes, each one hex8 cell or split
    into 6 tet4 or 2 wedge6 cells."""
    if cell not in _HEX_PIECES:
        raise NotImplementedError(f"box cell {cell!r} is not ported "
                                  f"({', '.join(_HEX_PIECES)} are)")
    # lo + (hi - lo) * i / n, the reference's native formula, so that the
    # coordinates are the reference's to the last bit
    xs, ys, zs = (lo[a] + (hi[a] - lo[a]) * np.arange(n + 1.0) / n
                  for a, n in enumerate((nx, ny, nz)))
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    disc = Discretization(name=name, coords=coords)
    hexes = lattice_conn(nx, ny, nz)
    disc.blocks[cell] = ElementBlock(
        cell, np.concatenate([hexes[:, list(p)] for p in _HEX_PIECES[cell]]),
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


RECTANGLE_CELLS = ("quad4",)  # quad8, quad9 and tri3 are not ported


def rectangle(nx: int, ny: int, lo=(0.0, 0.0), hi=(1.0, 1.0),
              cell: str = "quad4", name: str = "structure",
              mat_id: int = 1) -> Discretization:
    """Rectangle of nx*ny quad4 cells, element (i, j) at row i*ny + j, node
    (i, j) at id i*(ny+1) + j, coordinates by ``np.linspace`` as the
    reference's."""
    if cell not in RECTANGLE_CELLS:
        raise NotImplementedError(f"rectangle cell {cell!r} is not ported "
                                  f"({', '.join(RECTANGLE_CELLS)} is)")
    px, py = nx + 1, ny + 1
    X, Y = np.meshgrid(np.linspace(lo[0], hi[0], px),
                       np.linspace(lo[1], hi[1], py), indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    conn = np.stack([ii * py + jj, (ii + 1) * py + jj,
                     (ii + 1) * py + jj + 1, ii * py + jj + 1],
                    axis=-1).reshape(-1, 4).astype(np.int32)
    disc = Discretization(name=name, coords=coords)
    disc.blocks[cell] = ElementBlock(cell, conn, mat_id)
    disc.structured_shape = (nx, ny, 1)
    _add_box_sets_2d(disc, lo, hi)
    return disc


def _add_box_sets_2d(disc: Discretization, lo, hi):
    """xmin/xmax/ymin/ymax node sets and their line2 edges, ordered along
    the other axis; the set ``all``."""
    c = disc.coords
    tol = 1e-9 * max(1.0, float(np.abs(c).max()))
    for d, nm_lo, nm_hi in [(0, "xmin", "xmax"), (1, "ymin", "ymax")]:
        lo_ids = np.where(np.abs(c[:, d] - lo[d]) < tol)[0].astype(np.int32)
        hi_ids = np.where(np.abs(c[:, d] - hi[d]) < tol)[0].astype(np.int32)
        disc.node_sets[nm_lo] = lo_ids
        disc.node_sets[nm_hi] = hi_ids
        for nm, ids in [(nm_lo, lo_ids), (nm_hi, hi_ids)]:
            ids_sorted = ids[np.argsort(c[ids, 1 - d])]
            disc.face_sets[nm] = [FaceBlock("line2", np.stack(
                [ids_sorted[:-1], ids_sorted[1:]], axis=1).astype(np.int32))]
    disc.node_sets["all"] = np.arange(disc.n_nodes, dtype=np.int32)
