"""Discretization: mesh arrays, node/face sets and the structured dof map.

Counterpart of fourc_tpu/core/mesh.py for the lattice slices.  A mesh is a
set of numpy arrays grouped by cell type.  Only structured blocks (the
canonical lexicographic hex8 lattice that ``gridgen.box`` writes) get a dof
map.  A block is structured by provenance (``structured_shape``) or, without
it, when its connectivity alone is the canonical lattice; node coordinates
play no part, so a jittered box keeps its lattice.  General gather/scatter
assembly belongs to a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

HEX8_OFFSETS = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))


@dataclass
class ElementBlock:
    """All elements of one cell type."""

    cell: str
    conn: np.ndarray  # (n_ele, nen) int32 global node ids
    mat_id: np.ndarray | None = None  # (n_ele,) deck material numbers

    def __post_init__(self):
        self.conn = np.asarray(self.conn, dtype=np.int32)
        n = self.conn.shape[0]
        mid = 0 if self.mat_id is None else self.mat_id
        self.mat_id = np.broadcast_to(np.asarray(mid, np.int32), (n,)).copy()


@dataclass
class FaceBlock:
    """Surface elements of one face cell type (Neumann faces)."""

    cell: str
    conn: np.ndarray  # (n_face, nen_face) int32 global node ids

    def __post_init__(self):
        self.conn = np.asarray(self.conn, dtype=np.int32)


@dataclass
class Discretization:
    """A named mesh: coordinates, element blocks, node and face sets.

    ``structured_shape`` is ``(nx, ny, nz, order)`` when the mesh came from
    the box generator, else None.
    """

    name: str
    coords: np.ndarray  # (n_nodes, dim) float64
    blocks: dict[str, ElementBlock] = field(default_factory=dict)
    node_sets: dict[str, np.ndarray] = field(default_factory=dict)
    face_sets: dict[str, list[FaceBlock]] = field(default_factory=dict)
    structured_shape: tuple | None = None

    def __post_init__(self):
        self.coords = np.asarray(self.coords, dtype=np.float64)

    @property
    def dim(self):
        return self.coords.shape[1]

    @property
    def n_nodes(self):
        return self.coords.shape[0]

    def dofmap(self, ndpn: int) -> "DofMap":
        return DofMap.build(self, ndpn)


def lattice_conn(nx, ny, nz):
    """Canonical hex8 connectivity of an nx*ny*nz lattice, element (i,j,k)
    at row (i*ny + j)*nz + k, node (i,j,k) at id (i*py + j)*pz + k."""
    py, pz = ny + 1, nz + 1
    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    return np.stack([((ii + di) * py + (jj + dj)) * pz + (kk + dk)
                     for di, dj, dk in HEX8_OFFSETS],
                    axis=-1).reshape(-1, 8).astype(np.int32)


def _lattice_meta(nx, ny, nz):
    return {"shape": (nx, ny, nz), "pshape": (nx + 1, ny + 1, nz + 1),
            "offsets": HEX8_OFFSETS}


def _detect_structured(disc: Discretization, blk: ElementBlock):
    """Lattice metadata of a structured hex8 block, or None."""
    if blk.cell != "hex8":
        return None
    ss = disc.structured_shape
    if ss is None:
        return _detect_conn_lattice(disc, blk)
    if len(ss) != 4 or ss[3] != 1:
        return None
    nx, ny, nz, _ = ss
    if blk.conn.shape != (nx * ny * nz, 8):
        return None
    if not np.array_equal(blk.conn, lattice_conn(nx, ny, nz)):
        return None
    return _lattice_meta(nx, ny, nz)


def _detect_conn_lattice(disc: Discretization, blk: ElementBlock):
    """The canonical hex8 lattice recovered from connectivity alone, or None.

    With node ids ``(i*py + j)*pz + k`` the local-node offsets are the same
    in every element: pz = conn[:, 3] - conn[:, 0] and
    py*pz = conn[:, 1] - conn[:, 0].  Solve for (px, py, pz), then require
    conn to equal the canonical enumeration exactly.
    """
    conn = blk.conn
    if conn.shape[0] < 2 or conn.shape[1] != 8:
        return None
    off = conn - conn[:, :1]
    if not (off == off[0]).all():
        return None
    pz, pypz = int(off[0, 3]), int(off[0, 1])
    if pz <= 1 or pypz <= pz or pypz % pz:
        return None
    py = pypz // pz
    if disc.n_nodes % pypz or int(conn.max()) + 1 != disc.n_nodes:
        return None
    nx, ny, nz = disc.n_nodes // pypz - 1, py - 1, pz - 1
    if nx < 1 or conn.shape[0] != nx * ny * nz:
        return None
    if not np.array_equal(conn, lattice_conn(nx, ny, nz)):
        return None
    return _lattice_meta(nx, ny, nz)


@dataclass
class BlockAssembly:
    cell: str
    structured: dict  # shape, pshape, offsets of the lattice


@dataclass
class DofMap:
    """Dof layout ``dof = node * ndpn + component`` for structured blocks."""

    ndpn: int
    ndof: int
    blocks: dict[str, BlockAssembly]

    @staticmethod
    def build(disc: Discretization, ndpn: int) -> "DofMap":
        out = {}
        for key, blk in disc.blocks.items():
            st = _detect_structured(disc, blk)
            if st is None:
                raise NotImplementedError(
                    f"block {key!r} is not a structured hex8 lattice; "
                    "unstructured assembly is not ported yet")
            out[key] = BlockAssembly(cell=blk.cell, structured=st)
        return DofMap(ndpn=ndpn, ndof=disc.n_nodes * ndpn, blocks=out)
