"""Discretization: mesh arrays, node/face sets and the dof map.

Counterpart of fourc_tpu/core/mesh.py.  A mesh is a set of numpy arrays
grouped by cell type.  A block is structured (the canonical lexicographic
hex8 lattice that ``gridgen.box`` writes) by provenance
(``structured_shape``) or, without it, when its connectivity alone is the
canonical lattice; node coordinates play no part, so a jittered box keeps
its lattice.  Any other block has general topology: its dof map gathers
element values through the connectivity and assembles element vectors
through a node-incidence table, a gather and a sum over a small axis, with
no atomics, so that sums are deterministic (the reference's form; its
sorted ``segment_sum`` route is not ported).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

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

    @property
    def n_ele(self):
        return self.conn.shape[0]


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

    @property
    def n_elements(self):
        return sum(b.n_ele for b in self.blocks.values())

    def add_block(self, cell: str, conn, mat_id=None, key: str | None = None):
        """Add elements of one cell type under ``key`` (default: the cell
        name), appended to the block already stored under that key."""
        key = key or cell
        if key in self.blocks:
            old = self.blocks[key]
            conn = np.concatenate([old.conn, np.asarray(conn, np.int32)],
                                  axis=0)
            mat = np.concatenate([old.mat_id, np.broadcast_to(
                np.asarray(mat_id or 0, np.int32),
                (len(conn) - old.n_ele,))])
            self.blocks[key] = ElementBlock(cell, conn, mat)
        else:
            self.blocks[key] = ElementBlock(cell, conn, mat_id)

    def dofmap(self, ndpn: int, lattice: bool = True) -> "DofMap":
        return DofMap.build(self, ndpn, lattice)


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
    """Assembly data of one element block.  ``structured`` holds shape,
    pshape and offsets of a lattice block, None for general topology.

    ``inc_clip`` (n_nodes, kmax) lists, per node, the rows ``e * nen + a``
    of the elements' node contributions that belong to it; ``inc_w`` is 1 for
    a real slot and 0 for the padding of nodes with fewer than kmax elements
    (padding indices are clipped to 0).  Both are None on a structured block.
    """

    cell: str
    structured: dict | None
    conn: np.ndarray  # (n_ele, nen) int32
    inc_clip: np.ndarray | None = None  # (n_nodes, kmax) int32
    inc_w: np.ndarray | None = None  # (n_nodes, kmax) float32 0/1
    _tables: dict = field(default_factory=dict, repr=False)

    def tables(self, ndpn: int, device):
        """Index tensors for the element-batch layout (nen*ndpn, E), row
        a*ndpn+i, on ``device``, int64 because torch indexing takes that:
        edof (nen*ndpn, E), the global dof of each entry; inc
        (n_nodes, kmax, ndpn), for each dof and slot the flat index of its
        contribution in a (nen*ndpn, E) array; w (n_nodes, kmax, 1) bool,
        False on padding slots.  Made once per device."""
        key = (ndpn, str(device))
        if key not in self._tables:
            self._tables[key] = self._make_tables(ndpn, device)
        return self._tables[key]

    def _make_tables(self, ndpn, device):
        E, nen = self.conn.shape
        conn = torch.as_tensor(self.conn, dtype=torch.int64, device=device)
        comp = torch.arange(ndpn, device=device)
        edof = (conn.T[:, None, :] * ndpn + comp[None, :, None]).reshape(
            nen * ndpn, E)
        row = torch.as_tensor(self.inc_clip, dtype=torch.int64, device=device)
        e, a = row // nen, row % nen
        inc = ((a * ndpn)[..., None] + comp) * E + e[..., None]
        w = torch.as_tensor(self.inc_w > 0, device=device)[..., None]
        return edof.contiguous(), inc.contiguous(), w


def _incidence(conn: np.ndarray, n_nodes: int):
    """Node-incidence gather table of a connectivity: (inc_clip, inc_w)."""
    flat_nodes = conn.reshape(-1).astype(np.int64)
    counts = np.bincount(flat_nodes, minlength=n_nodes)
    kmax = max(int(counts.max()) if counts.size else 1, 1)
    starts = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    order = np.argsort(flat_nodes, kind="stable")
    nodes_sorted = flat_nodes[order]
    slots = np.arange(flat_nodes.size) - starts[nodes_sorted]
    pad = flat_nodes.size
    inc = np.full((n_nodes, kmax), pad, np.int32)
    inc[nodes_sorted, slots] = order.astype(np.int32)
    return (np.where(inc == pad, 0, inc).astype(np.int32),
            (inc != pad).astype(np.float32))


@dataclass
class DofMap:
    """Dof layout ``dof = node * ndpn + component`` and, for blocks of
    general topology, gather and deterministic assembly in the element-batch
    layout (nen*ndpn, E): row a*ndpn+i is component i of local node a, one
    column per element (what the element kernels take and return)."""

    ndpn: int
    ndof: int
    blocks: dict[str, BlockAssembly]

    @staticmethod
    def build(disc: Discretization, ndpn: int,
              lattice: bool = True) -> "DofMap":
        """With ``lattice`` False every block takes the general-topology
        layout, lattice blocks too."""
        out = {}
        for key, blk in disc.blocks.items():
            st = _detect_structured(disc, blk) if lattice else None
            inc_clip = inc_w = None
            if st is None:
                inc_clip, inc_w = _incidence(blk.conn, disc.n_nodes)
            out[key] = BlockAssembly(cell=blk.cell, structured=st,
                                     conn=blk.conn, inc_clip=inc_clip,
                                     inc_w=inc_w)
        return DofMap(ndpn=ndpn, ndof=disc.n_nodes * ndpn, blocks=out)

    def _general(self, key) -> BlockAssembly:
        ba = self.blocks[key]
        if ba.structured is not None:
            raise ValueError(f"block {key!r} is a lattice: its operators "
                             "work on the lattice layout (ops/lattice.py)")
        return ba

    def gather(self, u: torch.Tensor, key: str) -> torch.Tensor:
        """Global dof vector -> element values (nen*ndpn, E)."""
        edof, _, _ = self._general(key).tables(self.ndpn, u.device)
        return u[edof]

    def scatter_add(self, per_block: dict) -> torch.Tensor:
        """Sum element vectors, per_block[key] (nen*ndpn, E), into a global
        dof vector: each dof gathers its contributions and adds them in slot
        order, one slot after the other, so that every device rounds alike
        (a reduction kernel sums in its own order)."""
        total = None
        for key, fe in per_block.items():
            _, inc, w = self._general(key).tables(self.ndpn, fe.device)
            contrib = torch.where(w, fe.reshape(-1)[inc], 0.0)
            part = contrib[:, 0]
            for s in range(1, contrib.shape[1]):
                part = part + contrib[:, s]
            part = part.reshape(-1)
            total = part if total is None else total + part
        return total
