"""Smoothed-aggregation algebraic multigrid (meshes of general topology).

Counterpart of fourc_tpu/linalg/amg.py, the preconditioner for meshes where
the geometric hierarchy (linalg/gmg.py) finds no lattice.

Setup happens once on the host (scipy.sparse, float64), step by step as in
the reference, so that both build the same hierarchy: greedy aggregation of
NODES on the strength graph (all dofs of a node share its aggregate),
tentative prolongator from the translational nullspace, one Jacobi
smoothing pass P = (I - omega D^-1 A) P0, Galerkin coarse operators
A_c = P^T A P.  Coarsening stops at ``coarsest`` dofs, at ``max_levels``, or
when an aggregation stalls (more aggregates than half the nodes); the last
level is solved with a dense inverse, formed in float64 by
``torch.linalg.inv`` on the hierarchy's device (on a CUDA device a matrix of
a few 10^4 rows takes seconds there and minutes in numpy).  ``timings``
holds the seconds of each setup stage.

The V-cycle runs on the device in the hierarchy's dtype (the reference
keeps its tables in float32 even in float64 runs): every level's operator
and transfer is a node-block ELL apply (a node gather and one batched
small-matrix product, ``torch.bmm``), smoothers are Chebyshev on the
Jacobi-scaled operator.  Krylov sees this operator, so it must be linear in full float32:
with TF32 matrix products enabled the V-cycle refuses to run.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np
import torch

from fourc_tpu_torch.core.device import resolve_device


class _BlockELL:
    """Node-block padded-row (ELL) sparse operator with a gather-only
    matvec: per row node a fixed-width table of neighbour nodes ``nbr``
    (nr, k) and dense blocks ``blk`` (nr, k, ndpn, ndpn).  Padding slots
    point at column 0 with zero blocks.  The blocks are stored as one
    (ndpn, k*ndpn) matrix per row node, the layout the batched product
    reads without a copy."""

    def __init__(self, nbr, blk, n_cols, device, dtype):
        nr, k, d, _ = blk.shape
        self.ndpn = int(d)
        self.n_cols = int(n_cols)
        # int64: torch indexing takes that
        self.nbr = torch.tensor(np.asarray(nbr), dtype=torch.int64,
                                device=device)
        rows = np.asarray(blk).transpose(0, 2, 1, 3).reshape(nr, d, k * d)
        self._rows = torch.tensor(rows, dtype=dtype, device=device)

    @property
    def blk(self):
        """The blocks as (nr, k, ndpn, ndpn), a view."""
        nr, d = self._rows.shape[:2]
        return self._rows.reshape(nr, d, -1, d).permute(0, 2, 1, 3)

    @classmethod
    def from_csr(cls, A_csr, ndpn, shape_nodes, device, dtype):
        nr, nc = shape_nodes
        coo = A_csr.tocoo()
        rn = (coo.row // ndpn).astype(np.int64)
        cn = (coo.col // ndpn).astype(np.int64)
        keys = rn * nc + cn
        pairs = np.unique(keys)
        prow = pairs // nc
        pcol = (pairs % nc).astype(np.int32)
        counts = np.bincount(prow, minlength=nr)
        k = max(int(counts.max()) if pairs.size else 1, 1)
        starts = np.zeros(nr + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        slot_of_pair = np.arange(pairs.size) - starts[prow]
        nbr = np.zeros((nr, k), np.int32)
        nbr[prow, slot_of_pair] = pcol
        blk = np.zeros((nr, k, ndpn, ndpn), np.float64)
        pid = np.searchsorted(pairs, keys)
        blk[rn, slot_of_pair[pid], coo.row % ndpn, coo.col % ndpn] = coo.data
        return cls(nbr, blk, nc, device, dtype)

    @property
    def width(self):
        return int(self.nbr.shape[1])

    def mv(self, x):
        xg = x.reshape(self.n_cols, self.ndpn)[self.nbr]  # (nr, k, d)
        y = torch.bmm(self._rows, xg.reshape(xg.shape[0], -1, 1))
        return y.reshape(-1)


def _aggregate(A_node, theta=0.08):
    """Vanek-style greedy aggregation of the node graph (scipy csr).

    Phase 1 seeds an aggregate at every node with no aggregated strong
    neighbour (root + its unaggregated strong neighbours); phase 2 attaches
    leftovers to the aggregated neighbour with the largest |a_ij| (the first
    of equals).  Strength is row-relative: |a_ij| >= theta * max_k |a_ik|
    over the row's off-diagonals.  Returns (aggregate id per node, count).
    The reference's loop with each row's tests done by numpy; the nodes are
    visited in the same order, so the aggregates are the same."""
    n = A_node.shape[0]
    A = A_node.tocsr()
    indptr, indices, absdata = A.indptr, A.indices, np.abs(A.data)
    agg = -np.ones(n, np.int64)
    next_agg = 0
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        vals = absdata[indptr[i]:indptr[i + 1]]
        off = nbrs != i
        thr = theta * vals[off].max(initial=0.0)
        strong = nbrs[off & (vals >= thr) & (vals > 0.0)]
        if (agg[strong] < 0).all():
            agg[i] = next_agg
            agg[strong] = next_agg
            next_agg += 1
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        vals = absdata[indptr[i]:indptr[i + 1]]
        cand = (nbrs != i) & (agg[nbrs] >= 0) & (vals > 0.0)
        if cand.any():
            agg[i] = agg[nbrs[cand][np.argmax(vals[cand])]]
        else:
            agg[i] = next_agg
            next_agg += 1
    return agg, next_agg


def _dense_inverse(A, device, dtype):
    """Inverse of a dense float64 matrix, formed on ``device``, kept in
    ``dtype``."""
    if device.type == "cpu":
        return torch.as_tensor(np.linalg.inv(A)).to(dtype)
    return torch.linalg.inv(torch.as_tensor(A, device=device)).to(dtype)


class SmoothedAggregationAMG:
    """V-cycle preconditioner r -> z on flat dof vectors, from an assembled
    scipy sparse matrix whose constrained dofs carry unit rows and columns."""

    def __init__(self, A_sparse, ndpn, omega=0.6, coarsest=400, max_levels=10,
                 cheby_degree=3, device="cuda", dtype=torch.float32):
        import scipy.sparse as sp

        self.device = device = resolve_device(device)
        self.dtype = dtype
        self.ndpn = ndpn
        self.cheby_degree = cheby_degree
        self.levels = []  # dicts: A, P, R (_BlockELL or None), dinv, lmax
        self.timings = {}
        A = A_sparse.tocsr().astype(np.float64)
        while True:
            d = np.asarray(A.diagonal())
            dinv = np.where(np.abs(d) > 1e-300, 1.0 / d, 1.0)
            lmax = float((np.abs(dinv) * np.asarray(
                abs(A).sum(axis=1)).ravel()).max())
            nn = A.shape[0] // ndpn
            with self._stage("ell_tables"):
                lev = {"A": _BlockELL.from_csr(A, ndpn, (nn, nn), device,
                                               dtype),
                       "dinv": torch.as_tensor(dinv, dtype=dtype,
                                               device=device),
                       "lmax": 1.02 * lmax, "P": None, "R": None}
            self.levels.append(lev)
            if nn <= coarsest // ndpn or len(self.levels) >= max_levels:
                break
            with self._stage("aggregation"):
                # node-level strength graph: sum |A_ij| over the dof block
                Ab = abs(A).tocsr()
                rows = np.repeat(np.arange(A.shape[0]) // ndpn,
                                 np.diff(Ab.indptr))
                G = sp.coo_matrix((Ab.data, (rows, Ab.indices // ndpn)),
                                  shape=(nn, nn)).tocsr()
                agg, n_agg = _aggregate(G)
            if n_agg > nn // 2:  # stalled coarsening: stop the hierarchy
                break
            with self._stage("galerkin"):
                # tentative prolongator: per-dof-component injection, then
                # one smoothing pass P = (I - omega D^-1 A) P0
                ridx = np.arange(A.shape[0])
                cidx = agg[ridx // ndpn] * ndpn + (ridx % ndpn)
                P0 = sp.coo_matrix((np.ones(A.shape[0]), (ridx, cidx)),
                                   shape=(A.shape[0], n_agg * ndpn)).tocsr()
                P = (P0 - omega * (sp.diags(dinv) @ (A @ P0))).tocsr()
                A_c = (P.T @ A @ P).tocsr()
            with self._stage("ell_tables"):
                lev["P"] = _BlockELL.from_csr(P, ndpn, (nn, n_agg), device,
                                              dtype)
                # restriction as its own ELL operator: a gather-only
                # transpose apply
                lev["R"] = _BlockELL.from_csr(P.T.tocsr(), ndpn, (n_agg, nn),
                                              device, dtype)
            A = A_c
        with self._stage("coarse_inverse"):
            self._coarse_inv = _dense_inverse(A.toarray(), device, dtype)
            if device.type == "cuda":
                torch.cuda.synchronize(device)

    @contextmanager
    def _stage(self, name):
        t0 = time.perf_counter()
        yield
        self.timings[name] = (self.timings.get(name, 0.0)
                              + time.perf_counter() - t0)

    def describe(self):
        """Per level: nodes and the ELL widths of A, P, R; the size of the
        dense coarse factor."""
        return {"levels": [{"nodes": int(lev["A"].nbr.shape[0]),
                            **{nm: lev[nm].width for nm in ("A", "P", "R")
                               if lev[nm] is not None}}
                           for lev in self.levels],
                "coarse_dofs": int(self._coarse_inv.shape[0]),
                "coarse_bytes": (self._coarse_inv.numel()
                                 * self._coarse_inv.element_size())}

    def _smooth0(self, lev, b, return_res=False):
        """Chebyshev(degree) on D^-1 A from x = 0.  With ``return_res`` also
        the true residual b - A x, reusing the smoother's own matvecs."""
        lmax, dinv, A = lev["lmax"], lev["dinv"], lev["A"]
        lmin = lmax / 30.0
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        rho_old = 1.0 / sigma
        r = dinv * b
        d = r / theta
        x = d
        rt = b
        for _ in range(self.cheby_degree - 1):
            t = A.mv(d)
            if return_res:
                rt = rt - t
            rho = 1.0 / (2.0 * sigma - rho_old)
            r = r - dinv * t
            d = rho * rho_old * d + (2.0 * rho / delta) * r
            x = x + d
            rho_old = rho
        if return_res:
            return x, rt - A.mv(d)
        return x

    def _vcycle(self, k, r):
        lev = self.levels[k]
        if lev["P"] is None:
            return self._coarse_inv @ r
        x, res = self._smooth0(lev, r, return_res=True)
        xc = self._vcycle(k + 1, lev["R"].mv(res))
        x = x + lev["P"].mv(xc)
        return x + self._smooth0(lev, r - lev["A"].mv(x))

    def __call__(self, r):
        if r.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "TF32 matrix products are on (torch.backends.cuda.matmul."
                "allow_tf32): the V-cycle would not be a linear operator in "
                "float32, which breaks Krylov solvers")
        return self._vcycle(0, r.to(self.dtype)).to(r.dtype)


# -- persistence: the hierarchy is deterministic in the mesh, the materials
# and the mass shift, so a run can store it and a later one load it ---------


def amg_data(M: SmoothedAggregationAMG) -> dict:
    """The V-cycle's data (ELL levels and coarse factor) as numpy arrays,
    under the keys of the reference's npz files."""
    data = {"n_levels": np.asarray(len(M.levels)),
            "coarse_inv": M._coarse_inv.cpu().numpy(),
            "cheby_degree": np.asarray(M.cheby_degree),
            "ndpn": np.asarray(M.ndpn)}
    for i, lev in enumerate(M.levels):
        data[f"l{i}_dinv"] = lev["dinv"].cpu().numpy()
        data[f"l{i}_lmax"] = np.asarray(lev["lmax"])
        for nm in ("A", "P", "R"):
            op = lev[nm]
            if op is None:
                continue
            data[f"l{i}_{nm}_nbr"] = op.nbr.cpu().numpy().astype(np.int32)
            data[f"l{i}_{nm}_blk"] = op.blk.cpu().numpy()
            data[f"l{i}_{nm}_ncols"] = np.asarray(op.n_cols)
    return data


def amg_from_data(z, device="cuda", dtype=torch.float32):
    """A ready SmoothedAggregationAMG from ``amg_data``'s arrays (or a
    loaded npz, or the reference's hierarchy through convert.amg_from_jax)."""
    device = resolve_device(device)
    M = SmoothedAggregationAMG.__new__(SmoothedAggregationAMG)
    M.device, M.dtype = device, dtype
    M.ndpn = int(z["ndpn"])
    M.cheby_degree = int(z["cheby_degree"])
    M.timings = {}
    M._coarse_inv = torch.tensor(np.asarray(z["coarse_inv"]), dtype=dtype,
                                 device=device)
    M.levels = []
    for i in range(int(z["n_levels"])):
        lev = {"dinv": torch.tensor(np.asarray(z[f"l{i}_dinv"]), dtype=dtype,
                                    device=device),
               "lmax": float(z[f"l{i}_lmax"]), "A": None, "P": None,
               "R": None}
        for nm in ("A", "P", "R"):
            if f"l{i}_{nm}_nbr" in z:
                lev[nm] = _BlockELL(z[f"l{i}_{nm}_nbr"], z[f"l{i}_{nm}_blk"],
                                    int(z[f"l{i}_{nm}_ncols"]), device, dtype)
        M.levels.append(lev)
    return M


def save_amg(M: SmoothedAggregationAMG, path):
    """Serialize the V-cycle data to a compressed npz."""
    np.savez_compressed(path, **amg_data(M))


def load_amg(path, device="cuda", dtype=torch.float32):
    """Inverse of save_amg."""
    with np.load(path) as z:
        return amg_from_data(z, device, dtype)
