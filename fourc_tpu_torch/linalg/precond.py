"""Point and nodal-block Jacobi preconditioners (counterpart of
fourc_tpu/linalg/precond.py: jacobi, block_jacobi)."""

from __future__ import annotations

import torch

from fourc_tpu_torch.ops import common as gm


def jacobi(diag: torch.Tensor, eps=1e-30):
    """M^-1 = diag^-1 (entries with |diag| <= eps pass through)."""
    inv = 1.0 / torch.where(diag.abs() > eps, diag, 1.0)

    def M(r):
        return inv * r

    return M


def block_jacobi(blocks: torch.Tensor):
    """Nodal-block Jacobi: blocks (n_nodes, 3, 3) -> M(r) on flat dof
    vectors r (n_nodes * 3,), each node's 3 dofs through the inverse of its
    block (by the adjugate, as the reference's ``gm.inv3``)."""
    inv = gm.inv3l(blocks.permute(1, 2, 0))  # (3, 3, n_nodes)

    def M(r):
        rn = r.reshape(-1, 3).T  # (3, n_nodes)
        out = inv[:, 0] * rn[0] + inv[:, 1] * rn[1] + inv[:, 2] * rn[2]
        return out.T.reshape(-1)  # summed in order: alike on any device

    return M
