"""Point Jacobi preconditioner (counterpart of fourc_tpu/linalg/precond.py:
jacobi)."""

from __future__ import annotations

import torch


def jacobi(diag: torch.Tensor, eps=1e-30):
    """M^-1 = diag^-1 (entries with |diag| <= eps pass through)."""
    inv = 1.0 / torch.where(diag.abs() > eps, diag, 1.0)

    def M(r):
        return inv * r

    return M
