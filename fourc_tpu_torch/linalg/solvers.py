"""Preconditioned conjugate gradients and the dense direct solve.

Counterpart of fourc_tpu/linalg/solvers.py:cg and :direct.  Operators are
callables v -> A v on tensors of any shape (flat dof vectors or padded
lattices).  The CG loop runs on the host and reads ||r|| once per
iteration to test convergence: one device sync per iteration, which a
device-side test or a CUDA graph would remove.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class KrylovResult:
    x: torch.Tensor
    iters: int
    resnorm: float
    converged: bool


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def cg(A, b, x0=None, M=None, tol=1e-8, atol=0.0, maxiter=1000):
    """Stops when ||r|| <= max(tol * ||b||, atol) or after maxiter
    iterations (the reference's rule)."""
    M = M or (lambda v: v)
    if x0 is None:
        x = torch.zeros_like(b)
        r = b.clone()
    else:
        x = x0.clone()
        r = b - A(x0)
    z = M(r)
    p = z.clone()
    rz = _dot(r, z)
    stop = max(tol * float(torch.linalg.vector_norm(b)), atol)
    k = 0
    rn = float(torch.linalg.vector_norm(r))
    while k < maxiter and rn > stop:
        Ap = A(p)
        pAp = _dot(p, Ap)
        alpha = rz / torch.where(pAp == 0, 1.0, pAp)
        x.add_(alpha * p)
        r.sub_(alpha * Ap)
        z = M(r)
        rz_new = _dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
        rn = float(torch.linalg.vector_norm(r))
    return KrylovResult(x=x, iters=k, resnorm=rn, converged=rn <= stop)


def direct(A, b, **_):
    """Dense direct solve (LU with partial pivoting), for small systems: the
    operator is densified by probing with the identity's columns (n
    operator applications), then solved with ``torch.linalg.solve``.
    Returns iters = 1, as the reference does."""
    n = b.numel()
    eye = torch.eye(n, dtype=b.dtype, device=b.device)
    Ad = torch.stack([A(eye[k].reshape(b.shape)).reshape(-1)
                      for k in range(n)], dim=1)
    x = torch.linalg.solve(Ad, b.reshape(-1))
    rn = float(torch.linalg.vector_norm(b.reshape(-1) - Ad @ x))
    return KrylovResult(x=x.reshape(b.shape), iters=1, resnorm=rn,
                        converged=True)
