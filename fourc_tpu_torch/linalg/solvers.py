"""Krylov solvers (CG, GMRES, BiCGStab) and the dense direct solve.

Counterpart of fourc_tpu/linalg/solvers.py.  Operators are callables
v -> A v on tensors of any shape (flat dof vectors or padded lattices).
The loops run on the host and read one small result per iteration: ||r||
in CG and BiCGStab, the new Hessenberg column in GMRES (whose Givens
rotations and back substitution, a few dozen numbers, are done on the host
in float64).  One device sync per iteration, which a device-side test or a
CUDA graph would remove.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
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


def gmres(A, b, x0=None, M=None, tol=1e-8, atol=0.0, restart=30,
          maxiter=1000):
    """Restarted GMRES(m), right-preconditioned, with the reference's
    semantics: classical Gram-Schmidt with a second full pass, Givens
    rotations, the breakdown threshold sqrt(finfo.tiny) and the stop rule
    |g[j+1]| <= max(tol * ||b||, atol) tested after every Arnoldi step;
    ``maxiter`` is tested only between restarts (a cycle may pass it);
    ``iters`` is the sum of the Arnoldi steps of every cycle and
    ``resnorm`` the Givens estimate |g[jdone]| of the last cycle.  The
    basis V (m+1 vectors of b's size) stays on b's device; its products
    run in b's dtype at full precision (TF32 stays off)."""
    M = M or (lambda v: v)
    shape, dtype = b.shape, b.dtype
    b = b.reshape(-1)
    m = int(restart)
    x = torch.zeros_like(b) if x0 is None else x0.reshape(-1).clone()
    tiny = float(np.sqrt(torch.finfo(dtype).tiny))
    stop = max(tol * float(torch.linalg.vector_norm(b)), atol)

    def op(v):
        return A(v.reshape(shape)).reshape(-1)

    def prec(v):
        return M(v.reshape(shape)).reshape(-1)

    def cycle(x):
        r = b - op(x)
        beta = float(torch.linalg.vector_norm(r))
        V = b.new_zeros((m + 1, b.numel()))
        V[0] = r / max(beta, tiny)
        H = np.zeros((m + 1, m))
        cs, sn = np.zeros(m), np.zeros(m)
        g = np.zeros(m + 1)
        g[0] = beta
        jdone = 0
        for j in range(m):
            w = op(prec(V[j]))
            Vj = V[:j + 1]
            hcol = torch.mv(Vj, w)
            w = w - torch.mv(Vj.T, hcol)
            corr = torch.mv(Vj, w)
            w = w - torch.mv(Vj.T, corr)
            hj1 = torch.linalg.vector_norm(w)
            V[j + 1] = w / torch.clamp(hj1, min=tiny)
            col = torch.cat([hcol + corr, hj1.reshape(1)]).cpu().double()
            hc = np.zeros(m + 1)
            hc[:j + 2] = col.numpy()
            breakdown = hc[j + 1] <= tiny
            for i in range(j):  # the accumulated rotations
                hc[i], hc[i + 1] = (cs[i] * hc[i] + sn[i] * hc[i + 1],
                                    -sn[i] * hc[i] + cs[i] * hc[i + 1])
            denom = math.sqrt(hc[j] ** 2 + hc[j + 1] ** 2)
            c = hc[j] / max(denom, tiny) if denom > tiny else 1.0
            s = hc[j + 1] / max(denom, tiny) if denom > tiny else 0.0
            hc[j], hc[j + 1] = denom, 0.0
            cs[j], sn[j] = c, s
            g[j], g[j + 1] = c * g[j], -s * g[j]
            H[:, j] = hc
            jdone = j + 1
            if abs(g[j + 1]) <= stop or breakdown:
                break
        y = np.zeros(0)
        if jdone:  # back substitution on the upper-triangular H
            y = _solve_upper(H[:jdone, :jdone], g[:jdone])
        corr = torch.mv(V[:jdone].T, torch.as_tensor(y, dtype=dtype,
                                                      device=b.device))
        return x + prec(corr), abs(g[jdone]), jdone

    res = float(torch.linalg.vector_norm(b - op(x)))
    k = 0
    while k < maxiter and res > stop:
        x, res, jdone = cycle(x)
        k += jdone
    return KrylovResult(x=x.reshape(shape), iters=k, resnorm=res,
                        converged=res <= stop)


def _solve_upper(R, y):
    """Back substitution R x = y, R upper triangular (float64, host)."""
    n = y.shape[0]
    x = np.zeros(n)
    for i in range(n - 1, -1, -1):
        x[i] = (y[i] - R[i, i + 1:] @ x[i + 1:]) / R[i, i]
    return x


def bicgstab(A, b, x0=None, M=None, tol=1e-8, atol=0.0, maxiter=1000):
    """BiCGStab, right-preconditioned, for nonsymmetric systems: the
    reference's recurrences with its guards (a zero rho, omega or
    rhat . v divides by 1 instead; t . t == 0 gives omega 0) and its
    zero-start shortcut r0 = b."""
    M = M or (lambda v: v)
    if x0 is None:
        x = torch.zeros_like(b)
        r = b.clone()
    else:
        x = x0.clone()
        r = b - A(x0)
    rhat = r.clone()
    p, v = torch.zeros_like(b), torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho = alpha = omega = one
    stop = max(tol * float(torch.linalg.vector_norm(b)), atol)

    def guard(a):
        return torch.where(a == 0, one, a)

    k = 0
    rn = float(torch.linalg.vector_norm(r))
    while k < maxiter and rn > stop:
        rho_new = _dot(rhat, r)
        beta = (rho_new / guard(rho)) * (alpha / guard(omega))
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = A(phat)
        alpha = rho_new / guard(_dot(rhat, v))
        h = x + alpha * phat
        s = r - alpha * v
        shat = M(s)
        t = A(shat)
        tt = _dot(t, t)
        omega = torch.where(tt == 0, 0.0, _dot(t, s) / guard(tt))
        x = h + omega * shat
        r = s - omega * t
        rho = rho_new
        k += 1
        rn = float(torch.linalg.vector_norm(r))
    return KrylovResult(x=x, iters=k, resnorm=rn, converged=rn <= stop)


def direct(A, b, batched=False, **_):
    """Dense direct solve (LU with partial pivoting), for small systems: the
    operator is densified by probing with the identity's columns, then
    solved with ``torch.linalg.solve`` on the host (LAPACK), whatever the
    device: a card's LU rounds otherwise than the CPU's, and a Newton loop
    that stops at its tolerance (the plasticity decks converge linearly
    there) carries that rounding into the answer at the tolerance's size;
    solved alike, the card's run rounds as the CPU's.  With ``batched`` (an
    operator of plain PyTorch, which ``torch.func.vmap`` can batch: every
    operator on the CPU, where the kernels' twins run) the n probes go
    through it at once, as the reference vmaps them; else (a kernel wrapper
    takes no batch) one application each.  Returns iters = 1, as the
    reference does."""
    n = b.numel()
    eye = torch.eye(n, dtype=b.dtype, device=b.device)
    if batched:
        Ad = torch.func.vmap(lambda e: A(e.reshape(b.shape)).reshape(-1))(
            eye).T
    else:
        Ad = torch.stack([A(eye[k].reshape(b.shape)).reshape(-1)
                          for k in range(n)], dim=1)
    x = torch.linalg.solve(Ad.cpu(), b.reshape(-1).cpu()).to(b.device)
    rn = float(torch.linalg.vector_norm(b.reshape(-1) - Ad @ x))
    return KrylovResult(x=x.reshape(b.shape), iters=1, resnorm=rn,
                        converged=True)


SOLVERS = {"cg": cg, "gmres": gmres, "bicgstab": bicgstab, "direct": direct}


def solve(method: str, A, b, **kw) -> KrylovResult:
    """The solver named by a deck's ``solver.method``."""
    return SOLVERS[method.lower()](A, b, **kw)
