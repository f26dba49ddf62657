"""Krylov solvers (CG, GMRES, BiCGStab) and the dense direct solve.

Counterpart of fourc_tpu/linalg/solvers.py.  Operators are callables
v -> A v on tensors of any shape (flat dof vectors or padded lattices).
The loops run on the host and read one small result per iteration: ||r||
in CG and BiCGStab, the new Hessenberg column in GMRES (whose Givens
rotations and back substitution, a few dozen numbers, are done on the host
in float64).  One device sync per iteration, which a device-side test or a
CUDA graph would remove.

GMRES sums its inner products and norms with ``tree_sum`` (elementwise
additions in a fixed pairwise order) instead of a reduction kernel or a
BLAS call, whose order differs between a card and the CPU: the card's
iterates are then the CPU's, bit for bit, where the operator and the
preconditioner round alike (the history decks, whose Newton loops carry a
rounding difference of the Krylov solve into the answer at 5e-11).  On
the card its log2 n launches per sum cost no step time that the host's
spread lets one see (``tools/gmres_sums.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from fourc_tpu_torch.ops.common import sqrt_rn


@dataclass
class KrylovResult:
    x: torch.Tensor
    iters: int
    resnorm: float
    converged: bool


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def tree_sum(x, dim=-1):
    """The sum of x over ``dim``, added pairwise in a fixed order (x padded
    with zeros to a power of two, then halved log2 n times): the same bits
    on every device, at most log2(n) roundings deep."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    size = 1 << max(n - 1, 0).bit_length()
    if size != n:
        x = torch.cat([x, x.new_zeros((size - n,) + x.shape[1:])])
    while size > 1:
        size //= 2
        x = x[:size] + x[size:]
    return x[0]


def norm_rn(x):
    """||x||_2 by ``tree_sum`` and the correctly rounded square root: the
    same bits on every device."""
    x = x.reshape(-1)
    ss = tree_sum(x * x)
    pos = ss > 0  # sqrt_rn takes x > 0
    return torch.where(pos, sqrt_rn(torch.where(pos, ss, 1.0)), ss)


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
    and norms are ``tree_sum``s in b's dtype (the same bits on every
    device)."""
    M = M or (lambda v: v)
    shape, dtype = b.shape, b.dtype
    b = b.reshape(-1)
    m = int(restart)
    x = torch.zeros_like(b) if x0 is None else x0.reshape(-1).clone()
    tiny = float(np.sqrt(torch.finfo(dtype).tiny))
    stop = max(tol * float(norm_rn(b)), atol)

    def op(v):
        return A(v.reshape(shape)).reshape(-1)

    def prec(v):
        return M(v.reshape(shape)).reshape(-1)

    def cycle(x):
        r = b - op(x)
        beta = float(norm_rn(r))
        V = b.new_zeros((m + 1, b.numel()))
        V[0] = r * (1.0 / max(beta, tiny))
        H = np.zeros((m + 1, m))
        cs, sn = np.zeros(m), np.zeros(m)
        g = np.zeros(m + 1)
        g[0] = beta
        jdone = 0
        for j in range(m):
            w = op(prec(V[j]))
            Vj = V[:j + 1]
            hcol = tree_sum(Vj * w, 1)
            w = w - tree_sum(Vj * hcol[:, None], 0)
            corr = tree_sum(Vj * w, 1)
            w = w - tree_sum(Vj * corr[:, None], 0)
            hj1 = norm_rn(w)
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
        yt = torch.as_tensor(y, dtype=dtype, device=b.device)
        corr = tree_sum(V[:jdone] * yt[:, None], 0)
        return x + prec(corr), abs(g[jdone]), jdone

    res = float(norm_rn(b - op(x)))
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
