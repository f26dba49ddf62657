"""Matrix-free Newton-Krylov nonlinear solver.

Counterpart of fourc_tpu/physics/newton.py:newton_solve, with the loop on
the host.  The tangent comes in as an explicit operator ``matvec_fn(u, v)``
(on the lattice path: the fused tangent kernel), so no autograd is
involved.  Same algorithm as the reference: Eisenstat-Walker forcing,
residual/increment status test, stagnation test, optional backtracking line
search and pseudo-transient continuation.  Norms are read on the host once
per Newton iteration.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from fourc_tpu_torch.linalg import solvers


@dataclass
class NewtonParams:
    max_iter: int = 20
    tol_res: float = 1e-8  # absolute residual 2-norm
    tol_disp: float = 1e-8  # absolute increment 2-norm
    tol_res_rel: float = 0.0  # relative to ||r0||; 0 = off
    combine: str = "and"  # "and" | "or" of the two tests
    stag_tol: float = 0.0  # stop when rnorm > stag_tol * previous; 0 = off
    stag_min_drop: float = 1e-3
    lin_method: str = "cg"  # "cg" | "gmres" | "bicgstab" | "direct"
    lin_maxiter: int = 500
    lin_rtol: float = 1e-4  # floor of the adaptive forcing term
    lin_adaptive: bool = True
    gmres_restart: int = 50
    line_search: bool = False
    ls_max_halvings: int = 4
    ptc: bool = False  # pseudo-transient continuation
    ptc_dt0: float = 1.0


def _norm(x) -> float:
    """||x||, the same bits on every device (the adaptive Krylov tolerance
    and the line search read it)."""
    return float(solvers.norm_rn(x))


def _converged(rnorm, dnorm, params: NewtonParams, rnorm0, k):
    """Status test; before the first increment (k == 0) only the residual
    counts."""
    tol = params.tol_res
    if params.tol_res_rel:
        tol = max(tol, params.tol_res_rel * rnorm0)
    cr = rnorm <= tol
    if k == 0:
        return cr
    cd = dnorm <= params.tol_disp
    return (cr and cd) if params.combine == "and" else (cr or cd)


def _stagnated(rnorm, rprev, k, params):
    return bool(params.stag_tol) and k >= 2 and rnorm > params.stag_tol * rprev


def newton_solve(residual_fn, u0, free_mask, precond, params: NewtonParams,
                 matvec_fn, batched=False):
    """Solve residual_fn(u) = 0 on the free entries.

    residual_fn: u -> r (constrained entries ignored)
    free_mask:   bool tensor shaped like u0; constrained entries of u0 must
                 already carry their prescribed values
    precond:     r -> z, constrained entries passed through
    matvec_fn:   (u, v) -> J(u) v, the tangent operator
    batched:     matvec_fn is plain PyTorch in v (``torch.func.vmap`` can
                 batch it): the direct solve probes it at once

    The linear solver is ``lin_method``: preconditioned CG, GMRES
    (restart ``gmres_restart``) or BiCGStab, each with tol = the forcing
    term and atol = 0.1 tol_res, or the dense direct solve (precond
    unused).  Returns (u, stats) with iters, resnorm, dispnorm,
    lin_iters, converged.
    """
    def masked_res(u):
        return torch.where(free_mask, residual_fn(u), 0.0)

    def make_op(u, sigma):
        def A(v):
            vm = torch.where(free_mask, v, 0.0)
            out = matvec_fn(u, vm)
            if sigma is not None:
                out = out + sigma * vm
            return torch.where(free_mask, out, v)

        return A

    u = u0
    r = masked_res(u)
    rnorm = rnorm0 = _norm(r)
    dnorm, k, lin_tot, rprev = 0.0, 0, 0, float("inf")
    sigma = 1.0 / params.ptc_dt0 if params.ptc else None
    while (k < params.max_iter
           and not _converged(rnorm, dnorm, params, rnorm0, k)
           and not _stagnated(rnorm, rprev, k, params)):
        if params.lin_adaptive:
            eta = min(max((rnorm / max(rnorm0, 1e-300)) ** 0.5,
                          params.lin_rtol), 1e-1)
        else:
            eta = params.lin_rtol
        A = make_op(u, sigma)
        if params.lin_method == "direct":
            res = solvers.direct(A, -r, batched=batched)
        else:
            kw = ({"restart": params.gmres_restart}
                  if params.lin_method == "gmres" else {})
            res = solvers.solve(params.lin_method, A, -r, M=precond, tol=eta,
                                atol=0.1 * params.tol_res,
                                maxiter=params.lin_maxiter, **kw)
        du = torch.where(free_mask, res.x, 0.0)
        u_new = u + du
        if params.line_search:
            # backtracking on ||r||: the first of 1, 1/2, 1/4, ... that
            # lowers the residual, else the full step
            alpha = 1.0
            for _ in range(params.ls_max_halvings + 1):
                u_try = u + alpha * du
                if _norm(masked_res(u_try)) < rnorm:
                    u_new = u_try
                    break
                alpha *= 0.5
        r = masked_res(u_new)
        rnorm_new = _norm(r)
        if params.ptc:
            sigma = sigma * rnorm_new / max(rnorm, 1e-300)
        u, rprev, rnorm = u_new, rnorm, rnorm_new
        dnorm = _norm(du)
        k += 1
        lin_tot += res.iters
    conv = _converged(rnorm, dnorm, params, rnorm0, k)
    # a non-finite residual never counts as converged
    conv = conv and math.isfinite(rnorm)
    if params.stag_tol and _stagnated(rnorm, rprev, k, params):
        conv = conv or rnorm <= params.stag_min_drop * max(rnorm0, 1e-300)
    stats = {"iters": k, "resnorm": rnorm, "dispnorm": dnorm,
             "lin_iters": lin_tot, "converged": bool(conv)}
    return u, stats
