"""CG, Jacobi and Newton of the port against fourc_tpu on small systems.

Same algorithm, same inputs (numpy, fixed seeds).  Newton must take the same
iterations and reach the same iterate to 1e-10 relative.  CG reduces dot
products in another order than XLA, which can move the iteration where
||r|| crosses the stopping bound by one, so CG counts agree within one and
both solutions lie within 1e-8 relative of numpy's direct solve.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourc_tpu.linalg import precond as jprecond
from fourc_tpu.linalg import solvers as jsolvers
from fourc_tpu.physics import newton as jnewton
from fourc_tpu_torch.linalg import precond, solvers
from fourc_tpu_torch.physics import newton


def _spd(n, seed, cond=1e3):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return (Q * np.geomspace(1.0, cond, n)) @ Q.T


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("use_jacobi", [False, True])
def test_cg_matches_reference(seed, use_jacobi):
    n = 60
    A = _spd(n, seed, cond=30.0)
    b = np.random.default_rng(seed + 10).normal(size=n)
    At = torch.as_tensor(A)
    d = np.diag(A).copy()
    M = precond.jacobi(torch.as_tensor(d)) if use_jacobi else None
    res = solvers.cg(lambda v: At @ v, torch.as_tensor(b), M=M, tol=1e-10,
                     maxiter=200)
    jM = jprecond.jacobi(jnp.asarray(np.diag(A))) if use_jacobi else None
    Aj = jnp.asarray(A)
    jres = jsolvers.cg(lambda v: Aj @ v, jnp.asarray(b), M=jM, tol=1e-10,
                       maxiter=200)
    assert res.converged and bool(jres.converged)
    assert abs(res.iters - int(jres.iters)) <= 1
    x = np.linalg.solve(A, b)
    for got in (res.x.numpy(), np.asarray(jres.x)):
        assert np.abs(got - x).max() <= 1e-8 * np.abs(x).max()


def test_cg_respects_maxiter_and_atol():
    A = _spd(30, 3, cond=1e6)
    b = torch.as_tensor(np.random.default_rng(4).normal(size=30))
    At = torch.as_tensor(A)
    res = solvers.cg(lambda v: At @ v, b, tol=1e-14, maxiter=5)
    assert res.iters == 5 and not res.converged
    res = solvers.cg(lambda v: At @ v, b, tol=0.0, atol=1e30)
    assert res.iters == 0 and res.converged


def _cubic_problem(mod, arr):
    """r(u) = K u + c u^3 - f on 12 dofs, the last 2 fixed."""
    rng = np.random.default_rng(5)
    K = _spd(12, 6, cond=50.0)
    f = rng.normal(size=12) * 5.0
    free = np.ones(12, bool)
    free[-2:] = False
    Ka, fa = arr(K), arr(f)

    def res(u):
        return Ka @ u + 0.3 * u ** 3 - fa

    def tangent(u, v):
        return Ka @ v + 0.9 * u ** 2 * v

    return res, tangent, free, K


@pytest.mark.parametrize("line_search", [False, True])
@pytest.mark.parametrize("ptc", [False, True])
def test_newton_matches_reference(line_search, ptc):
    def make_params(P):
        p = P.NewtonParams(tol_res=1e-10, tol_disp=1e-10, max_iter=30,
                           line_search=line_search, ptc=ptc, ptc_dt0=0.5)
        return p

    res, tan, free, K = _cubic_problem(torch, torch.as_tensor)
    Mt = precond.jacobi(torch.as_tensor(np.diag(K).copy()))
    ft = torch.as_tensor(free)
    u0 = torch.zeros(12, dtype=torch.float64)
    u, st = newton.newton_solve(res, u0, ft, lambda r: torch.where(
        ft, Mt(r), r), make_params(newton), tan)

    jres, jtan, _, _ = _cubic_problem(jnp, jnp.asarray)
    jM = jprecond.jacobi(jnp.asarray(np.diag(K)))
    jf = jnp.asarray(free)
    ju, jst = jnewton.newton_solve(jres, jnp.zeros(12), jf,
                                   lambda r: jnp.where(jf, jM(r), r),
                                   make_params(jnewton), matvec_fn=jtan)
    assert st["converged"] and bool(jst["converged"])
    assert st["iters"] == int(jst["iters"])
    assert st["lin_iters"] == int(jst["lin_iters"])
    assert (np.abs(u.numpy() - np.asarray(ju)).max()
            <= 1e-10 * np.abs(np.asarray(ju)).max())


def test_newton_reports_nonfinite_as_unconverged():
    free = torch.ones(3, dtype=torch.bool)

    def res(u):
        return torch.full_like(u, float("nan"))

    _, st = newton.newton_solve(res, torch.zeros(3, dtype=torch.float64),
                                free, None, newton.NewtonParams(max_iter=2),
                                lambda u, v: v)
    assert not st["converged"]

