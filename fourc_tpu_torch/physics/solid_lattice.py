"""The time steps, with the whole Newton-Krylov loop in the field's layout.

Counterpart of fourc_tpu/physics/solid_lattice.py and of the flat
``_make_genalpha_step``, ``_make_statics_step``, ``_make_ost_step`` and
``_make_central_diff_step`` of fourc_tpu/physics/solid.py (without contact
and ties), for every kind of field: a uniform lattice (kernels
B1-B3), general geometry on lattice topology (B4, B5) and general topology
(B6, B7 and the element route); the steps only call the field's operators.
On a lattice, state vectors, residuals, Krylov vectors and the GMG
hierarchy all stay in the padded lattice layout (ops/lattice.py); the flat
dof state is converted once, on the first step.  On general topology the
field's layout functions are the identity and everything stays flat.

The Newton operators are the exact tangents of the residuals, which the
reference takes by ``jax.jvp``: each is one pass of the field's fused
tangent ``K(u) v + mcoef * M v`` (the consistent mass in the same kernel
pass, the lumped mass added elementwise), plus, under stiffness-proportional
Rayleigh damping, the second derivative of the internal force.
``precond_at(u0, hist)`` gives each step's preconditioner at its
predictor: the static multigrid, the per-state Jacobi or block-Jacobi, or
None.

Each step reads the history of the last converged step, ``state["hist"]``,
forms its residual and Newton operator there (a history law's return map
runs inside every residual, from the old history), and keeps the new
history of the converged displacement; no tensor of a state is changed in
place, so a halved step restarts from the old history.  The springs'
dashpots see d_n as u_old in the statics and gen-alpha steps only, and the
constraints' forces and tangents join every implicit residual and operator,
where the reference has them.
"""

from __future__ import annotations

import torch

from fourc_tpu_torch.physics.newton import newton_solve
from fourc_tpu_torch.physics.solid import _newmark_updates, _predict

STATE_FIELDS = ("d", "v", "a", "fint", "fext")  # dof vectors of a state


def to_lattice_state(f, state):
    """Flat dof state -> state in the field's layout (no-op if it is a
    lattice already, or if the field is flat)."""
    if state["d"].dim() != 1:
        return dict(state)
    new = dict(state)
    for k in STATE_FIELDS:
        new[k] = f.to_lattice(state[k])
    return new


def from_lattice_state(f, state):
    """Lattice state -> flat dof vectors (io and tests)."""
    if state["d"].dim() == 1:
        return dict(state)
    new = dict(state)
    for k in STATE_FIELDS:
        new[k] = f.from_lattice(state[k])
    return new


def _step_start(f, state, dt):
    """The state in the field's layout, t_{n+1}, f_ext(t_{n+1}) and the
    prescribed values at t_{n+1} (loads and prescribed values do not
    depend on d: once per step)."""
    state = to_lattice_state(f, state)
    t1 = state["t"] + dt
    gw = f.to_lattice(torch.as_tensor(f.dbc.values(t1), dtype=f.dtype,
                                      device=f.device))
    return state, t1, f.external_force(t1), gw


def _extras(f, t1, dt=None):
    """The terms a step adds for the constraints and the dashpots:
    u -> the constraints' forces at u and time t1, which the residual adds
    (the reference subtracts them from ``external_force(t1, u)``), and
    u, v -> their derivative along v plus, with ``dt`` (the steps that
    pass u_old), the dashpots' c v / dt; each None where it is 0."""
    force = tangent = None
    if f.constraints:
        def force(u):
            return f.constraint_force(u, t1)
    if f.constraints or (dt and f.c_spring is not None):
        lin = {}  # the constraints linearized once per Newton iterate

        def tangent(u, v):
            out = 0.0
            if f.constraints:
                if lin.get("u") is not u:
                    lin.update(u=u, apply=f.constraint_tangent_at(u, t1))
                out = lin["apply"](v)
            return out + f.dashpot(v, dt) if dt else out
    return force, tangent


def genalpha_system(f, dt: float, state, fext1, t1=None):
    """The gen-alpha residual of one step from ``state`` (in the field's
    layout, external force f_ext(t_{n+1}) = fext1) and its Newton operator,
    with Rayleigh damping ``ra * M v_mid + rb * K(d) v_mid``,
    v_mid = (1 - af) v_{n+1} + af v_n.  With c = gamma / (beta dt) the
    operator is (1 - af)(1 + rb c) K(d) + ((1 - am) / (beta dt^2)
    + ra (1 - af) c) M + rb D^2f(d)[v_mid, .]: one fused tangent pass, plus
    D^2f when rb != 0, plus (1 - af) times the dashpots' c / dt and the
    constraints' tangent.  K, D^2f and the force are taken at the history
    of ``state``; the springs' dashpots see d_n (the reference's u_old)."""
    ga = f.params.genalpha
    am, af, beta, gamma = ga.alpha_m, ga.alpha_f, ga.beta, ga.gamma
    ra, rb = f.params.rayleigh_alpha, f.params.rayleigh_beta
    c = gamma / (beta * dt)
    kfac = (1 - af) * (1 + rb * c)
    mcoef = ((1 - am) / (beta * dt * dt) + ra * (1 - af) * c) / kfac
    d_n, v_n, a_n = state["d"], state["v"], state["a"]
    fint_n, hist = state["fint"], state.get("hist")
    fmid_ext = (1 - af) * fext1 + af * state["fext"]
    t1 = state["t"] + dt if t1 is None else t1
    con_force, extra_tangent = _extras(f, t1, dt)

    def v_mid_of(d_new):
        v_new, _ = _newmark_updates(dt, d_new, d_n, v_n, a_n, beta, gamma)
        return (1 - af) * v_new + af * v_n

    def residual(d_new):
        v_new, a_new = _newmark_updates(dt, d_new, d_n, v_n, a_n, beta,
                                        gamma)
        a_mid = (1 - am) * a_new + am * a_n
        fint_mid = ((1 - af) * f.internal_force(d_new, hist, dt, u_old=d_n)
                    + af * fint_n)
        v_mid = (1 - af) * v_new + af * v_n
        if ra:
            a_mid = a_mid + ra * v_mid
        r = f.mass_matvec(a_mid) + fint_mid - fmid_ext
        if con_force:
            r = r + (1 - af) * con_force(d_new)
        if rb:
            r = r + rb * f.tangent(d_new, v_mid, hist=hist, dt=dt)
        return r

    hessian = {}  # D^2f(u)[v_mid(u), .], set up once per Newton iterate

    def matvec_fn(u, v):
        out = kfac * f.tangent(u, v, mcoef, hist, dt)
        if extra_tangent:
            out = out + (1 - af) * extra_tangent(u, v)
        if rb:
            if hessian.get("u") is not u:
                hessian.update(u=u, apply=f.force_hessian_at(
                    u, v_mid_of(u), hist, dt))
            out = out + rb * hessian["apply"](v)
        return out

    return residual, matvec_fn


def make_lattice_genalpha_step(f, dt: float, precond_at):
    """Gen-alpha (``genalpha_system``), in the field's layout."""
    ga = f.params.genalpha
    beta, gamma = ga.beta, ga.gamma

    def step(state):
        state, t1, fext1, gw = _step_start(f, state, dt)
        d_n, v_n, a_n = state["d"], state["v"], state["a"]
        hist = state.get("hist")
        residual, matvec_fn = genalpha_system(f, dt, state, fext1, t1)
        u0 = torch.where(f.free, _predict(f.params.predictor, dt, d_n, v_n,
                                          a_n), gw)
        u, stats = newton_solve(residual, u0, f.free, precond_at(u0, hist),
                                f.params.newton, matvec_fn,
                                batched=f.plain_tangent)
        v1, a1 = _newmark_updates(dt, u, d_n, v_n, a_n, beta, gamma)
        return _finish(f, state, stats, hist, dt, t1, fext1, d=u, v=v1,
                       a=a1, u_old=d_n)

    return step


def _finish(f, state, stats, hist, dt, t1, fext1, u_old=None, **new):
    """The converged state: ``new`` (d and, for dynamics, v and a), the
    internal force and the new history at d (one pass), f_ext at t1 with
    the constraints' forces at d, the time and the step counter."""
    d = new["d"]
    fint, hist_new = f.internal_force(d, hist, dt, u_old=u_old,
                                      with_history=True)
    fext = fext1 if not f.constraints else \
        fext1 - f.constraint_force(d, t1)
    new_state = dict(state)
    new_state.update(new, t=t1, step=state["step"] + 1, fint=fint,
                     fext=fext, hist=hist_new)
    return new_state, stats


def make_statics_step(f, dt: float, precond_at):
    """Statics: f_int(d) = f_ext(t_{n+1}, d) from the predictor d_n with the
    prescribed values at t_{n+1}; the Newton operator is K(d), plus the
    dashpots' c / dt (the reference passes d_n as u_old here too) and the
    constraints' tangent."""

    def step(state):
        state, t1, fext1, gw = _step_start(f, state, dt)
        d_n, hist = state["d"], state.get("hist")
        con_force, extra_tangent = _extras(f, t1, dt)

        def residual(d):
            r = f.internal_force(d, hist, dt, u_old=d_n) - fext1
            return r + con_force(d) if con_force else r

        def matvec(u, v):
            out = f.tangent(u, v, 0.0, hist, dt)
            return out + extra_tangent(u, v) if extra_tangent else out

        u0 = torch.where(f.free, d_n, gw)
        u, stats = newton_solve(residual, u0, f.free, precond_at(u0, hist),
                                f.params.newton, matvec,
                                batched=f.plain_tangent)
        return _finish(f, state, stats, hist, dt, t1, fext1, d=u, u_old=d_n)

    return step


def make_ost_step(f, dt: float, precond_at):
    """One-step-theta: M a_mid + th f_int(d) + (1 - th) f_int,n
    = th f_ext,n+1 + (1 - th) f_ext,n with v_{n+1} = (d - d_n) / (th dt)
    - (1 - th) / th v_n and a_mid = (v_{n+1} - v_n) / dt; the Newton
    operator is th (K(d) + M / (th^2 dt^2)) plus th times the constraints'
    tangent.  The reference passes no u_old here: the dashpots drop out
    (physics/structure_driver.py refuses a nonzero viscosity)."""
    th = f.params.theta
    mcoef = 1.0 / (th * th * dt * dt)

    def step(state):
        state, t1, fext1, gw = _step_start(f, state, dt)
        d_n, v_n, a_n = state["d"], state["v"], state["a"]
        hist = state.get("hist")
        con_force, con_tangent = _extras(f, t1)
        rest = (1 - th) * state["fint"] - (th * fext1
                                           + (1 - th) * state["fext"])

        def v_of(d_new):
            return (d_new - d_n) / (th * dt) - (1 - th) / th * v_n

        def residual(d_new):
            a_mid = (v_of(d_new) - v_n) / dt  # th a_{n+1} + (1 - th) a_n
            r = (f.mass_matvec(a_mid)
                 + th * f.internal_force(d_new, hist, dt) + rest)
            return r + th * con_force(d_new) if con_force else r

        def matvec(u, v):
            out = f.tangent(u, v, mcoef, hist, dt)
            if con_tangent:
                out = out + con_tangent(u, v)
            return th * out

        u0 = torch.where(f.free, _predict(f.params.predictor, dt, d_n, v_n,
                                          a_n), gw)
        u, stats = newton_solve(residual, u0, f.free, precond_at(u0, hist),
                                f.params.newton, matvec,
                                batched=f.plain_tangent)
        v1 = v_of(u)
        a1 = (v1 - v_n) / (th * dt) - (1 - th) / th * a_n
        return _finish(f, state, stats, hist, dt, t1, fext1, d=u, v=v1,
                       a=a1)

    return step


def make_explicit_step(f, dt: float):
    """Explicit central differences with the lumped mass, whatever the
    field's mass setting (the reference's): one internal force per step,
    no solve; the stats report a converged step of 0 iterations."""
    ml = f.mlump
    minv = torch.where(ml > 0, 1.0 / torch.clamp(ml, min=1e-300), 0.0)

    def step(state):
        state, t1, fext1, gw = _step_start(f, state, dt)
        v_half = state["v"] + 0.5 * dt * state["a"]
        d1 = torch.where(f.free, state["d"] + dt * v_half, gw)
        hist = state.get("hist")
        fint, hist_new = f.internal_force(d1, hist, dt, with_history=True)
        fext = fext1 if not f.constraints else \
            fext1 - f.constraint_force(d1, t1)
        a1 = torch.where(f.free, minv * (fext - fint), 0.0)
        new_state = dict(state)
        new_state.update(d=d1, v=v_half + 0.5 * dt * a1, a=a1, t=t1,
                         step=state["step"] + 1, fint=fint, fext=fext,
                         hist=hist_new)
        return new_state, {"iters": 0, "resnorm": 0.0, "dispnorm": 0.0,
                           "lin_iters": 0, "converged": True}

    step.precond = None
    return step
