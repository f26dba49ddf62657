"""Gen-alpha step with the whole Newton-Krylov loop in the lattice layout.

Counterpart of fourc_tpu/physics/solid_lattice.py, for both kinds of field
spec: a uniform lattice (kernels B1-B3) and general geometry on lattice
topology (B4, B5); the step only calls the field's operators.  State
vectors, residuals, Krylov vectors and the GMG hierarchy all stay in the
padded lattice layout (ops/lattice.py); the flat dof state is converted once,
on the first step.

The Newton operator is the fused tangent of the residual,
``(1 - af) * (K(u) v + mcoef * M v)`` with
``mcoef = rho (1 - am) / ((1 - af) beta dt^2)``: one tangent-kernel pass
per Krylov iteration (the reference takes ``jax.jvp`` of the residual,
which on general geometry runs the tangent and the mass kernels; the sum
is the same).
"""

from __future__ import annotations

import torch

from fourc_tpu_torch.physics.newton import newton_solve
from fourc_tpu_torch.physics.solid import _newmark_updates, _predict

STATE_FIELDS = ("d", "v", "a", "fint", "fext")  # dof vectors of a state


def to_lattice_state(f, state):
    """Flat dof state -> lattice state (no-op if already a lattice)."""
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


def make_lattice_genalpha_step(f, dt: float, M_gmg):
    ga = f.params.genalpha
    am, af, beta, gamma = ga.alpha_m, ga.alpha_f, ga.beta, ga.gamma
    mcoef = f.density * (1 - am) / ((1 - af) * beta * dt * dt)

    def matvec_fn(u, v):
        return (1 - af) * f.tangent(u, v, mcoef)

    def step(state):
        state = to_lattice_state(f, state)
        t1 = state["t"] + dt
        d_n, v_n, a_n = state["d"], state["v"], state["a"]
        fint_n = state["fint"]
        # loads and prescribed values do not depend on d: once per step
        fext1 = f.external_force(t1)
        gw = f.to_lattice(torch.as_tensor(f.dbc.values(t1), dtype=f.dtype,
                                          device=f.device))
        fmid_ext = (1 - af) * fext1 + af * state["fext"]

        def residual(d_new):
            _, a_new = _newmark_updates(dt, d_new, d_n, v_n, a_n, beta, gamma)
            a_mid = (1 - am) * a_new + am * a_n
            fint_mid = (1 - af) * f.internal_force(d_new) + af * fint_n
            return f.mass_matvec(a_mid) + fint_mid - fmid_ext

        u0 = torch.where(f.free, _predict(f.params.predictor, dt, d_n, v_n,
                                          a_n), gw)
        u, stats = newton_solve(residual, u0, f.free, M_gmg, f.params.newton,
                                matvec_fn)
        v1, a1 = _newmark_updates(dt, u, d_n, v_n, a_n, beta, gamma)
        new_state = dict(state)
        new_state.update(d=u, v=v1, a=a1, t=t1, step=state["step"] + 1,
                         fint=f.internal_force(u), fext=fext1)
        return new_state, stats

    return step
