"""fluid_ale problem driver: Navier-Stokes on a moving (ALE) mesh.

Counterpart of fourc_tpu/physics/fluid_ale_driver.py: ``ale_dirichlet``
conditions prescribe the mesh motion (VAL * FUNCT per component, every
component constrained), the interior follows the Laplace smoother
(physics/ale.py), and the fluid takes one-step-theta steps on the moved
mesh with the convective velocity u - u_grid, the mesh velocity the
backward difference of the mesh displacements.
"""

from __future__ import annotations

import numpy as np
import torch

from fourc_tpu_torch.core.device import resolve_device
from fourc_tpu_torch.physics import driver as drv
from fourc_tpu_torch.physics import fluid as pf
from fourc_tpu_torch.physics.ale import AleField
from fourc_tpu_torch.physics.ale_driver import moving_nodes
from fourc_tpu_torch.physics.fluid_driver import (FluidFieldView, build_field,
                                                  check_supported)
from fourc_tpu_torch.utils.timer import Timers


def make_step(f: pf.FluidField, ale: AleField, handler, moving, dt: float):
    """One one-step-theta step on the mesh that the ALE field moves to its
    prescribed position at t_{n+1}."""
    th = f.params.theta
    c1, c0 = 1.0 / (th * dt), (1.0 - th) / th
    inv_dt = 1.0 / dt

    def step(state):
        t1 = state["t"] + dt
        uD = torch.as_tensor(
            handler.values(t1).reshape(-1, f.dim)[moving], dtype=f.dtype,
            device=f.device)
        mdisp = ale.solve(uD)
        mvel = (mdisp - state["mesh_disp"]) * inv_dt
        x_n, xdot_n = state["x"], state["xdot"]

        def rates(x):
            return pf.zero_pressure_rate(f, (x - x_n) * c1 - c0 * xdot_n)

        def residual(x):
            return f.residual_transient(x, rates(x), t1, dt=dt,
                                        mesh_disp=mdisp, mesh_vel=mvel)

        def jacobian_at(x):
            _, apply = f.linearize(x, rates(x), t1, dt=dt, mesh_disp=mdisp,
                                   mesh_vel=mvel)
            return lambda v: apply(v, pf.zero_pressure_rate(f, v * c1))

        # the reference builds this preconditioner without dt (tau_M of
        # the stationary form) and on the reference mesh; kept so
        M = f.build_preconditioner(dt_factor=c1)
        x, stats = pf.solve(f, residual, jacobian_at, f.dbc.apply(x_n, t1), M)
        new = dict(state)
        # the rate is not masked on the Dirichlet rows, as the reference's
        new.update(x=x, xdot=rates(x), x_nm1=x_n, mesh_disp=mdisp, t=t1,
                   step=state["step"] + 1)
        return new, stats

    return step


def run(deck, callbacks=None, device="cuda") -> drv.RunResult:
    device = resolve_device(device)
    dyn = deck.sections["fluid_dynamic"]
    name = next(iter(deck.disc))
    disc = deck.disc[name]
    check_supported(deck, name, ale=True)
    ale_bcs = list(deck.conditions.get(name, {}).get("ale_dirichlet", ()))
    if not ale_bcs:
        raise ValueError("fluid_ale needs ale_dirichlet conditions "
                         "(the prescribed mesh motion)")
    timers = Timers()
    with timers("setup"):
        f = build_field(deck, disc_name=name, device=device)
        handler, moving = moving_nodes(ale_bcs, disc, deck.functions)
        ale = AleField(disc, interface_nodes=moving, boundary_nodes=(),
                       method="laplace", device=device, dtype=f.dtype)
        state = pf.init_state(f)
        state["mesh_disp"] = torch.zeros((disc.n_nodes, disc.dim),
                                         dtype=f.dtype, device=f.device)
    dt = float(dyn["timestep"])
    step = make_step(f, ale, handler, moving, dt)
    state, agg = drv.time_loop(
        "fluid_ale", state, lambda _dt: step, dt, int(dyn["numstep"]),
        divercont=dyn["divercont"], callbacks=list(callbacks or []),
        timers=timers)
    return drv.RunResult(
        deck=deck, fields={"fluid_ale": FluidAleView(f)},
        states={"fluid_ale": state}, stats={"fluid_ale": agg},
        timers=timers)


class FluidAleView(FluidFieldView):
    """``velx`` ... and ``pressure`` of the fluid, ``mdispx`` ... of the
    mesh displacement."""

    def node_value(self, state, quantity, node):
        q = quantity.lower()
        if q.startswith("mdisp"):
            comp = "xyz".index(q[5])
            return float(state["mesh_disp"][node, comp])
        return super().node_value(state, quantity, node)
