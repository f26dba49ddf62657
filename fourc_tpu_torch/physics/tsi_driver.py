"""TSI problem driver: deck -> TsiField -> coupled time loop.

Counterpart of fourc_tpu/physics/tsi_driver.py, with the coupling of
``tsi_dynamic.coupling``:
  oneway      : a thermo solve, then a structure solve, per step;
  partitioned : the staggered fixed point thermo -> structure with the
                reference's Aitken relaxation of the temperature (clamped
                to [0.05, 1]) until both increments fall below
                ``convtol_outer``;
  monolithic  : one Newton on the stacked residual [r_s; r_t], whose
                operator is its exact derivative, as the reference's
                ``jax.jvp``: the solid's tangent (B7, or the element
                route's forward mode) and its mass (B6), the thermal
                expansion block K_st, and the thermo rows, affine in
                (T, d), by their linear part (the heating block K_ts
                included), which is forward mode's arithmetic on the
                tangent (``CoupledStep.thermo_tangent``);
                CG becomes BiCGStab, as the coupled operator is not
                symmetric.
The structure takes statics or one-step-theta, the thermo field
one-step-theta or stationary (the reference's coupled residual runs any
other integrator of either as one of these; the port refuses them by
name).  The converged step keeps the new Gauss-point history of the
structure (the reference's drops it).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from fourc_tpu_torch.core.device import resolve_device
from fourc_tpu_torch.linalg import solvers
from fourc_tpu_torch.physics import driver as drv
from fourc_tpu_torch.physics import scalar_driver
from fourc_tpu_torch.physics import solid as ps
from fourc_tpu_torch.physics import structure_driver
from fourc_tpu_torch.physics.newton import newton_solve
from fourc_tpu_torch.physics.tsi import TsiField, TsiParams
from fourc_tpu_torch.utils.timer import Timers

STRUCTURE_DYNTYPES = ("statics", "onesteptheta")
THERMO_DYNTYPES = ("onesteptheta",)


def check_supported(deck):
    """Raise NotImplementedError naming what the port does not carry of a
    TSI deck, before anything is built (the structure's settings through
    ``structure_driver.check_supported``)."""
    out = []
    sdyn = deck.sections["structural_dynamic"]["dynamictype"]
    tdyn = deck.sections["thermal_dynamic"]["dynamictype"]
    if sdyn not in STRUCTURE_DYNTYPES:
        out.append(f"structural_dynamic dynamictype {sdyn!r} under TSI "
                   f"({', '.join(STRUCTURE_DYNTYPES)} are ported; the "
                   f"reference's coupled residual runs it as one-step-theta)")
    if tdyn not in THERMO_DYNTYPES:
        out.append(f"thermal_dynamic dynamictype {tdyn!r} under TSI "
                   f"(onesteptheta is ported; the reference's coupled "
                   f"residual runs it as backward Euler)")
    for kind in ("constraint", "spring_dashpot"):
        if any(c.get(kind) for c in deck.conditions.values()):
            out.append(f"{kind} conditions under TSI (the reference's "
                       f"coupled residual leaves them out)")
    if out:
        raise NotImplementedError("not ported: " + "; ".join(out))
    structure_driver.check_supported(deck, next(iter(deck.disc)))
    scalar_driver.check_supported(deck, "thermal_dynamic", "thermo")


def build_field(deck, device="cuda") -> TsiField:
    disc_name = next(iter(deck.disc))
    solid = structure_driver.build_field(deck, disc_name, device=device,
                                         general=True)
    thermo = scalar_driver.build_field(deck, "thermal_dynamic", "thermo",
                                       device=device)
    cfg = deck.sections["tsi_dynamic"]
    params = TsiParams(coupling=cfg["coupling"], dt=cfg["timestep"],
                       n_steps=cfg["numstep"],
                       itemax_outer=cfg["itemax_outer"],
                       convtol_outer=cfg["convtol_outer"])
    return TsiField(solid, thermo, params)


def init_state(f: TsiField):
    """Zero displacements and rates; T(0) from the thermo field's initial
    FUNCT, else the first thermo-elastic law's ``inittemp`` with the
    prescribed values at t = 0; f_int and f_ext at that state."""
    s = ps.init_state(f.solid)
    T = f.thermo.dbc.apply(torch.zeros(f.nt, dtype=f.thermo.dtype,
                                       device=f.thermo.device), 0.0)
    if f.thermo.params.initial_funct:
        from fourc_tpu_torch.physics import scalar_transport as st

        T = st.init_state(f.thermo)["phi"]
    else:
        t0s = [m.inittemp for m in f.solid.block_mat.values()
               if getattr(m, "kind", None) == "thermo_solid"]
        if t0s:
            T = f.thermo.dbc.apply(torch.full_like(T, float(t0s[0])), 0.0)
    state = {"d": s["d"], "v": s["v"], "a": s["a"], "T": T,
             "Tdot": torch.zeros_like(T), "t": 0.0, "step": 0,
             "hist": s["hist"]}
    state["fint"] = f.solid.internal_force(state["d"], state["hist"],
                                           temps=f.temps_at_gps(T))
    state["fext"] = f.solid.external_force(state["t"])
    return state


class CoupledStep:
    """The residuals of one step from ``state`` to t1 = t + dt: the
    structure's (statics, or one-step-theta with its mass) at (d, T), the
    thermo field's (one-step-theta) at (T, d) with the heating of the
    structure's new velocity, and their derivatives."""

    def __init__(self, f: TsiField, state, dt):
        self.f, self.state, self.dt = f, state, dt
        sol, th = f.solid, f.thermo
        self.t1 = state["t"] + dt
        self.statics = sol.params.dyntype == "statics"
        self.theta_s = 1.0 if self.statics else sol.params.theta
        self.theta_t = th.params.theta
        self.fext = sol.external_force(self.t1)
        th_s = self.theta_s
        self.rest = None if self.statics else (
            (1 - th_s) * state["fint"]
            - (th_s * self.fext + (1 - th_s) * state["fext"]))
        self._split_memo = self._temps_memo = None

    def split(self, y):
        """(d, T) of y = [d; T], the same views while y (the same tensor,
        unchanged) stays: the residual and the Krylov applies of one Newton
        iterate then share d, the temperatures at the Gauss points and the
        solid's history moduli."""
        m = self._split_memo
        if m is None or m[0] is not y or m[1] != y._version:
            m = self._split_memo = (y, y._version, *self.f.split(y))
        return m[2], m[3]

    def temps(self, T):
        """``TsiField.temps_at_gps(T)``, kept while T (the same tensor,
        unchanged) stays."""
        m = self._temps_memo
        if m is None or m[0] is not T or m[1] != T._version:
            m = self._temps_memo = (T, T._version, self.f.temps_at_gps(T))
        return m[2]

    def velocity(self, d):
        st, dt = self.state, self.dt
        if self.statics:
            return (d - st["d"]) * (1.0 / dt)
        th = self.theta_s
        return (d - st["d"]) * (1.0 / (th * dt)) - (1 - th) / th * st["v"]

    def rate(self, T):
        st, th = self.state, self.theta_t
        return ((T - st["T"]) * (1.0 / (th * self.dt))
                - (1 - th) / th * st["Tdot"])

    def structure(self, d, T):
        """r_s(d, T)."""
        sol, st = self.f.solid, self.state
        fint = sol.internal_force(d, st["hist"], self.dt,
                                  temps=self.temps(T))
        if self.statics:
            return fint - self.fext
        a_mid = (self.velocity(d) - st["v"]) * (1.0 / self.dt)
        return sol.mass_matvec(a_mid) + self.theta_s * fint + self.rest

    def thermo(self, d, T):
        """r_t(T, d)."""
        return self.f.thermo.residual_transient(
            T, self.rate(T), self.t1, dt=self.dt,
            extra_source=self.f.heating_at_gps(self.velocity(d)) or None)

    def structure_tangent(self, d, T, vd):
        """d r_s / d d along vd: the solid's tangent at (d, T), the mass
        of one-step-theta included (th K + M / (th dt^2))."""
        sol, st, th = self.f.solid, self.state, self.theta_s
        mcoef = 0.0 if self.statics else 1.0 / (th * th * self.dt ** 2)
        return th * sol.tangent(d, vd, mcoef, st["hist"], self.dt,
                                temps=self.temps(T))

    def expansion(self, d, T, vT):
        """d r_s / d T along vT (K_st)."""
        f = self.f
        return self.theta_s * f.solid.temperature_derivative(
            d, self.temps(T), f.temps_at_gps(vT), self.state["hist"],
            self.dt)

    def thermo_tangent(self, vd, vT):
        """d r_t along (vd, vT): K_ts vd + K_tt vT.  r_t is affine in
        (T, d) (through the rate and the heating of the velocity), so this
        is its linear part at the increments: the same operations and bits
        as ``torch.func.jvp(self.thermo, (d, T), (vd, vT))``
        (tests/port/test_torch_tsi.py; ``chip_smoke.py`` phase 15 (b)
        times the two against each other)."""
        st, dt = self.state, self.dt
        th_s, th_t = self.theta_s, self.theta_t
        dv = vd * (1.0 / dt if self.statics else 1.0 / (th_s * dt))
        return self.f.thermo.residual_transient(
            vT, vT * (1.0 / (th_t * dt)), self.t1, dt=dt,
            extra_source=self.f.heating_at_gps(dv) or None, linear=True)

    def residual(self, y):
        """The monolithic residual [r_s; r_t] of y = [d; T]."""
        d, T = self.split(y)
        return self.f.join(self.structure(d, T), self.thermo(d, T))

    def jacobian(self, y, v):
        """Its exact derivative at y along v = [vd; vT]: [K_ss vd + K_st vT;
        K_ts vd + K_tt vT]."""
        f = self.f
        d, T = self.split(y)
        vd, vT = f.split(v)
        return f.join(self.structure_tangent(d, T, vd)
                      + self.expansion(d, T, vT),
                      self.thermo_tangent(vd, vT))

    def finish(self, d, T, stats):
        """The converged state at (d, T): velocities and accelerations,
        the rate of T (0 on its Dirichlet rows, as the reference's), f_int
        with the new history, f_ext, t1."""
        f, st, dt = self.f, self.state, self.dt
        fint, hist = f.solid.internal_force(d, st["hist"], dt,
                                            with_history=True,
                                            temps=f.temps_at_gps(T))
        if self.statics:
            v1 = a1 = torch.zeros_like(d)
        else:
            th = self.theta_s
            v1 = self.velocity(d)
            a1 = ((v1 - st["v"]) * (1.0 / (th * dt))
                  - (1 - th) / th * st["a"])
        new = dict(st)
        new.update(d=d, v=v1, a=a1, T=T, Tdot=f.thermo.dbc.mask(self.rate(T)),
                   fint=fint, fext=self.fext, t=self.t1,
                   step=st["step"] + 1, hist=hist)
        return new, stats


def _mass_shift(f, dt):
    sp = f.solid.params
    return 0.0 if sp.dyntype == "statics" else 1.0 / (sp.theta * dt * dt)


def _thermo_factor(f, dt):
    return 1.0 / (max(f.thermo.params.theta, 1e-300) * dt)


def make_monolithic_step(f: TsiField, dt: float):
    sol, th = f.solid, f.thermo
    nw = sol.params.newton
    if nw.lin_method == "cg":  # K_st != K_ts^T
        nw = replace(nw, lin_method="bicgstab")

    def step(state):
        c = CoupledStep(f, state, dt)
        d0 = sol.dbc.apply(state["d"], c.t1)
        T0 = th.dbc.apply(state["T"], c.t1)
        M = f.block_precond(d0, dt, _mass_shift(f, dt), _thermo_factor(f, dt))
        y, stats = newton_solve(c.residual, f.join(d0, T0), f.free_mask, M,
                                nw, c.jacobian, batched=sol.plain_tangent)
        return c.finish(*f.split(y), stats)

    return step


def make_staggered_solvers(f: TsiField, dt: float):
    """(solve_structure(state, T), solve_thermo(state, d)): one field's
    Newton with the other's unknown held."""
    sol, th = f.solid, f.thermo

    def solve_structure(state, T_fixed):
        c = CoupledStep(f, state, dt)
        d0 = sol.dbc.apply(state["d"], c.t1)
        return newton_solve(
            lambda d: c.structure(d, T_fixed), d0, sol.free,
            f.solid_preconditioner(d0, dt, _mass_shift(f, dt)),
            sol.params.newton,
            lambda d, vd: c.structure_tangent(d, T_fixed, vd),
            batched=sol.plain_tangent)

    def solve_thermo(state, d_fixed):
        c = CoupledStep(f, state, dt)
        T0 = th.dbc.apply(state["T"], c.t1)
        zero = torch.zeros_like(d_fixed)
        return newton_solve(
            lambda T: c.thermo(d_fixed, T), T0, th.free,
            th.build_preconditioner(dt_factor=_thermo_factor(f, dt)),
            th.params.newton, lambda _, vT: c.thermo_tangent(zero, vT),
            batched=True)

    return solve_structure, solve_thermo


def _dot(a, b):
    return float(solvers.tree_sum(a * b))


def make_step(f: TsiField, dt: float):
    if f.params.coupling == "monolithic":
        return make_monolithic_step(f, dt)
    solve_structure, solve_thermo = make_staggered_solvers(f, dt)
    oneway = f.params.coupling == "oneway"

    def step(state):
        d, T = state["d"], state["T"]
        tot_newton = tot_lin = 0
        converged = False
        # Aitken's Delta^2 relaxation of the temperature iterate, as the
        # reference's (the staggered loop can grow through the heating)
        omega, r_prev = 1.0, None
        for _ in range(1 if oneway else f.params.itemax_outer):
            T_solved, stat_t = solve_thermo(state, d)
            r = T_solved - T
            if not oneway and r_prev is not None:
                dr = r - r_prev
                denom = _dot(dr, dr)
                if denom > 0.0:
                    omega = -omega * _dot(r_prev, dr) / denom
                    omega = min(max(omega, 0.05), 1.0)
            T_new = T + omega * r
            r_prev = r
            d_new, stat_s = solve_structure(state, T_new)
            tot_newton += stat_t["iters"] + stat_s["iters"]
            tot_lin += stat_t["lin_iters"] + stat_s["lin_iters"]
            converged = stat_t["converged"] and stat_s["converged"]
            dT = float(solvers.norm_rn(T_new - T))
            dd = float(solvers.norm_rn(d_new - d))
            d, T = d_new, T_new
            if oneway or max(dT, dd) < f.params.convtol_outer:
                break
        else:
            converged = False
        stats = {"iters": tot_newton, "lin_iters": tot_lin,
                 "resnorm": stat_s["resnorm"], "dispnorm": stat_s["dispnorm"],
                 "converged": converged}
        return CoupledStep(f, state, dt).finish(d, T, stats)

    return step


def run(deck, callbacks=None, device="cuda") -> drv.RunResult:
    device = resolve_device(device)
    check_supported(deck)
    timers = Timers()
    with timers("setup"):
        f = build_field(deck, device=device)
        state = init_state(f)
    cfg = deck.sections["tsi_dynamic"]
    state, agg = drv.time_loop(
        "tsi", state, lambda dt: make_step(f, dt), cfg["timestep"],
        cfg["numstep"], divercont="stop", callbacks=list(callbacks or []),
        timers=timers)
    return drv.RunResult(
        deck=deck,
        fields={"tsi": TsiFieldView(f),
                "structure": structure_driver.SolidFieldView(f.solid),
                "thermo": TsiThermoView(f)},
        states={"tsi": state,
                "structure": {"d": state["d"], "v": state["v"],
                              "a": state["a"], "hist": state["hist"]},
                "thermo": {"phi": state["T"], "phidot": state["Tdot"]}},
        stats={"tsi": agg, "structure": agg, "thermo": agg}, timers=timers)


class TsiFieldView:
    """Result tests of field ``tsi``: ``temp`` or the structure's
    quantities."""

    def __init__(self, f: TsiField):
        self.f = f
        self._solid = structure_driver.SolidFieldView(f.solid)

    def node_value(self, state, quantity: str, node: int):
        if quantity.lower() in ("temp", "t"):
            return float(np.asarray(state["T"].cpu())[node])
        return self._solid.node_value(state, quantity, node)


class TsiThermoView:
    """Result tests of field ``thermo`` of a TSI run."""

    def __init__(self, f: TsiField):
        self.f = f

    def node_value(self, state, quantity: str, node: int):
        if quantity.lower() in ("temp", "t", "phi"):
            return float(np.asarray(state["phi"].cpu())[node])
        raise KeyError(quantity)
