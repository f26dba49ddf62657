"""Global problem driver: deck -> field -> time loop -> result tests.

Counterpart of fourc_tpu/physics/driver.py for structure, thermo, scatra,
TSI, fluid, ALE and fluid-on-ALE problems: ``run`` dispatches a deck,
``time_loop`` advances a field with the reference's DIVERCONT handling,
``time_loop_adaptive`` with its error-controlled (Zienkiewicz-Xie) step
size, ``newton_params_from`` maps the deck's Newton and solver settings.
Every other problem type, sharding over several devices and restarts are
not ported.

The host loop only calls step functions, reads the convergence flag they
return, refines the time step on divergence and calls the callbacks; the
numerics stay on the field's device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from fourc_tpu_torch.io import deck as deck_mod
from fourc_tpu_torch.physics.newton import NewtonParams
from fourc_tpu_torch.utils.timer import Timers


@dataclass
class RunResult:
    deck: object
    fields: dict  # name -> field view (node_value)
    states: dict  # name -> final state dict
    stats: dict = field(default_factory=dict)  # special quantities
    timers: object = None

    def query(self, fieldname, quantity, node):
        name = fieldname or next(iter(self.fields))
        f = self.fields[name]
        return f.node_value(self.states[name], quantity, node)

    def query_special(self, fieldname, quantity):
        name = fieldname or next(iter(self.fields))
        return self.stats[name][quantity]


def run(deck_src, callbacks=None, device="cuda") -> RunResult:
    """Run a deck end to end on ``device`` (the CUDA card unless the CPU is
    asked for).  deck_src: path | yaml str | dict | Deck."""
    deck = deck_src if isinstance(deck_src, deck_mod.Deck) else deck_mod.load(deck_src)
    ptype = deck.problem_type
    if ptype == "structure":
        from fourc_tpu_torch.physics import structure_driver

        return structure_driver.run(deck, callbacks=callbacks, device=device)
    if ptype in ("scatra", "thermo"):
        from fourc_tpu_torch.physics import scalar_driver

        run_field = (scalar_driver.run_scatra if ptype == "scatra"
                     else scalar_driver.run_thermo)
        return run_field(deck, callbacks=callbacks, device=device)
    if ptype == "tsi":
        from fourc_tpu_torch.physics import tsi_driver

        return tsi_driver.run(deck, callbacks=callbacks, device=device)
    if ptype == "fluid":
        from fourc_tpu_torch.physics import fluid_driver

        return fluid_driver.run(deck, callbacks=callbacks, device=device)
    if ptype == "ale":
        from fourc_tpu_torch.physics import ale_driver

        return ale_driver.run(deck, callbacks=callbacks, device=device)
    if ptype == "fluid_ale":
        from fourc_tpu_torch.physics import fluid_ale_driver

        return fluid_ale_driver.run(deck, callbacks=callbacks, device=device)
    raise NotImplementedError(
        f"problem type {ptype!r} is not ported "
        f"({', '.join(deck_mod.PROBLEM_TYPES)} are)")


def time_loop(
    fieldname,
    state,
    make_step,  # dt -> step fn (state -> (state, stats))
    dt0: float,
    n_steps: int,
    divercont: str = "stop",
    max_levels: int = 5,
    callbacks=None,
    timers: Timers | None = None,
    verbose: bool = True,
):
    """Run n_steps of size dt0, refining dt on divergence per DIVERCONT.

    One step function per dt, built on first use (each builds its own
    preconditioner: the mass shift depends on dt).  Returns
    (state, aggregate_stats dict).
    """
    timers = timers or Timers()
    step_fns = {}

    def get_step(dt):
        if dt not in step_fns:
            with timers("make_step"):
                step_fns[dt] = make_step(dt)
        return step_fns[dt]

    agg = {"newton_iters": 0, "lin_iters": 0, "steps": 0, "substeps": 0,
           "resnorm": 0.0, "halvings": 0}

    def try_advance(state, dt, level):
        """Advance by dt, recursively halving on divergence."""
        st_new, stats = get_step(dt)(state)
        ok = bool(stats["converged"])
        if ok:
            agg["newton_iters"] += int(stats["iters"])
            agg["lin_iters"] += int(stats["lin_iters"])
            agg["substeps"] += 1
            agg["resnorm"] = float(stats["resnorm"])
            return st_new
        if divercont == "continue":
            agg["substeps"] += 1
            return st_new
        if divercont in ("halve_step", "adapt_step") and level < max_levels:
            agg["halvings"] += 1
            half = try_advance(state, dt / 2, level + 1)
            return try_advance(half, dt / 2, level + 1)
        raise RuntimeError(
            f"{fieldname}: nonlinear solver diverged at t={float(state['t']):g} "
            f"(resnorm={float(stats['resnorm']):g}); DIVERCONT={divercont} exhausted"
        )

    t_wall = time.perf_counter()
    for k in range(n_steps):
        with timers("step"):
            state = try_advance(state, dt0, 0)
        agg["steps"] += 1
        if callbacks:
            for cb in callbacks:
                cb(fieldname, state, agg)
    agg["walltime"] = time.perf_counter() - t_wall
    if verbose:
        print(
            f"[{fieldname}] {agg['steps']} steps ({agg['substeps']} substeps), "
            f"{agg['newton_iters']} Newton its, {agg['lin_iters']} Krylov its, "
            f"{agg['walltime']:.3f}s wall"
        )
    return state, agg


def time_loop_adaptive(
    fieldname,
    state,
    make_step,  # dt -> step fn (state -> (state, stats))
    dt0: float,
    t_end: float,
    error_fn,  # (state_old, state_new, dt) -> local error estimate
    tol: float = 1e-4,
    dtmin: float | None = None,
    dtmax: float | None = None,
    safety: float = 0.9,
    order: int = 3,
    callbacks=None,
    timers: Timers | None = None,
    verbose: bool = True,
):
    """Error-controlled adaptive time stepping (Zienkiewicz-Xie style), the
    reference's controller: after each converged step the local error
    estimate is compared with ``tol``; a step with err > tol is rejected
    and retried with a smaller dt, and after an accepted step dt grows
    toward dt * safety (tol / err)^(1/order).  dt is kept on the halving
    grid dtmax / 2^j, as the reference keeps it (the decks' anchors were
    written with it; 4C's TimAdaZienXie does not quantise).  Returns
    (state, aggregate stats), with the accepted step sizes in order under
    ``dt_history``."""
    timers = timers or Timers()
    dtmax = dtmax if dtmax is not None else dt0
    dtmin = dtmin if dtmin is not None else dt0 / 64.0
    step_fns = {}

    def get_step(dt):
        if dt not in step_fns:
            with timers("make_step"):
                step_fns[dt] = make_step(dt)
        return step_fns[dt]

    def quantize(dt):
        j = int(np.ceil(np.log2(dtmax / max(dt, dtmin)) - 1e-12))
        return dtmax / 2 ** max(0, j)

    agg = {"newton_iters": 0, "lin_iters": 0, "steps": 0, "substeps": 0,
           "resnorm": 0.0, "halvings": 0, "rejections": 0, "dt_levels": set(),
           "dt_history": []}
    t = float(state["t"])
    dt = quantize(dt0)
    t_wall = time.perf_counter()
    while t < t_end - 1e-12 * max(1.0, abs(t_end)):
        dt = min(dt, t_end - t)  # the final partial step may be off-grid
        with timers("step"):
            st_new, stats = get_step(dt)(state)
        if not bool(stats["converged"]):
            if dt / 2 < dtmin:
                raise RuntimeError(f"{fieldname}: diverged at t={t:g} with "
                                   f"dt=dtmin={dtmin:g}")
            agg["halvings"] += 1
            dt = quantize(dt / 2)
            continue
        err = float(error_fn(state, st_new, dt))
        if err > tol and dt > dtmin * (1 + 1e-12):
            agg["rejections"] += 1
            dt = quantize(max(
                dtmin, dt * max(0.25, safety * (tol / err) ** (1.0 / order))))
            continue
        state = st_new
        t = float(state["t"])
        agg["newton_iters"] += int(stats["iters"])
        agg["lin_iters"] += int(stats["lin_iters"])
        agg["substeps"] += 1
        agg["steps"] += 1
        agg["resnorm"] = float(stats["resnorm"])
        agg["dt_levels"].add(dt)
        agg["dt_history"].append(dt)
        if callbacks:
            for cb in callbacks:
                cb(fieldname, state, agg)
        fac = safety * (tol / max(err, 1e-300)) ** (1.0 / order)
        dt = quantize(min(dtmax, dt * min(4.0, max(0.25, fac))))
    agg["walltime"] = time.perf_counter() - t_wall
    agg["dt_levels"] = sorted(agg["dt_levels"])
    if verbose:
        print(
            f"[{fieldname}] adaptive: {agg['steps']} steps, "
            f"{agg['rejections']} rejections, dt levels {agg['dt_levels']}, "
            f"{agg['newton_iters']} Newton its, {agg['walltime']:.3f}s wall"
        )
    return state, agg


def newton_params_from(dyn: dict, solver: dict) -> NewtonParams:
    """The deck's Newton and linear-solver settings.  The debug table of io
    verbosity 'debug' has no field here: the structure driver refuses decks
    that set it."""
    return NewtonParams(
        max_iter=dyn["maxiter"],
        tol_res=dyn["tolres"],
        tol_res_rel=dyn.get("tolres_rel", 0.0),
        tol_disp=dyn["toldisp"],
        combine=dyn["normcombi"],
        lin_method=solver["method"],
        lin_maxiter=solver["maxiter"],
        lin_rtol=solver["rtol"],
        lin_adaptive=solver["adaptive"],
        gmres_restart=solver["gmres_restart"],
        line_search=dyn.get("linesearch", False),
        ptc=dyn.get("nlnsol", "fullnewton") == "ptc",
        ptc_dt0=dyn.get("ptc_dt0", 1.0),
    )
