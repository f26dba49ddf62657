"""Pure ALE problem driver: deck -> AleField -> prescribed-motion loop.

Counterpart of fourc_tpu/physics/ale_driver.py: every node of a Dirichlet
condition is a moving-interface node whose displacement follows
VAL * FUNCT(x, t) (all mesh-displacement components constrained); the
interior follows the deck's smoother (``ale_dynamic.method``) every step,
one CG solve per coordinate (laplace) or one for all (elastic), and the
mesh velocity is the backward difference of the displacements.  The
linear problem has no Newton loop: the summary line counts its CG
iterations as Krylov iterations.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from fourc_tpu_torch.core.conditions import DirichletHandler
from fourc_tpu_torch.core.device import resolve_device
from fourc_tpu_torch.physics import driver as drv
from fourc_tpu_torch.physics.ale import AleField
from fourc_tpu_torch.utils.timer import Timers


def moving_nodes(dbcs, disc, functions):
    """(DirichletHandler of the conditions, the ids of the nodes they
    move), after checking that each constrains every component."""
    for c in dbcs:
        if any(not o for o in c.onoff[:disc.dim]):
            raise ValueError(
                "ale Dirichlet conditions must constrain all mesh-"
                "displacement components (onoff = all ones); per-component"
                " sliding interfaces are not supported yet")
    handler = DirichletHandler(dbcs, np.asarray(disc.coords), disc.dim,
                               functions)
    fixed = ~np.asarray(handler.free_mask).reshape(-1, disc.dim)
    return handler, np.nonzero(fixed.any(axis=1))[0]


def check_supported(deck):
    """Raise NotImplementedError naming what the port does not carry of an
    ALE deck, before anything is built."""
    out = []
    disc = next(iter(deck.disc.values()))
    if deck.sections["ale_dynamic"]["method"] == "elastic" and disc.dim != 3:
        out.append(f"ALE method 'elastic' on a {disc.dim}D mesh (it needs "
                   f"the 2D structure field)")
    for key in ("write_vtu", "write_ensight", "monitor", "restart_interval"):
        if deck.sections["io"][key]:
            out.append(f"io.{key}")
    if deck.problem["restart"]:
        out.append("problem.restart")
    if out:
        raise NotImplementedError("not ported: " + "; ".join(out))


def run(deck, callbacks=None, device="cuda") -> drv.RunResult:
    device = resolve_device(device)
    check_supported(deck)
    timers = Timers()
    dyn = deck.sections["ale_dynamic"]
    name = next(iter(deck.disc))
    disc = deck.disc[name]
    dim = disc.dim
    dbcs = list(deck.conditions.get(name, {}).get("dirichlet", ()))
    if not dbcs:
        raise ValueError("ale problem needs at least one Dirichlet "
                         "condition (the moving interface)")
    dtype = getattr(torch, deck.problem["dtype"])
    with timers("setup"):
        handler, moving = moving_nodes(dbcs, disc, deck.functions)
        field = AleField(disc, interface_nodes=moving, boundary_nodes=(),
                         method=dyn["method"], device=device, dtype=dtype)
    dt, inv_dt = float(dyn["timestep"]), 1.0 / float(dyn["timestep"])
    zero = torch.zeros((disc.n_nodes, dim), dtype=dtype, device=device)
    state = {"d": zero, "v": zero, "t": 0.0, "step": 0}
    agg = {"newton_iters": 0, "lin_iters": 0, "steps": 0, "substeps": 0}
    t_wall = time.perf_counter()
    for _ in range(int(dyn["numstep"])):
        with timers("step"):
            t1 = state["t"] + dt
            uD = torch.as_tensor(handler.values(t1).reshape(-1, dim)[moving],
                                 dtype=dtype, device=device)
            d1 = field.solve(uD, tol=float(dyn["tolres"]),
                             maxiter=int(dyn["maxiter"]))
            state = {"d": d1, "v": (d1 - state["d"]) * inv_dt, "t": t1,
                     "step": state["step"] + 1}
        agg["steps"] += 1
        agg["substeps"] += 1
        agg["lin_iters"] += field.last_iters
        for cb in callbacks or ():
            cb("ale", state, agg)
    agg["walltime"] = time.perf_counter() - t_wall
    print(f"[ale] {agg['steps']} steps ({agg['substeps']} substeps), 0 Newton "
          f"its, {agg['lin_iters']} Krylov its, {agg['walltime']:.3f}s wall")
    return drv.RunResult(
        deck=deck, fields={"ale": AleView(field)}, states={"ale": state},
        stats={"ale": agg}, timers=timers)


class AleView:
    """Result-test access: ``dispx`` ... of the mesh displacement and
    ``velx`` ... of the mesh velocity."""

    def __init__(self, f: AleField):
        self.f = f

    def node_value(self, state, quantity, node):
        q = quantity.lower()
        for prefix, key in (("disp", "d"), ("vel", "v")):
            if q.startswith(prefix):
                comp = "xyz".index(q[len(prefix)])
                return float(state[key][node, comp])
        raise KeyError(quantity)
