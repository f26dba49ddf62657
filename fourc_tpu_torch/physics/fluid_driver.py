"""Fluid problem driver: deck -> FluidField -> time loop.

Counterpart of fourc_tpu/physics/fluid_driver.py: ``check_supported``
(what the port refuses of a fluid deck, named before anything is built),
``build_field``, ``run`` and ``FluidFieldView`` for the result tests
(``velx``/``vely``/``velz`` and ``pressure``).
"""

from __future__ import annotations

import numpy as np
import torch

from fourc_tpu_torch.core.cells import FACE_TYPE, VOLUME_CELLS
from fourc_tpu_torch.core.device import resolve_device
from fourc_tpu_torch.materials import make_material
from fourc_tpu_torch.physics import driver as drv
from fourc_tpu_torch.physics import fluid as pf
from fourc_tpu_torch.utils.timer import Timers


def check_supported(deck, disc_name="fluid", ale=False):
    """Raise NotImplementedError naming what the port does not carry of a
    fluid deck, before anything is built."""
    out = []
    prob, dyn = deck.problem, deck.sections["fluid_dynamic"]
    if prob["nshard"] > 1:
        out.append(f"problem.nshard {prob['nshard']} (one card)")
    if prob["restart"]:
        out.append("problem.restart")
    for key in ("write_vtu", "write_ensight", "monitor", "restart_interval"):
        if deck.sections["io"][key]:
            out.append(f"io.{key}")
    if dyn["turbulence_model"] not in pf.TURBULENCE_MODELS:
        out.append(f"fluid_dynamic.turbulence_model "
                   f"{dyn['turbulence_model']!r}")
    if dyn["sampling_start"]:
        out.append("fluid_dynamic.sampling_start (turbulence statistics)")
    if dyn["timada_kind"] != "none":
        out.append(f"fluid_dynamic.timada_kind {dyn['timada_kind']!r}")
    if ale and dyn["dynamictype"] != "onesteptheta":
        out.append(f"fluid_ale under dynamictype {dyn['dynamictype']!r} "
                   f"(onesteptheta is ported)")
    disc = deck.disc.get(disc_name) or next(iter(deck.disc.values()))
    cells = VOLUME_CELLS.get(disc.dim)
    if cells is None:
        out.append(f"a {disc.dim}D mesh")
    for key, blk in disc.blocks.items():
        if cells is not None and blk.cell not in cells:
            out.append(f"element block {key!r} of cell {blk.cell!r} in a "
                       f"{disc.dim}D fluid ({', '.join(cells)} ported)")
    conds = deck.conditions.get(disc_name, {})
    faces = {FACE_TYPE.get(c) for c in cells or ()}
    for kind in ("neumann", "windkessel"):
        for nb in conds.get(kind, ()):
            bad = sorted({fb.cell for fb in (nb.faces if kind == "neumann"
                                             else nb["faces"])} - faces)
            if bad:
                out.append(f"{kind} faces {bad}")
    for kind in ("spring_dashpot", "constraint"):
        if conds.get(kind):
            out.append(f"{kind} conditions on a fluid field")
    for spec in deck.materials.values():
        try:
            make_material(spec)
        except NotImplementedError as e:
            out.append(str(e))
    if out:
        raise NotImplementedError("not ported: " + "; ".join(out))


def build_field(deck, disc_name="fluid", device="cuda") -> pf.FluidField:
    cond_name = disc_name
    if disc_name not in deck.disc and len(deck.disc) == 1:
        disc_name = next(iter(deck.disc))
    disc = deck.disc[disc_name]
    dyn = deck.sections["fluid_dynamic"]
    params = pf.FluidParams(
        dyntype=dyn["dynamictype"],
        dt=dyn["timestep"],
        theta=dyn["theta"],
        rho_inf=dyn["rho_inf"],
        newton=drv.newton_params_from(dyn, deck.sections["solver"]),
        initial_funct=dyn.get("initialfield_funct", 0),
        smagorinsky_cs=dyn.get("smagorinsky_cs", 0.0) or 0.0,
        turbulence_model=dyn.get("turbulence_model", "none"),
        csgs=dyn.get("csgs", 0.25) or 0.25,
        stab=dyn.get("stab", "taylor") != "zero",
    )
    materials = {mid: make_material(spec)
                 for mid, spec in deck.materials.items()}
    conds = deck.conditions.get(cond_name, {})
    return pf.FluidField(
        disc, materials, params,
        dirichlet=conds.get("dirichlet", ()),
        neumann=conds.get("neumann", ()),
        body_forces=conds.get("body_force", ()),
        functions=deck.functions,
        windkessel=conds.get("windkessel", ()),
        device=device, dtype=getattr(torch, deck.problem["dtype"]))


def run(deck, callbacks=None, device="cuda") -> drv.RunResult:
    device = resolve_device(device)
    check_supported(deck)
    timers = Timers()
    with timers("setup"):
        f = build_field(deck, device=device)
        state = pf.init_state(f)
    dyn = deck.sections["fluid_dynamic"]
    n_steps = dyn["numstep"]
    if dyn["maxtime"] is not None:
        n_steps = int(round(dyn["maxtime"] / dyn["timestep"]))
    state, agg = drv.time_loop(
        "fluid", state, lambda dt: pf.make_step(f, dt), dyn["timestep"],
        n_steps, divercont=dyn["divercont"],
        max_levels=dyn["maxdivconrefinementlevel"],
        callbacks=list(callbacks or []), timers=timers)
    return drv.RunResult(
        deck=deck, fields={"fluid": FluidFieldView(f)},
        states={"fluid": state}, stats={"fluid": agg}, timers=timers)


class FluidFieldView:
    """Result-test access: ``velx``/``vely``/``velz`` and ``pressure``."""

    _COMP = {"x": 0, "y": 1, "z": 2}

    def __init__(self, f: pf.FluidField):
        self.f = f

    def node_value(self, state, quantity: str, node: int):
        q = quantity.lower()
        xn = np.asarray(state["x"].cpu()).reshape(-1, self.f.ndpn)
        if q in ("pressure", "p"):
            return float(xn[node, self.f.dim])
        if q.startswith("vel"):
            comp = self._COMP[q[-1]]
            if comp >= self.f.dim:  # velz of a 2D fluid
                raise KeyError(f"no component {quantity!r} in "
                               f"{self.f.dim}D")
            return float(xn[node, comp])
        raise KeyError(f"unknown fluid quantity {quantity!r}")
