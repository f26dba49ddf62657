"""Scatra and thermo problem drivers: deck -> ScalarField -> time loop.

Counterpart of fourc_tpu/physics/scalar_driver.py: ``build_field`` (also
the thermo field of a TSI deck, which names only a structure mesh: the
thermo field clones it, and its conditions stay keyed by the field's
name), ``run_scatra``, ``run_thermo`` and ``ScalarFieldView`` for the
result tests (``phi``/``scalar`` of scatra, ``temp``/``t`` of thermo, and
the rates).
"""

from __future__ import annotations

import numpy as np
import torch

from fourc_tpu_torch.core.cells import FACE_TYPE, VOLUME_CELLS
from fourc_tpu_torch.core.device import resolve_device
from fourc_tpu_torch.materials import make_material
from fourc_tpu_torch.ops.scalar import TAU_KINDS
from fourc_tpu_torch.physics import driver as drv
from fourc_tpu_torch.physics import scalar_transport as st
from fourc_tpu_torch.utils.timer import Timers


def check_supported(deck, section, disc_name):
    """Raise NotImplementedError naming what the port does not carry of a
    scalar field's deck, before anything is built."""
    out = []
    prob, dyn = deck.problem, deck.sections[section]
    if prob["nshard"] > 1:
        out.append(f"problem.nshard {prob['nshard']} (one card)")
    if prob["restart"]:
        out.append("problem.restart")
    for key in ("write_vtu", "write_ensight", "monitor", "restart_interval"):
        if deck.sections["io"][key]:
            out.append(f"io.{key}")
    if dyn["stab"] not in TAU_KINDS:
        out.append(f"{section}.stab {dyn['stab']!r}")
    disc = deck.disc.get(disc_name) or next(iter(deck.disc.values()))
    cells = VOLUME_CELLS.get(disc.dim)
    if cells is None:
        out.append(f"a {disc.dim}D mesh")
    for key, blk in disc.blocks.items():
        if cells is not None and blk.cell not in cells:
            out.append(f"element block {key!r} of cell {blk.cell!r} in a "
                       f"{disc.dim}D scalar field ({', '.join(cells)} "
                       f"ported)")
    conds = deck.conditions.get(_field_of(section), {})
    for nb in conds.get("neumann", ()):
        cells = sorted({fb.cell for fb in nb.faces}
                       - {FACE_TYPE.get(c) for c in cells or ()})
        if cells:
            out.append(f"neumann faces {cells}")
    for kind in ("spring_dashpot", "constraint"):
        if conds.get(kind):
            out.append(f"{kind} conditions on a scalar field")
    for mid, spec in deck.materials.items():
        try:
            make_material(spec)
        except NotImplementedError as e:
            out.append(str(e))
    if out:
        raise NotImplementedError("not ported: " + "; ".join(out))


def _field_of(section):
    return {"scatra_dynamic": "scatra", "thermal_dynamic": "thermo"}[section]


def build_field(deck, section: str, disc_name: str,
                device="cuda") -> st.ScalarField:
    """The scalar field of ``section`` on the mesh ``disc_name`` (a TSI
    deck's only mesh where it has none of that name)."""
    cond_name = disc_name
    if disc_name not in deck.disc:
        if len(deck.disc) == 1:
            disc_name = next(iter(deck.disc))
        elif "structure" in deck.disc:
            disc_name = "structure"
    disc = deck.disc[disc_name]
    dyn = deck.sections[section]
    params = st.ScalarParams(
        dyntype=dyn["dynamictype"],
        dt=dyn["timestep"],
        n_steps=dyn["numstep"],
        theta=dyn["theta"],
        genalpha=st.GenAlphaScalarParams(
            rho_inf=dyn["rho_inf"], alpha_f_in=dyn.get("alpha_f"),
            alpha_m_in=dyn.get("alpha_m"), gamma_in=dyn.get("gamma")),
        newton=drv.newton_params_from(dyn, deck.sections["solver"]),
        stab=dyn.get("stab", "taylor"),
        velocity=dyn.get("velocity"),
        initial_funct=dyn.get("initialfield_funct", 0),
        divercont=dyn["divercont"],
        max_halvings=dyn["maxdivconrefinementlevel"],
    )
    # convection makes the operator nonsymmetric: CG would stall (the
    # reference switches without a word)
    if params.velocity is not None and params.newton.lin_method == "cg":
        print(f"[{cond_name}] convective velocity: solver cg switched to "
              f"bicgstab (nonsymmetric operator)")
        params.newton.lin_method = "bicgstab"
    materials = {mid: make_material(spec)
                 for mid, spec in deck.materials.items()}
    conds = deck.conditions.get(cond_name, {})
    return st.ScalarField(
        disc, materials, params,
        dirichlet=conds.get("dirichlet", ()),
        neumann=conds.get("neumann", ()),
        body_forces=conds.get("body_force", ()),
        functions=deck.functions, device=device,
        dtype=getattr(torch, deck.problem["dtype"]))


def _run_generic(deck, fieldname, section, callbacks=None, device="cuda"):
    device = resolve_device(device)
    check_supported(deck, section, fieldname)
    timers = Timers()
    with timers("setup"):
        f = build_field(deck, section, fieldname, device=device)
        state = st.compute_initial_state(f, st.init_state(f))
    dyn = deck.sections[section]
    n_steps = dyn["numstep"]
    if dyn["maxtime"] is not None:
        n_steps = int(round(dyn["maxtime"] / dyn["timestep"]))
    state, agg = drv.time_loop(
        fieldname, state, lambda dt: st.make_step(f, dt), dyn["timestep"],
        n_steps, divercont=dyn["divercont"],
        max_levels=dyn["maxdivconrefinementlevel"],
        callbacks=list(callbacks or []), timers=timers)
    return drv.RunResult(
        deck=deck, fields={fieldname: ScalarFieldView(f, fieldname)},
        states={fieldname: state}, stats={fieldname: agg}, timers=timers)


def run_scatra(deck, callbacks=None, device="cuda"):
    return _run_generic(deck, "scatra", "scatra_dynamic", callbacks, device)


def run_thermo(deck, callbacks=None, device="cuda"):
    return _run_generic(deck, "thermo", "thermal_dynamic", callbacks, device)


class ScalarFieldView:
    """Result-test access to a scalar field's nodal values and rates."""

    def __init__(self, f: st.ScalarField, fieldname: str):
        self.f = f
        self.names = {"phi", "scalar"} if fieldname == "scatra" \
            else {"temp", "t"}

    def node_value(self, state, quantity: str, node: int):
        q = quantity.lower()
        if q in self.names or q in ("phi", "temp"):
            return float(np.asarray(state["phi"].cpu())[node])
        if q in ("phidot", "rate", "tempdot"):
            return float(np.asarray(state["phidot"].cpu())[node])
        raise KeyError(f"unknown scalar quantity {quantity!r}")
