"""Structure problem driver: deck -> SolidField -> time loop.

Counterpart of fourc_tpu/physics/structure_driver.py for the solid field the
port carries: hex8, tet4 and wedge6 blocks of laws with a PK2 stress
(Neo-Hooke, SVK, ElastHyper, the mixture of such laws) or with
Gauss-point history (viscoelasthyper, the plasticity laws, the growth,
mixture-rule and muscle laws), nonlinear or linear kinematics (each
history law under the one its reference has), tech none,
fbar or eas_mild, consistent or lumped mass, statics, one-step-theta,
gen-alpha (with Rayleigh damping) and explicit central differences, Newton
with CG, GMRES or BiCGStab and a preconditioner (``gmg`` on a lattice,
``amg`` or ``gmg``'s SA-AMG fallback on general topology, ``jacobi``,
``block_jacobi`` or ``none``) or with the direct solver, Zienkiewicz-Xie
adaptive time steps, Dirichlet conditions, surface tractions, body forces,
spring-dashpot supports and the penalty volume constraint, and nodal
stresses for the result tests.
``check_supported`` names every setting of a deck that the reference
honours and the port does not carry, before anything is built; the deck
keys that the reference ignores for a structure problem stay ignored.
"""

from __future__ import annotations

import torch

from fourc_tpu_torch.core.cells import SOLID_CELLS, get_cell
from fourc_tpu_torch.core.device import resolve_device
from fourc_tpu_torch.core.mesh import _detect_structured
from fourc_tpu_torch.linalg.solvers import SOLVERS
from fourc_tpu_torch.materials import (HistoryMaterial, elastic_moduli,
                                       make_material)
from fourc_tpu_torch.ops.solid import TECHS, is_prestressed
from fourc_tpu_torch.physics import driver as drv
from fourc_tpu_torch.physics import solid as ps
from fourc_tpu_torch.physics.constraints import VolumeConstraint
from fourc_tpu_torch.physics.solid_lattice import from_lattice_state
from fourc_tpu_torch.utils.timer import Timers


def solid_params_from(deck) -> ps.SolidParams:
    dyn = deck.sections["structural_dynamic"]
    solver = deck.sections["solver"]
    return ps.SolidParams(
        kinem=dyn["kinem"],
        tech=dyn["tech"],
        dyntype=dyn["dynamictype"],
        dt=dyn["timestep"],
        theta=dyn["theta"],
        genalpha=ps.GenAlphaParams(rho_inf=dyn["rho_inf"]),
        newton=drv.newton_params_from(dyn, solver),
        precond=solver["precond"],
        mass="lumped" if dyn["lumpmass"] else "consistent",
        rayleigh_alpha=dyn["m_damp"],
        rayleigh_beta=dyn["k_damp"],
        predictor=dyn["predict"],
    )


def check_supported(deck, disc_name="structure"):
    """Raise NotImplementedError naming every setting of ``deck`` that the
    reference honours and the port does not carry.  Cheap: reads the deck
    and the connectivity, builds nothing."""
    prob = deck.problem
    dyn = deck.sections["structural_dynamic"]
    solver = deck.sections["solver"]
    io_cfg = deck.sections["io"]
    out = []
    if prob["nshard"] > 1:
        out.append(f"problem.nshard {prob['nshard']} (one card)")
    if prob["restart"]:
        out.append("problem.restart")
    if dyn["dynamictype"] not in ps.DYNTYPES:
        out.append(f"dynamictype {dyn['dynamictype']!r}")
    if dyn["tech"] not in ("none",) + TECHS:
        out.append(f"tech {dyn['tech']!r}")
    elif dyn["tech"] == "fbar" and dyn["kinem"] != "nonlinear":
        out.append(f"tech 'fbar' under kinem {dyn['kinem']!r} (F-bar needs "
                   f"nonlinear kinematics; the reference raises too)")
    for key in ("m_damp", "k_damp"):
        if dyn[key] and dyn["dynamictype"] != "genalpha":
            out.append(f"{key} {dyn[key]!r} under dynamictype "
                       f"{dyn['dynamictype']!r} (Rayleigh damping is ported "
                       f"for genalpha)")
    implicit = dyn["dynamictype"] != "explicit"
    if implicit and solver["method"] not in SOLVERS:
        out.append(f"solver.method {solver['method']!r} "
                   f"({', '.join(SOLVERS)} are ported)")
    iterative = implicit and solver["method"] != "direct"
    if iterative and solver["precond"] not in ps.PRECONDS:
        out.append(f"solver.precond {solver['precond']!r} "
                   f"({', '.join(ps.PRECONDS)} are ported)")
    for key in ("write_vtu", "write_ensight", "monitor", "restart_interval"):
        if io_cfg[key]:
            out.append(f"io.{key}")
    if io_cfg["verbosity"] == "debug":
        out.append("io.verbosity 'debug'")
    others = sorted(set(deck.disc) - {disc_name})
    if others:
        out.append(f"discretizations {others} (beam, shell or constraint "
                   f"fields)")
    mats = {}
    for mid, spec in deck.materials.items():
        try:
            mats[mid] = make_material(spec)
        except NotImplementedError as e:
            out.append(str(e))
    disc = deck.disc.get(disc_name)
    if disc is not None:
        block_mat = {key: mats[int(blk.mat_id[0])]
                     for key, blk in disc.blocks.items()
                     if int(blk.mat_id[0]) in mats}
        out += ps.unsupported_blocks(disc, block_mat)
        multigrid = iterative and solver["precond"] in ("gmg", "amg")
        out += ps.unsupported_history(block_mat, dyn["kinem"], dyn["tech"])
        for key, m in block_mat.items():
            if is_prestressed(m) and dyn["k_damp"]:
                out.append(f"element block {key!r}: MULF prestress under "
                           f"k_damp")
            second = ("tech 'eas_mild'" if dyn["tech"] == "eas_mild"
                      else "k_damp" if dyn["k_damp"] else None)
            if second and getattr(m, "first_order_only", False):
                out.append(f"element block {key!r}: summand isoogden under "
                           f"{second} (its stress is exact to first order, "
                           f"and {second} takes its second derivative)")
            if multigrid and elastic_moduli(m) is None:
                out.append(f"element block {key!r}: material "
                           f"{type(m).__name__} under solver.precond "
                           f"{solver['precond']!r} (SA-AMG assembles a "
                           f"linear-elastic operator from youngs and nue)")
        lattice = (len(block_mat) == len(disc.blocks)
                   and ps.takes_lattice_path(disc, block_mat, dyn["kinem"],
                                             dyn["tech"])
                   and _detect_structured(
                       disc, next(iter(disc.blocks.values()))) is not None)
        if iterative and solver["precond"] == "amg" and lattice:
            out.append("solver.precond 'amg' on a lattice mesh (SA-AMG is "
                       "ported for general topology; a lattice takes 'gmg')")
        stresses = [t for t in deck.result_tests
                    if str(t.get("quantity", "")).lower().startswith(
                        "stress_")]
        for key, blk in disc.blocks.items():
            if stresses and isinstance(block_mat.get(key), HistoryMaterial):
                out.append(f"nodal stresses of element block {key!r} "
                           f"({type(block_mat[key]).__name__}, a law with "
                           f"history)")
            cell = (get_cell(blk.cell) if stresses and blk.cell in SOLID_CELLS
                    else None)
            if (cell is not None and cell.ngp < cell.nen
                    and cell.name != "tet4"):
                out.append(f"nodal stresses of element block {key!r}: "
                           f"{cell.ngp} Gauss points for {cell.nen} nodes "
                           f"(the reference's pseudo-inverse extrapolation "
                           f"is wrong there)")
    conds = deck.conditions.get(disc_name, {})
    for sp in conds.get("spring_dashpot", ()):
        if (any(float(c) for c in sp.get("viscosity") or ())
                and dyn["dynamictype"] in ("onesteptheta", "explicit")):
            out.append(f"spring_dashpot viscosity {list(sp['viscosity'])} "
                       f"under dynamictype {dyn['dynamictype']!r} (the "
                       f"reference drops the dashpot there: its "
                       f"one-step-theta and explicit steps pass no u_old)")
    for con in conds.get("constraint", ()):
        kind = str(con.get("kind", "volume")).lower()
        enforcement = str(con.get("enforcement", "penalty"))
        if kind != "volume":
            out.append(f"constraint kind {kind!r} (volume is ported)")
        elif enforcement != "penalty":
            out.append(f"constraint enforcement {enforcement!r} (penalty is "
                       f"ported)")
        else:
            cells = sorted({fb.cell for fb in con["faces"]} - {"quad4"})
            if cells:
                out.append(f"constraint faces {cells}")
    for nb in conds.get("neumann", ()):
        if nb.kind != "traction":
            out.append(f"neumann kind {nb.kind!r}")
        cells = sorted({fb.cell for fb in nb.faces} - {"quad4"})
        if cells:
            out.append(f"neumann faces {cells}")
    if out:
        raise NotImplementedError("not ported: " + "; ".join(out))


def build_field(deck, disc_name="structure", device="cuda",
                general=False) -> ps.SolidField:
    """The deck's solid field; ``general`` takes general topology whatever
    the mesh (TSI: its temperatures reach the element route)."""
    disc = deck.disc[disc_name]
    materials = {mid: make_material(spec) for mid, spec in deck.materials.items()}
    conds = deck.conditions.get(disc_name, {})
    dtype = getattr(torch, deck.problem["dtype"])  # float64 by default
    constraints = [
        VolumeConstraint(c["faces"], disc.coords, disc.dim,
                         c.get("penalty", 1e6), c.get("funct", 0),
                         deck.functions, device=resolve_device(device),
                         dtype=dtype)
        for c in conds.get("constraint", ())]
    return ps.SolidField(
        disc, materials, solid_params_from(deck),
        dirichlet=conds.get("dirichlet", ()),
        neumann=conds.get("neumann", ()),
        body_forces=conds.get("body_force", ()),
        springs=conds.get("spring_dashpot", ()), constraints=constraints,
        functions=deck.functions, device=device, dtype=dtype,
        general=general,
    )


def run(deck, callbacks=None, device="cuda") -> drv.RunResult:
    device = resolve_device(device)
    check_supported(deck)
    timers = Timers()
    with timers("setup"):
        f = build_field(deck, device=device)
        state = ps.compute_initial_state(f, ps.init_state(f))
    dyn = deck.sections["structural_dynamic"]
    n_steps = dyn["numstep"]
    if dyn["maxtime"] is not None:
        n_steps = int(round(dyn["maxtime"] / dyn["timestep"]))
    if dyn["prestress"] == "mulf":
        # MULF's prestress phase: each converged step folds its
        # deformation into the prestretch, and d restarts from zero
        for _ in range(dyn["prestress_steps"]):
            state, _ = drv.time_loop(
                "prestress", state, lambda dt: ps.make_step(f, dt),
                dyn["timestep"], 1, divercont=dyn["divercont"],
                max_levels=dyn["maxdivconrefinementlevel"], timers=timers,
                verbose=False)
            state = ps.update_prestress(f, state)
    if dyn["timada_kind"] == "zienkiewicz_xie":
        state, agg = drv.time_loop_adaptive(
            "structure", state, lambda dt: ps.make_step(f, dt),
            dyn["timestep"],
            t_end=float(state["t"]) + n_steps * dyn["timestep"],
            error_fn=ps.make_zienxie_error_fn(f), tol=dyn["timada_tol"],
            dtmin=dyn["timada_dtmin"], dtmax=dyn["timada_dtmax"],
            safety=dyn["timada_safety"], callbacks=list(callbacks or []),
            timers=timers,
        )
    else:
        state, agg = drv.time_loop(
            "structure", state, lambda dt: ps.make_step(f, dt),
            dyn["timestep"], n_steps, divercont=dyn["divercont"],
            max_levels=dyn["maxdivconrefinementlevel"],
            callbacks=list(callbacks or []), timers=timers,
        )
    return drv.RunResult(
        deck=deck, fields={"structure": SolidFieldView(f)},
        states={"structure": state},
        stats={"structure": agg}, timers=timers,
    )


class SolidFieldView:
    """Result-test access to a solid field: nodal displacement, velocity
    and acceleration components, read from flat dof vectors (a lattice
    field's state is in the padded lattice layout), and nodal Cauchy
    stresses ``stress_xx`` ... ``stress_zx`` (``SolidField.nodal_stresses``
    at the state's displacement)."""

    _VEC = {"disp": "d", "vel": "v", "acc": "a"}
    _COMP = {"x": 0, "y": 1, "z": 2}

    def __init__(self, f):
        self.f = f

    def flat_state(self, state):
        return from_lattice_state(self.f, state)

    def node_value(self, state, quantity: str, node: int):
        q = quantity.lower()
        if q.startswith("stress_"):
            ij = q.split("_")[1]
            i, j = self._COMP[ij[0]], self._COMP[ij[1]]
            sig = self.f.nodal_stresses(state["d"])
            return float(sig[node, i, j])
        if q[:-1] in self._VEC and q[-1] in self._COMP:
            vec = self.flat_state(state)[self._VEC[q[:-1]]]
            return float(vec.reshape(-1, self.f.ndpn)[node, self._COMP[q[-1]]])
        raise KeyError(f"unknown structure quantity {quantity!r}")
