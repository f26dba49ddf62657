"""Input decks: YAML with the reference's section semantics, the subset of
the structure, thermo, scatra, TSI, fluid, ALE and fluid-on-ALE problems.

Counterpart of fourc_tpu/io/deck.py for the decks the port runs: the same
schema (``param``/``group``/``validate``/``describe``), the same defaults
and the same ValueError on a malformed deck, for the sections of a
structure, thermo, scatra, TSI, fluid, ALE or fluid-on-ALE problem
(``problem``, ``structural_dynamic``, ``thermal_dynamic``,
``scatra_dynamic``, ``tsi_dynamic``, ``fluid_dynamic``, ``ale_dynamic``,
``solver``, ``io``, ``materials``, ``functions`` (an
expression per component, or a ``multifunction`` of time), ``geometry``,
``conditions`` (a condition's ``field`` names the field it acts on, e.g.
``thermo`` on a TSI deck's one mesh), ``result_description``, ``title``).
Geometry comes from the ``box``
generator (with ``jitter`` and ``permute``), the 2D ``rectangle`` generator
(quad4) or from explicit ``nodes``, ``elements``, ``node_sets`` and
``face_sets``; conditions are ``dirichlet``, ``neumann``, ``body_force``,
``spring_dashpot``, ``constraint``, ``ale_dirichlet`` (prescribed mesh
motion) and ``windkessel_outflow`` (its faces and nodes resolved to the
mesh's sets, the rest as written; each driver refuses the kinds it does not
carry).  Whatever else the reference reads (another field's section,
another generator, ``exodus``, two generators of one mesh, another
condition kind, another problem type, a FUNCT of another kind) raises
NotImplementedError naming it as not ported.

Deck layout (one YAML document):

  problem:            {type: structure, dtype: float64|float32}
  structural_dynamic: integrator + Newton + solver settings  ("STRUCTURAL DYNAMIC")
  solver:             Krylov method + preconditioner         ("SOLVER 1")
  materials:          {id: {type: ..., params...}}           ("MATERIALS")
  functions:          {id: expr | [expr per component]}      ("FUNCT1..")
  geometry:           generator | explicit nodes/elements    ("NODE COORDS"/"STRUCTURE ELEMENTS")
  conditions:         dirichlet/neumann/body_force/
                      spring_dashpot/constraint              ("DESIGN ... CONDITIONS")
  result_description: list of nodal checks                   ("RESULT DESCRIPTION")
"""

from __future__ import annotations

import io as _io
from dataclasses import dataclass

import numpy as np

from fourc_tpu_torch.core import gridgen
from fourc_tpu_torch.core.conditions import BodyForce, DirichletBC, NeumannBC
from fourc_tpu_torch.core.functions import FunctionManager
from fourc_tpu_torch.core.mesh import Discretization, FaceBlock


# ---------------------------------------------------------------------------
# minimal InputSpec-style schema (validate + defaults + self-description)
# ---------------------------------------------------------------------------


@dataclass
class param:
    typ: object
    default: object = None
    required: bool = False
    choices: tuple | None = None
    doc: str = ""


@dataclass
class group:
    specs: dict
    required: bool = False
    doc: str = ""


def validate(spec: dict, data: dict, path="") -> dict:
    """Validate a mapping against a spec dict; returns defaulted copy."""
    data = dict(data or {})
    out = {}
    known = set()
    for key, s in spec.items():
        known.add(key)
        if isinstance(s, group):
            sub = data.get(key)
            if sub is None:
                if s.required:
                    raise ValueError(f"deck: missing required section {path}{key}")
                out[key] = validate(s.specs, {}, path=f"{path}{key}.") if s.specs else {}
            else:
                out[key] = validate(s.specs, sub, path=f"{path}{key}.")
        elif isinstance(s, param):
            if key in data:
                v = data[key]
                if s.typ in (int, float) and v is not None:
                    v = s.typ(v)
                if s.typ is str and isinstance(v, str):
                    v = v.lower()
                if s.choices and v not in s.choices:
                    raise ValueError(
                        f"deck: {path}{key} = {v!r} not in {s.choices}"
                    )
                out[key] = v
            elif s.required:
                raise ValueError(f"deck: missing required parameter {path}{key}")
            else:
                out[key] = s.default
        else:  # raw passthrough
            out[key] = data.get(key, s)
    for key in data:
        if key not in known:
            raise ValueError(f"deck: unknown key {path}{key}")
    return out


def describe(spec: dict, indent=0) -> str:
    """Self-describing schema dump (analog of the reference's --parameters)."""
    lines = []
    for key, s in spec.items():
        if isinstance(s, group):
            lines.append("  " * indent + f"{key}:  # {s.doc}")
            lines.append(describe(s.specs, indent + 1))
        elif isinstance(s, param):
            t = getattr(s.typ, "__name__", str(s.typ))
            extra = f" choices={list(s.choices)}" if s.choices else ""
            lines.append(
                "  " * indent + f"{key}: {t} = {s.default!r}{extra}  # {s.doc}"
            )
    return "\n".join(l for l in lines if l)


# field dynamic sections share this shape (ref: 4C_inpar_structure.cpp:62-586)
def _dyn_spec(default_dyntype, dyntypes):
    return group(
        {
            "dynamictype": param(str, default_dyntype, choices=dyntypes, doc="time integrator"),
            "kinem": param(str, "nonlinear", choices=("linear", "nonlinear"), doc="kinematics"),
            "tech": param(str, "none", choices=("none", "fbar", "eas_mild"),
                          doc="element technology (ref TECH flag)"),
            "timestep": param(float, 1.0, doc="dt"),
            "numstep": param(int, 1, doc="number of steps"),
            "maxtime": param(float, None, doc="final time (overrides numstep)"),
            "theta": param(float, 0.5, doc="one-step-theta parameter"),
            "rho_inf": param(float, 1.0, doc="gen-alpha spectral radius"),
            "alpha_f": param(float, None,
                             doc="explicit gen-alpha ALPHA_F (overrides rho_inf)"),
            "alpha_m": param(float, None,
                             doc="explicit gen-alpha ALPHA_M (overrides rho_inf)"),
            "gamma": param(float, None,
                           doc="explicit gen-alpha GAMMA (overrides rho_inf)"),
            "maxiter": param(int, 20, doc="Newton max iterations"),
            "tolres": param(float, 1e-8, doc="abs residual norm tol (NORM_RESF)"),
            "tolres_rel": param(float, 0.0, doc="relative residual tol (NORM_RESF Rel)"),
            "toldisp": param(float, 1e-8, doc="abs increment norm tol (NORM_DISP)"),
            "normcombi": param(str, "and", choices=("and", "or")),
            "predict": param(str, "constdis",
                             choices=("constdis", "constvel", "constvelacc", "tangdis")),
            "divercont": param(
                str, "stop", choices=("stop", "continue", "halve_step", "adapt_step"),
                doc="Newton divergence action (ref DIVERCONT)",
            ),
            "maxdivconrefinementlevel": param(int, 5),
            # error-controlled time adaptivity (ref: TIMEADAPTIVITY /
            # TimAdaZienXie, src/adapter/4C_adapter_str_timeada.cpp)
            "timada_kind": param(str, "none",
                                 choices=("none", "zienkiewicz_xie"),
                                 doc="a-posteriori dt adaptivity"),
            "timada_tol": param(float, 1e-4, doc="local error tolerance"),
            "timada_dtmin": param(float, None, doc="min dt (default dt/64)"),
            "timada_dtmax": param(float, None, doc="max dt (default dt)"),
            "timada_safety": param(float, 0.9),
            "lumpmass": param(bool, False),
            "m_damp": param(float, 0.0, doc="Rayleigh mass damping"),
            "k_damp": param(float, 0.0, doc="Rayleigh stiffness damping"),
            "linesearch": param(bool, False),
            "nlnsol": param(str, "fullnewton", choices=("fullnewton", "ptc"),
                            doc="nonlinear solver (ref NLNSOL)"),
            "ptc_dt0": param(float, 1.0, doc="PTC initial pseudo time step"),
            "stab": param(
                str, "taylor", choices=("zero", "taylor", "franca_valentin"),
                doc="SUPG tau definition (scalar transport; ref STABTYPE/DEFINITION_TAU)",
            ),
            "velocity": None,  # convective velocity expressions (scatra)
            "initialfield_funct": param(int, 0, doc="initial field function id"),
            "smagorinsky_cs": param(float, 0.0,
                                    doc="LES Smagorinsky constant (fluid; 0=off)"),
            "turbulence_model": param(
                str, "none", choices=("none", "smagorinsky",
                                      "dynamic_smagorinsky",
                                      "multifractal", "avm3"),
                doc="LES model (ref PHYSICAL_MODEL in TURBULENCE MODEL)"),
            "csgs": param(float, 0.25,
                          doc="multifractal SGS coefficient (ref CSGS)"),
            "sampling_start": param(
                int, 0,
                doc="turbulence statistics: first sampled step (0=off; "
                    "ref SAMPLING_START in TURBULENCE MODEL)"),
            "prestress": param(str, "none", choices=("none", "mulf"),
                               doc="prestressing technology (ref PRESTRESS)"),
            "prestress_steps": param(int, 0),
            "bts_penalty": param(float, 1e4,
                                 doc="beam-to-solid tying penalty (ref "
                                     "BEAM TO SOLID VOLUME MESHTYING)"),
        },
        doc="field time integration",
    )


DECK_SPEC = {
    "title": param(str, ""),
    "problem": group(
        {
            "type": param(
                str, "structure",
                choices=("structure", "scatra", "thermo", "fluid", "tsi", "ale",
                         "fsi", "ssi", "particle", "lubrication", "elch",
                         "poroelasticity", "poroelast_scatra",
                         "cardiovascular0d",
                         "cardiac_monodomain", "artery", "red_airways",
                         "porofluidmultiphase", "loma", "sti", "ssti", "ehl", "fs3i", "fpsi",
                         "fbi", "levelset", "pasi", "immersed_fsi",
                         "fluid_xfem", "fsi_xfem", "fluid_ale",
                         "porofluid_elast", "porofluid_elast_scatra",
                         "browniandyn"),
            ),
            "restart": param(int, 0),
            "dtype": param(str, "float64", choices=("float32", "float64")),
            # device-mesh domain decomposition (the reference's mpirun -np N);
            # the port runs on one card and refuses nshard > 1
            "nshard": param(int, 0, doc="shard fields over N devices (0=off)"),
        },
        required=True,
        doc="PROBLEM TYPE section",
    ),
    "structural_dynamic": _dyn_spec(
        "statics", ("statics", "onesteptheta", "genalpha", "explicit")
    ),
    "scatra_dynamic": _dyn_spec("onesteptheta", ("stationary", "onesteptheta",
                                                 "bdf2", "genalpha")),
    "thermal_dynamic": _dyn_spec("statics", ("statics", "onesteptheta",
                                             "genalpha")),
    "fluid_dynamic": _dyn_spec("onesteptheta", ("stationary", "onesteptheta",
                                               "bdf2", "genalpha")),
    "ale_dynamic": group(
        {
            "method": param(str, "laplace", choices=("laplace", "elastic"),
                            doc="mesh smoothing operator (ref ALE_TYPE)"),
            "timestep": param(float, 1.0),
            "numstep": param(int, 1),
            "tolres": param(float, 1e-8, doc="CG tolerance"),
            "maxiter": param(int, 400, doc="CG max iterations"),
        },
        doc="ALE DYNAMIC (pure mesh-motion problem)",
    ),
    "tsi_dynamic": group(
        {
            "coupling": param(str, "monolithic",
                              choices=("oneway", "partitioned", "monolithic")),
            "timestep": param(float, 1.0),
            "numstep": param(int, 1),
            "maxiter": param(int, 20),
            "tolres": param(float, 1e-8),
            "itemax_outer": param(int, 20),
            "convtol_outer": param(float, 1e-8),
        },
        doc="TSI DYNAMIC",
    ),
    "solver": group(
        {
            "method": param(str, "cg", choices=("cg", "gmres", "bicgstab", "direct")),
            "precond": param(
                str, "block_jacobi",
                choices=("none", "jacobi", "block_jacobi", "chebyshev", "gmg", "amg"),
            ),
            "maxiter": param(int, 500),
            "rtol": param(float, 1e-4),
            "adaptive": param(bool, True),
            "gmres_restart": param(int, 50),
        },
        doc="SOLVER 1 block",
    ),
    "io": group(
        {
            "write_vtu": param(bool, False),
            "write_ensight": param(bool, False),
            "output_dir": param(str, "output"),
            "interval": param(int, 1),
            "write_stress": param(bool, False),
            "restart_interval": param(int, 0, doc="checkpoint every N steps (0=off)"),
            "verbosity": param(str, "standard", choices=("minimal", "standard", "verbose", "debug")),
            "monitor": None,  # {file, nodes: [...], quantities: [...]} time histories
        },
        doc="IO section",
    ),
    "materials": {},  # id -> spec dict (validated by material factory)
    "functions": {},  # id -> expr | [exprs]
    "geometry": {},  # see _build_geometry
    "conditions": {},
    "result_description": [],
}

# sections of the reference's schema that belong to other fields or
# problems, none of them ported
UNPORTED_SECTIONS = (
    "poro_pressure_dynamic",
    "fsi_dynamic", "ssi_dynamic", "xfluid_dynamic",
    "xfsi_dynamic", "levelset_dynamic", "particle_dynamic",
    "brownian_dynamics", "fbi_dynamic", "immersed_dynamic", "fpsi_dynamic",
    "fs3i_dynamic", "ehl_dynamic", "sti_dynamic", "ssti_dynamic",
    "cardiovascular0d", "artery_dynamic", "loma_dynamic",
    "porofluid_dynamic", "airway_dynamic", "cardiac_dynamic",
    "lubrication_dynamic", "poroelasticity_dynamic",
    "cloning", "particles",
)
PROBLEM_TYPES = ("structure", "thermo", "scatra", "tsi", "fluid", "ale",
                 "fluid_ale")  # the ported ones
UNPORTED_GENERATORS = ("line", "sheet", "kl_patch", "nurbs_patch")
UNPORTED_CONDITIONS = (
    "fsi_interface", "point_neumann", "bts_surface_contact", "particle_wall",
    "meshtying", "beam_contact", "periodic", "embedded_mesh",
    "electrode_kinetics", "contact",
)
CONDITIONS = ("dirichlet", "neumann", "body_force", "spring_dashpot",
              "constraint", "ale_dirichlet", "windkessel_outflow")


@dataclass
class Deck:
    raw: dict
    problem: dict
    disc: dict  # name -> Discretization
    materials: dict  # id -> material spec dict (instantiated later per field)
    functions: FunctionManager
    conditions: dict  # per-field condition lists
    result_tests: list
    sections: dict  # all validated sections

    @property
    def problem_type(self):
        return self.problem["type"]


def load(src) -> Deck:
    """Load a deck from a path / YAML string / dict."""
    import yaml

    if isinstance(src, dict):
        data = src
    else:
        text = src
        if "\n" not in str(src):
            with open(src) as fh:
                text = fh.read()
        data = yaml.safe_load(_io.StringIO(text))
    for key in UNPORTED_SECTIONS:
        if key in (data or {}):
            raise NotImplementedError(
                f"deck section {key!r} is not ported (the port runs "
                f"{', '.join(PROBLEM_TYPES)} problems)")
    cfg = validate(DECK_SPEC, data)
    if cfg["problem"]["type"] not in PROBLEM_TYPES:
        raise NotImplementedError(
            f"problem type {cfg['problem']['type']!r} is not ported "
            f"({', '.join(PROBLEM_TYPES)} are)")

    functions = FunctionManager()
    for fid, expr in (cfg.get("functions") or {}).items():
        functions.add(int(fid), expr)

    disc = _build_geometry(cfg.get("geometry") or {})
    conditions = _build_conditions(cfg.get("conditions") or {}, disc)

    return Deck(
        raw=data,
        problem=cfg["problem"],
        disc=disc,
        materials={int(k): dict(v) for k, v in (cfg.get("materials") or {}).items()},
        functions=functions,
        conditions=conditions,
        result_tests=list(cfg.get("result_description") or []),
        sections=cfg,
    )


def _general_topology(d, jitter, permute):
    """In place: jitter interior node coords and/or renumber nodes with a
    deterministic random permutation (kills lattice detection)."""
    X = np.array(d.coords)
    rng = np.random.RandomState(0)
    if jitter:
        lo, hi = X.min(axis=0), X.max(axis=0)
        interior = np.all((X > lo + 1e-12) & (X < hi - 1e-12), axis=1)
        n_eff = max(1, round(d.n_elements ** (1.0 / d.dim)))
        h = (hi - lo) / n_eff
        X[interior] += (rng.rand(int(interior.sum()), X.shape[1]) - 0.5) \
            * (jitter * h)
    d.coords = X
    d.structured_shape = None
    if permute:
        perm = rng.permutation(d.n_nodes).astype(np.int32)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(d.n_nodes, dtype=np.int32)
        d.coords = np.array(d.coords)[perm]
        for blk in d.blocks.values():
            blk.conn = inv[blk.conn]
        for nm in d.node_sets:
            d.node_sets[nm] = inv[d.node_sets[nm]]
        for fbs in d.face_sets.values():
            for fb in fbs:
                fb.conn = inv[fb.conn]


def _build_geometry(geo: dict) -> dict:
    """geometry section -> {disc_name: Discretization}."""
    out = {}
    if "generator" in geo:
        gens = geo["generator"]
        if isinstance(gens, dict):
            gens = [gens]
        for g in gens:
            g = dict(g)
            kind = g.pop("kind", "box")
            name = g.pop("name", "structure")
            mat = g.pop("mat", 1)
            if kind in UNPORTED_GENERATORS:
                raise NotImplementedError(
                    f"geometry.generator kind {kind!r} is not ported (box "
                    f"and rectangle are)")
            if kind == "rectangle":
                d = gridgen.rectangle(
                    int(g.pop("nx")), int(g.pop("ny")),
                    lo=tuple(g.pop("lo", (0, 0))),
                    hi=tuple(g.pop("hi", (1, 1))),
                    cell=g.pop("cell", "quad4"), name=name, mat_id=mat)
            elif kind != "box":
                raise ValueError(f"unknown generator kind {kind!r}")
            jitter = float(g.pop("jitter", 0.0)) if kind == "box" else 0.0
            permute = bool(g.pop("permute", False)) if kind == "box" else False
            if kind == "box":
                d = gridgen.box(
                    int(g.pop("nx")), int(g.pop("ny")), int(g.pop("nz")),
                    lo=tuple(g.pop("lo", (0, 0, 0))),
                    hi=tuple(g.pop("hi", (1, 1, 1))),
                    cell=g.pop("cell", "hex8"), name=name, mat_id=mat)
            if jitter or permute:
                # deterministic general-topology deck variants: jitter
                # interior coords (xjitter of the element size) and/or
                # randomly renumber the nodes so no lattice structure
                # survives — the flat gather/scatter + SA-AMG path any
                # externally-read mesh takes
                _general_topology(d, jitter, permute)
            g.pop("prefix", None)
            if g:
                raise ValueError(f"generator: unknown keys {sorted(g)}")
            if name in out:
                raise NotImplementedError(
                    f"geometry.generator: a second generator of {name!r} "
                    f"(merged meshes) is not ported")
            out[name] = d
    if "exodus" in geo:
        raise NotImplementedError("geometry.exodus is not ported")
    if "nodes" in geo:
        name = geo.get("name", "structure")
        coords = np.asarray(geo["nodes"], dtype=np.float64)
        d = Discretization(name=name, coords=coords)
        for cellkey, spec in (geo.get("elements") or {}).items():
            if isinstance(spec, list):
                spec = {"conn": spec, "mat": 1}
            # a spec may name its cell type explicitly so two blocks of the
            # same cell type (e.g. different materials) can coexist under
            # distinct keys
            cell = spec.get("cell", cellkey)
            d.add_block(cell, np.asarray(spec["conn"], np.int32),
                        spec.get("mat", 1), key=cellkey)
        for nm, ids in (geo.get("node_sets") or {}).items():
            d.node_sets[nm] = np.asarray(ids, np.int32)
        for nm, fspec in (geo.get("face_sets") or {}).items():
            d.face_sets[nm] = [
                FaceBlock(cell, np.asarray(conn, np.int32)) for cell, conn in fspec.items()
            ]
        d.node_sets.setdefault("all", np.arange(d.n_nodes, dtype=np.int32))
        out[name] = d
    if not out:
        raise ValueError("deck has no geometry")
    return out


def _resolve_nodes(disc: Discretization, ref):
    if isinstance(ref, str):
        return disc.node_sets[ref]
    return np.asarray(ref, dtype=np.int32)


def _resolve_faces(disc: Discretization, ref):
    if isinstance(ref, str):
        return disc.face_sets[ref]
    # inline faces: {cell: [[conn]]}
    return [FaceBlock(cell, np.asarray(conn, np.int32)) for cell, conn in ref.items()]


def _build_conditions(conds: dict, discs: dict) -> dict:
    """conditions section -> {field_name: {kind: [BC objects]}}."""
    out = {}
    for key, items in conds.items():
        for item in items:
            if key in UNPORTED_CONDITIONS:
                raise NotImplementedError(
                    f"conditions.{key} is not ported "
                    f"({', '.join(CONDITIONS)} are)")
            if key not in CONDITIONS:
                raise ValueError(f"unknown condition kind {key!r}")
            item = dict(item)
            fieldname = item.pop("field", None) or next(iter(discs))
            disc = discs.get(fieldname) or next(iter(discs.values()))
            f = out.setdefault(fieldname, {"dirichlet": [], "neumann": [],
                                           "body_force": []})
            if key in ("dirichlet", "ale_dirichlet"):
                f.setdefault(key, []).append(
                    DirichletBC(
                        _resolve_nodes(disc, item["nodes"]),
                        onoff=item["onoff"], val=item["val"], funct=item.get("funct"),
                    )
                )
            elif key == "windkessel_outflow":
                f.setdefault("windkessel", []).append({
                    "faces": _resolve_faces(disc, item["faces"]),
                    "r1": float(item.get("r1", 0.0)),
                    "r2": float(item.get("r2", 1.0)),
                    "c": float(item.get("c", 1.0)),
                    "p0": float(item.get("p0", 0.0)),
                })
            elif key == "body_force":
                f["body_force"].append(BodyForce(val=item["val"],
                                                 funct=item.get("funct")))
            elif key == "spring_dashpot":
                f.setdefault("spring_dashpot", []).append({
                    "nodes": _resolve_nodes(disc, item["nodes"]),
                    "stiffness": item.get("stiffness", ()),
                    "viscosity": item.get("viscosity", ()),
                })
            elif key == "constraint":
                if "faces" in item:
                    item["faces"] = _resolve_faces(disc, item["faces"])
                if "nodes" in item:
                    item["nodes"] = _resolve_nodes(disc, item["nodes"])
                f.setdefault("constraint", []).append(item)
            else:
                f["neumann"].append(
                    NeumannBC(
                        _resolve_faces(disc, item["faces"]),
                        onoff=item.get("onoff", [1] * len(item["val"])),
                        val=item["val"], funct=item.get("funct"),
                        kind=item.get("kind", "traction"),
                    )
                )
    return out
