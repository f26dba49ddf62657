"""Structural field: forces, mass, preconditioners and the time steps.

Counterpart of the subset of fourc_tpu/physics/solid.py that the ported
problems run: hex8, tet4 and wedge6 blocks of any law with a PK2 stress
(Neo-Hooke, SVK, ElastHyper) or with Gauss-point history
(viscoelasthyper, plasticlinelast, plasticnlnlogneohooke), nonlinear or
linear kinematics, the element technologies F-bar and EAS9 "mild",
consistent or lumped mass, Rayleigh damping under gen-alpha, Dirichlet,
surface-traction and body-force conditions, spring-dashpot supports, the
penalty volume constraint, nodal stresses; statics, one-step-theta,
gen-alpha and
explicit central differences in time, the implicit ones with Newton and CG,
GMRES or BiCGStab (preconditioned by multigrid, Jacobi or nodal-block
Jacobi, or not at all) or a direct solve.  Three kinds of mesh, found from
the mesh itself:

- a uniform lattice: the operators are collapsed stencils (kernels B1-B3);
- general geometry on lattice topology (arbitrary node positions, e.g. a
  jittered box): the field keeps its node coordinates as a lattice and the
  general-geometry kernels (B4, B5) compute every element's Jacobians.
  Both work on the padded lattice layout of ops/lattice.py, with the
  geometric multigrid of linalg/gmg.py, and both need one hex8 block whose
  law has a kernel (Neo-Hooke or SVK);
- general topology (every other mesh: no lattice in the connectivity, e.g.
  any mesh read from a file, several blocks, other cells or laws): flat
  dof vectors, gathered block by block into element batches and assembled
  by the dof map's deterministic incidence sums (core/mesh.py), with the
  smoothed-aggregation AMG of linalg/amg.py.  A hex8 block of Neo-Hooke or
  SVK runs the element-batch kernels (B6, B7); every other block the
  element route of ops/solid.py (plain PyTorch: the reference runs these
  blocks in XLA, not in a Pallas kernel), and a hex8 block of any law its
  mass with B6.  ``kinem`` linear, a ``tech`` (F-bar, EAS) and a law with
  history take general topology and the element route for every block
  (``ops.tech_force`` under a tech), as the reference's lattice and Pallas
  paths need nonlinear kinematics, no tech and no history.

A history law keeps its internal variables per Gauss point in
``state["hist"]`` (block key -> (E, g, nh)); the steps form the residual
and the Newton operator at the history of the last converged step and
replace it after convergence.  A MULF block's history is its prestretch
F0, which only ``update_prestress`` changes.  A TSI field
(``general=True``: no lattice) hands its forces and tangents the Gauss
points' temperatures (``temps``), which its thermo-elastic and
thermoplastic laws read on the element route.  Springs (k u + c (u - u_old) / dt on their
nodes) are part of the internal force, on every kind of mesh; the volume
constraint's force enters each step's residual as a negative external
force.

The kernels run on a CUDA device, their twins on the CPU.  State dicts from
``init_state``/``compute_initial_state`` hold flat dof vectors, as in the
reference; on a lattice the step turns them into lattices
(physics/solid_lattice.py), on general topology the field's layout
functions are the identity.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from fourc_tpu_torch.core.cells import SOLID_CELLS, get_cell
from fourc_tpu_torch.core.conditions import DirichletHandler
from fourc_tpu_torch.core.device import resolve_device
from fourc_tpu_torch.core.functions import FunctionManager
from fourc_tpu_torch.core.mesh import Discretization
from fourc_tpu_torch.linalg import solvers
from fourc_tpu_torch.linalg.precond import block_jacobi, jacobi
from fourc_tpu_torch.materials.base import HistoryMaterial, elastic_moduli
from fourc_tpu_torch.materials.elastic import lame
from fourc_tpu_torch.ops import common as gm
from fourc_tpu_torch.ops import lattice as _lat
from fourc_tpu_torch.ops import lattice_kernels as lk
from fourc_tpu_torch.ops import solid as ops
from fourc_tpu_torch.ops import solid_kernels as sk
from fourc_tpu_torch.physics.newton import NewtonParams


@dataclass
class GenAlphaParams:
    """Gen-alpha parameters from the spectral radius rho_inf."""

    rho_inf: float = 1.0

    @property
    def alpha_m(self):
        return (2.0 * self.rho_inf - 1.0) / (self.rho_inf + 1.0)

    @property
    def alpha_f(self):
        return self.rho_inf / (self.rho_inf + 1.0)

    @property
    def beta(self):
        return 0.25 * (1.0 - self.alpha_m + self.alpha_f) ** 2

    @property
    def gamma(self):
        return 0.5 - self.alpha_m + self.alpha_f


@dataclass
class SolidParams:
    """Reference defaults.  The ported slices run tech "none" or one of
    ops.TECHS (F-bar under nonlinear kinematics only), precond one of
    PRECONDS (or the direct solver, ``newton.lin_method``) and Rayleigh
    damping under gen-alpha only; SolidField and make_step refuse anything
    else."""

    kinem: str = "nonlinear"
    tech: str = "none"
    dyntype: str = "statics"
    dt: float = 1.0
    theta: float = 0.5  # one-step-theta
    genalpha: GenAlphaParams = field(default_factory=GenAlphaParams)
    newton: NewtonParams = field(default_factory=NewtonParams)
    precond: str = "block_jacobi"
    mass: str = "consistent"  # or "lumped"
    rayleigh_alpha: float = 0.0
    rayleigh_beta: float = 0.0
    predictor: str = "constdis"


@dataclass
class FieldBlock:
    """One element block of a field of general topology: its elements'
    coordinates X (nen*3, E) in the field's dtype, its law and, for a hex8
    block whose law has a kernel model under nonlinear kinematics and no
    tech, the kernels B6/B7; any other block takes the element route with
    its geometry G, wdet computed once (ops/solid.py), and under a ``tech``
    the technology's force with its geometry ``geo`` (F-bar's centre
    gradients, EAS's enhancement fields).  A hex8 block of any law
    computes its mass with B6.  A block of a history law takes its history
    h (E, g, nh) and dt on the element route."""

    key: str
    cell: object  # CellType
    material: object
    density: float
    X: torch.Tensor
    model: str | None = None  # B6/B7's model, None on the element route
    lam: float = 0.0
    mu: float = 0.0
    G: torch.Tensor | None = None
    wdet: torch.Tensor | None = None
    N: torch.Tensor | None = None
    kinem: str = "nonlinear"
    tech: str = "none"
    geo: torch.Tensor | None = None

    def force(self, ue, h=None, dt=None, with_history=False, temps=None):
        """The block's internal force; with ``with_history`` (a history
        law) the pair (force, new history); ``temps`` (g, E) the Gauss
        points' temperatures (TSI), read by a law that takes them
        (``ops.reads_temperature``: such a law has no kernel)."""
        if self.tech != "none":
            return ops.tech_force(self.tech, self.G, self.wdet, self.geo, ue,
                                  self.material, self.kinem)
        if self.model is not None:
            return sk.hex8_force(self.X, ue, self.lam, self.mu, self.model)
        return ops.element_force(self.G, self.wdet, ue, self.material,
                                 kinem=self.kinem, history=h, dt=dt,
                                 with_history=with_history, temps=temps)

    def tangent(self, ue, ve, mcoef, standard=False, h=None, dt=None,
                moduli=None, temps=None):
        """K(u) v + mcoef * rho M_1 v (M_1: the unit-density mass); with
        ``standard`` the tangent without the block's tech; ``moduli`` a
        history law's ``history_moduli`` at ue; ``temps`` as in
        ``force``."""
        c = mcoef * self.density
        if self.tech != "none" and not standard:
            return ops.tech_tangent(self.tech, self.G, self.wdet, self.geo,
                                    ue, ve, self.material, c, self.N,
                                    self.kinem)
        if self.model is not None:
            return sk.hex8_tangent(self.X, ue, ve, self.lam, self.mu,
                                   self.model, c)
        return ops.element_tangent(self.G, self.wdet, ue, ve, self.material,
                                   c, self.N, kinem=self.kinem, history=h,
                                   dt=dt, moduli=moduli, temps=temps)

    def moduli(self, ue, h, dt=None, temps=None):
        """A history law's linearization at ue and the old history h
        (``ops.history_moduli``); None for a MULF block, whose history is
        its prestretch and whose tangent differentiates the base law."""
        if ops.is_prestressed(self.material):
            return None
        return ops.history_moduli(self.G, ue, self.material, self.kinem, h,
                                  dt, temps)

    def temperature_moduli(self, ue, temps, h=None, dt=None):
        """The block's ``ops.temperature_moduli`` at ue and temps (a law
        that ``reads_temperature``; the element route)."""
        return ops.temperature_moduli(self.G, self.wdet, ue, self.material,
                                      self.kinem, temps, h, dt)

    def hessian_at(self, ue, we, h=None, dt=None):
        """ve -> D^2 f(ue)[we, ve], the derivative along ve of the tangent
        apply K(ue) we: forward-mode AD of the plain PyTorch tangent (B7's
        twin on a block of a kernel law, the element route or the tech's
        tangent), as the reference takes a second-order ``jax.jvp`` of its
        XLA force."""
        if self.tech != "none":
            def tangent(x):
                return ops.tech_tangent(self.tech, self.G, self.wdet,
                                        self.geo, x, we, self.material,
                                        kinem=self.kinem)
        elif self.model is not None:
            def tangent(x):
                return ops.hex8_tangent_ref(self.X, x, we, self.lam, self.mu,
                                            self.model)
        else:
            def tangent(x):
                return ops.element_tangent(self.G, self.wdet, x, we,
                                           self.material, kinem=self.kinem,
                                           history=h, dt=dt)
        return lambda ve: torch.func.jvp(tangent, (ue,), (ve,))[1]

    def diag_blocks(self, ue, h=None, dt=None):
        """The 3x3 nodal diagonal blocks of every element's tangent at ue,
        (nen, 3, 3, E), from its 3*nen unit probes: one tangent pass each
        (B7 on a block of a kernel law).  Under a tech the probes read the
        standard tangent, as the reference's ``build_preconditioner`` does
        (its ``element_stiffness`` takes no tech): the preconditioner, and
        with it the Krylov counts, are the reference's.  A history law's
        probes read the old history h."""
        nd, E = ue.shape
        out = ue.new_empty((nd // 3, 3, 3, E))
        mod = (self.moduli(ue, h, dt) if h is not None and self.model is None
               else None)
        for k in range(nd):
            probe = torch.zeros_like(ue)
            probe[k] = 1.0
            a, j = divmod(k, 3)
            out[a, :, j] = self.tangent(ue, probe, 0.0, standard=True, h=h,
                                        dt=dt, moduli=mod)[3 * a:3 * a + 3]
        return out

    def mass(self, ve):
        if self.cell.name == "hex8":  # B6 in its mass-only mode
            return sk.hex8_force(self.X, ve, 0.0, 0.0, "svk",
                                 mcoef=self.density, stiff=False)
        return ops.element_force(self.G, self.wdet, ve, None,
                                 mcoef=self.density, N=self.N, stiff=False)


def unsupported_blocks(disc: Discretization, block_mat: dict) -> list:
    """What the solid field cannot take of a mesh and of its blocks' laws
    (``block_mat``: block key -> material), one phrase each."""
    out = []
    if disc.dim != 3:
        out.append(f"a {disc.dim}D mesh")
    for key, blk in disc.blocks.items():
        if blk.cell not in SOLID_CELLS:
            out.append(f"element block {key!r} of cell {blk.cell!r} "
                       f"({', '.join(SOLID_CELLS)} are ported)")
        elif blk.conn.shape[1] != get_cell(blk.cell).nen:
            out.append(f"element block {key!r}: {blk.conn.shape[1]} nodes "
                       f"per {blk.cell} element")
        mat = block_mat.get(key)
        if mat is not None and not (hasattr(mat, "pk2_from_E")
                                    or isinstance(mat, HistoryMaterial)):
            out.append(f"element block {key!r}: material "
                       f"{type(mat).__name__} (no PK2 stress)")
    return out


def unsupported_history(block_mat: dict, kinem: str, tech: str) -> list:
    """The history laws that lack the form ``kinem`` calls (``evaluate``
    under nonlinear kinematics, ``evaluate_small`` under linear; the
    reference has no other form either), and any under a tech (the port's
    F-bar and EAS take no history)."""
    form = "evaluate_small" if kinem == "linear" else "evaluate"
    out = []
    for key, m in block_mat.items():
        if not isinstance(m, HistoryMaterial):
            continue
        if ops.is_prestressed(m):
            if kinem != "nonlinear":
                out.append(f"element block {key!r}: MULF prestress under "
                           f"kinem {kinem!r}")
            if tech != "none":
                out.append(f"element block {key!r}: MULF prestress under "
                           f"tech {tech!r}")
            continue
        if not hasattr(m, form):
            out.append(f"element block {key!r}: material "
                       f"{type(m).__name__} under kinem {kinem!r}")
        if tech != "none":
            out.append(f"element block {key!r}: material "
                       f"{type(m).__name__} (history) under tech {tech!r}")
    return out


def takes_lattice_path(disc: Discretization, block_mat: dict,
                       kinem: str, tech: str = "none") -> bool:
    """A mesh of one hex8 block whose law has a kernel model keeps the
    lattice paths under nonlinear kinematics and no tech when its
    connectivity is a lattice; every other mesh has general topology (as
    every law with history, which has no kernel model: a lattice cannot
    carry Gauss-point history)."""
    if len(disc.blocks) != 1 or kinem != "nonlinear" or tech != "none":
        return False
    key, blk = next(iter(disc.blocks.items()))
    return (blk.cell == "hex8"
            and _lat.material_model(block_mat[key]) is not None)


class SolidField:
    """Discretization + materials + conditions -> operators in the field's
    layout (padded lattice, or flat dof vectors on general topology), on
    the CUDA card unless ``device="cpu"`` is asked for."""

    def __init__(self, disc: Discretization, materials: dict,
                 params: SolidParams, dirichlet=(), neumann=(),
                 functions: FunctionManager | None = None,
                 device="cuda", dtype=torch.float64, body_forces=(),
                 springs=(), constraints=(), general=False):
        self.disc = disc
        self.params = params
        self.device = resolve_device(device)
        self.dtype = dtype
        self.functions = functions or FunctionManager()
        self.ndpn = disc.dim
        self.block_mat = {}
        for key, blk in disc.blocks.items():
            mid = int(blk.mat_id[0])
            if not np.all(blk.mat_id == mid):
                raise ValueError(f"block {key} mixes materials")
            self.block_mat[key] = materials[mid]
        self._check_supported()
        lattice_path = not general and takes_lattice_path(
            disc, self.block_mat, params.kinem, params.tech)
        self.dofmap = disc.dofmap(self.ndpn, lattice=lattice_path)
        self.ndof = self.dofmap.ndof
        self.dbc = DirichletHandler(list(dirichlet), disc.coords, self.ndpn,
                                    self.functions)
        self.neumann = list(neumann)
        # uniform lattice: collapsed stencils; else general geometry on the
        # lattice topology of the dof map: the coordinate lattice x; else
        # general topology: element batches of every block through the dof
        # map
        self.lattice = self.x = None
        self.blocks = []
        if lattice_path:
            self.lattice = _lat.detect_lattice(disc)
            if self.lattice is None:
                self.lattice = _lat.general_lattice(self.dofmap)
        if self.lattice is not None:
            self._init_lattice()
        else:
            self.blocks = [self._field_block(key) for key in self.block_mat]
        self._mlump = None
        free = torch.as_tensor(self.dbc.free_mask, dtype=torch.float64)
        self.free = self.to_lattice(free.to(self.device)) > 0
        self._amg_cache = {}
        self._probe_blocks = None
        self._memos = {}  # _kept's last linearizations, by name
        self._neumann_data = []
        for nb in self.neumann:
            if nb.kind != "traction":
                raise NotImplementedError(f"Neumann kind {nb.kind!r}")
            for fb in nb.faces:
                fc = get_cell(fb.cell)
                self._neumann_data.append((nb, fc, fb.conn,
                                           disc.coords[fb.conn]))
        self.body_forces = list(body_forces)
        self._body_data = [self._body_block(key) for key in self.block_mat] \
            if self.body_forces else []
        self._init_springs(springs)
        self.constraints = list(constraints)

    def _init_springs(self, springs):
        """Spring-dashpot supports (the reference's ``springs``: nodes,
        stiffness and viscosity per component) as two per-dof coefficient
        vectors k and c in the field's layout (None without springs)."""
        self.k_spring = self.c_spring = None
        if not springs:
            return
        k, c = np.zeros(self.ndof), np.zeros(self.ndof)
        for sp in springs:
            nodes = np.asarray(sp["nodes"], np.int64)
            for coef, vals in ((k, sp.get("stiffness")),
                               (c, sp.get("viscosity"))):
                for i, v in enumerate(list(vals or [])[:self.ndpn]):
                    np.add.at(coef, nodes * self.ndpn + i, float(v))
        self.k_spring = self.to_lattice(self._t(k))
        self.c_spring = self.to_lattice(self._t(c))

    def _init_lattice(self):
        """One hex8 block of a law with a kernel, on a lattice."""
        self.key = key = next(iter(self.block_mat))
        mat = self.block_mat[key]
        self.cell = get_cell("hex8")
        self.model = _lat.material_model(mat)
        self.lam, self.mu = (float(x) for x in lame(mat.youngs, mat.nue))
        self.density = float(mat.density or 0.0)
        self.N = self._t(self.cell.N)
        if self.lattice.h is not None:  # uniform geometry
            G, wdet = _lat.uniform_geometry(self.cell, self.lattice)
            self.G, self.wdet = self._t(G), self._t(wdet)
            self.Xe1 = self.disc.coords[self.disc.blocks[key].conn[:1]]
            self.mass_stencil = self._t(self._mass_stencil())
        else:
            self.x = _lat.coord_lattice(self.disc.coords, self.lattice,
                                        self.dtype, self.device)
            self.dN = self._t(self.cell.dN)
            self.w = self._t(self.cell.gauss_weights)

    def _field_block(self, key) -> FieldBlock:
        """General topology: a block's element batch, its kernel model or
        its element-route geometry (``_host_geometry``)."""
        mat = self.block_mat[key]
        cell = get_cell(self.disc.blocks[key].cell)
        X = self._element_coords(key)  # float64 (E, nen, 3)
        X = X.reshape(X.shape[0], -1).T.contiguous()  # (nen*3, E)
        blk = FieldBlock(key=key, cell=cell, material=mat,
                         density=float(mat.density or 0.0),
                         X=X.to(self.dtype), kinem=self.params.kinem)
        model = _lat.material_model(mat)
        tech = self.params.tech
        if (cell.name == "hex8" and model is not None
                and self.params.kinem == "nonlinear" and tech == "none"):
            blk.model = model
            blk.lam, blk.mu = (float(x) for x in lame(mat.youngs, mat.nue))
        else:
            blk.G, blk.wdet = self._host_geometry(key, ops.element_geometry)
            blk.N = self._t(cell.N)
        if tech != "none":
            blk.tech = tech
            blk.geo = self._host_geometry(
                key, (lambda X, c: ops.origin_geometry(X, c)[0])
                if tech == "fbar" else ops.eas_modes)
        return blk

    def _host_geometry(self, key, fn):
        """``fn(X, cell)`` of a block's float64 element coordinates X
        (nen*3, E), computed once on the host in float64 and moved to the
        field's device in its dtype: every device then sees the same tables
        to the last bit, and a float64 card run parts from the CPU's only by
        the rounding of its elementwise functions (the 4C-converted decks'
        1e-12 anchors sit near that noise).  Setup only, as the SA-AMG
        setup."""
        conn = self.disc.blocks[key].conn
        cell = get_cell(self.disc.blocks[key].cell)
        X = torch.as_tensor(self.disc.coords[conn])
        out = fn(X.reshape(X.shape[0], -1).T.contiguous(), cell)
        return tuple(t.to(self.device, self.dtype) for t in out) \
            if isinstance(out, tuple) else out.to(self.device, self.dtype)

    def _check_supported(self):
        p = self.params
        out = unsupported_blocks(self.disc, self.block_mat)
        if p.kinem not in ("nonlinear", "linear"):
            out.append(f"kinem {p.kinem!r}")
        if p.tech not in ("none",) + ops.TECHS:
            out.append(f"tech {p.tech!r}")
        elif p.tech == "fbar" and p.kinem != "nonlinear":
            raise ValueError("TECH fbar requires 3D nonlinear kinematics")
        if p.mass not in ("consistent", "lumped"):
            out.append(f"{p.mass} mass")
        out += unsupported_history(self.block_mat, p.kinem, p.tech)
        if out:
            raise NotImplementedError(
                "not ported: " + "; ".join(out) + " (the ported solid field "
                f"takes {', '.join(SOLID_CELLS)} blocks in 3D, tech 'none', "
                f"{' or '.join(repr(t) for t in ops.TECHS)}, consistent or "
                "lumped mass)")

    def _t(self, x):
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=self.device).contiguous()

    # -- layout: padded lattice, or flat on general topology ---------------

    def to_lattice(self, v):
        return v if self.lattice is None else _lat.to_lattice(v, self.lattice)

    def from_lattice(self, x):
        return x if self.lattice is None else _lat.from_lattice(x,
                                                                self.lattice)

    # -- operators (in the field's layout) ---------------------------------

    def _assemble(self, fn, *vecs):
        """General topology: sum over the blocks of fn(block, element
        batches of vecs), assembled into a flat dof vector."""
        return self.dofmap.scatter_add({
            b.key: fn(b, *(self.dofmap.gather(v, b.key) for v in vecs))
            for b in self.blocks})

    def internal_force(self, u, hist=None, dt=None, u_old=None,
                       with_history=False, temps=None):
        """f_int(u), the springs' k u included, and c (u - u_old) / dt where
        the caller passes u_old (the reference's statics and gen-alpha
        steps; its one-step-theta and explicit steps do not).  ``hist``
        (block key -> (E, g, nh)) is the history of the last converged step
        and ``dt`` the step; with ``with_history`` the result is
        (f_int, the new history).  ``temps`` (block key -> (g, E)) are the
        Gauss points' temperatures of a TSI field (``general``: no
        lattice)."""
        new_hist = {}
        if temps is not None and not self.blocks:
            raise ValueError("temperatures need a field of general topology "
                             "(SolidField(general=True))")
        if self.blocks:
            hist, temps = hist or {}, temps or {}
            per_block = {}
            for b in self.blocks:
                ue = self.dofmap.gather(u, b.key)
                T = temps.get(b.key)
                if b.key in hist:
                    per_block[b.key], new_hist[b.key] = b.force(
                        ue, hist[b.key], dt, with_history=True, temps=T)
                else:
                    per_block[b.key] = b.force(ue, temps=T)
            f = self.dofmap.scatter_add(per_block)
        elif self.x is not None:
            f = lk.neo_force_gen(self.x, u, self.dN, self.w, self.N,
                                 self.lam, self.mu, self.model)
        else:
            f = lk.neo_force(u, self.G, self.wdet, self.lam, self.mu,
                             self.model)
        if self.k_spring is not None:
            fsp = self.k_spring * u
            if u_old is not None and dt:
                fsp = fsp + self.c_spring * (u - u_old) / dt
            f = f + fsp
        return (f, new_hist) if with_history else f

    def tangent(self, u, v, mcoef=0.0, hist=None, dt=None, temps=None):
        """K(u) v + mcoef * M v, M the field's mass (each block's density
        included): consistent, in the same kernel pass, or lumped, added
        elementwise after a pass without the mass; K includes the springs'
        k (their dashpots: ``dashpot``) and a history law's tangent at the
        old history ``hist``, at the temperatures ``temps`` of a TSI
        field."""
        if mcoef and self.params.mass == "lumped":
            return self.tangent(u, v, hist=hist, dt=dt, temps=temps) \
                + mcoef * self.mlump * v
        if self.blocks:
            hist, temps = hist or {}, temps or {}
            mods = self._history_moduli(u, hist, dt, temps)
            out = self._assemble(
                lambda b, ue, ve: b.tangent(ue, ve, mcoef, h=hist.get(b.key),
                                            dt=dt, moduli=mods.get(b.key),
                                            temps=temps.get(b.key)),
                u, v)
        else:
            c = mcoef * self.density
            if self.x is not None:
                out = lk.neo_tangent_gen(self.x, u, v, self.dN, self.w,
                                         self.N, self.lam, self.mu,
                                         self.model, c)
            else:
                out = lk.neo_tangent(u, v, self.G, self.wdet, self.N,
                                     self.lam, self.mu, self.model, c)
        if self.k_spring is not None:
            out = out + self.k_spring * v
        return out

    def _history_moduli(self, u, hist, dt, temps=None):
        """Block key -> ``FieldBlock.moduli`` at u for every block of a
        history law on the element route, kept while u (the same tensor,
        unchanged), the history, the temperatures and dt stay: the Krylov
        applies of one Newton iterate share one linearization."""
        temps = temps or {}
        blocks = [b for b in self.blocks
                  if b.key in hist and b.tech == "none" and b.model is None
                  and not ops.is_prestressed(b.material)]
        if not blocks:
            return {}
        return self._kept("history", blocks, u, hist, temps, dt, lambda: {
            b.key: b.moduli(self.dofmap.gather(u, b.key), hist[b.key], dt,
                            temps.get(b.key)) for b in blocks})

    def _kept(self, name, blocks, u, hist, temps, dt, build):
        """build() of the blocks' linearization at u, kept under ``name``
        while u (the same tensor, unchanged), the blocks' history and
        temperatures and dt stay: the Krylov applies of one Newton
        iterate share it."""
        held = (u, *(hist[b.key] for b in blocks if b.key in hist),
                *(temps[b.key] for b in blocks if b.key in temps))
        stamp = (dt, [b.key for b in blocks], [t._version for t in held])
        memo = self._memos.get(name)
        if (memo is None or memo[1] != stamp
                or any(a is not b for a, b in zip(memo[0], held))):
            memo = self._memos[name] = (held, stamp, build())
        return memo[2]

    def temperature_derivative(self, u, temps, dtemps, hist=None, dt=None):
        """The derivative of ``internal_force(u, hist, dt, temps=temps)``
        along the Gauss points' temperatures dtemps (block key -> (g, E)),
        summed over the blocks whose law reads them: TSI's thermal
        expansion block K_st, 0 without such a block.  Each block's
        ``temperature_moduli`` at (u, temps) is kept for the Krylov
        applies of one Newton iterate (``_kept``)."""
        hist = hist or {}
        blocks = [b for b in self.blocks if b.key in temps
                  and ops.reads_temperature(b.material)]
        if not blocks:
            return torch.zeros_like(u)
        mods = self._kept("temperature", blocks, u, hist, temps, dt, lambda: {
            b.key: b.temperature_moduli(self.dofmap.gather(u, b.key),
                                        temps[b.key], hist.get(b.key), dt)
            for b in blocks})
        return self.dofmap.scatter_add({
            b.key: ops.element_temperature_derivative(b.G, mods[b.key],
                                                      dtemps[b.key])
            for b in blocks})

    def dashpot(self, v, dt):
        """The derivative of the dashpots' c (u - u_old) / dt along v (0
        without springs)."""
        return 0.0 if self.c_spring is None else self.c_spring * v / dt

    def constraint_force(self, u, t):
        """The sum of the constraints' forces at u (the field's layout) and
        time t; the residual adds it, as the reference subtracts it from
        f_ext."""
        un = self.from_lattice(u)
        return self.to_lattice(sum(c.force(un, t) for c in self.constraints))

    def constraint_tangent_at(self, u, t):
        """v -> the derivative of ``constraint_force`` at u along v, each
        constraint linearized once here."""
        un = self.from_lattice(u)
        applies = [c.linearize(un, t) for c in self.constraints]
        return lambda v: self.to_lattice(sum(
            a(self.from_lattice(v)) for a in applies))

    @property
    def plain_tangent(self):
        """The tangent (and D^2f) launches no kernel on this device: on the
        CPU (the kernels' twins), or on general topology with every block on
        the element route or under a tech.  ``torch.func.vmap`` can then
        batch it (the direct solve's probes)."""
        return self.device.type == "cpu" or (
            self.lattice is None and all(b.model is None
                                         for b in self.blocks))

    def force_hessian_at(self, u, w, hist=None, dt=None):
        """v -> the derivative along v of K(u) w, D^2 f(u)[w, v]: the Newton
        operator's term of stiffness-proportional Rayleigh damping, in plain
        PyTorch on every device (no TPU kernel computes it; the reference
        takes a second-order ``jax.jvp`` of its force).  On the uniform
        lattice by hand (ops/lattice.py neo_force_hessian_at); on general
        geometry and general topology by forward-mode AD of the tangent's
        twin (B5's, B7's) or of the element route's tangent."""
        if self.blocks:
            dm, hist = self.dofmap, hist or {}
            parts = [(b, b.hessian_at(dm.gather(u, b.key),
                                      dm.gather(w, b.key), hist.get(b.key),
                                      dt))
                     for b in self.blocks]
            return lambda v: dm.scatter_add(
                {b.key: h(dm.gather(v, b.key)) for b, h in parts})
        if self.x is not None:
            def tangent(x):
                return _lat.neo_jvp_gen_ref(self.x, x, w, self.dN, self.w,
                                            self.N, self.lam, self.mu,
                                            self.model)

            return lambda v: torch.func.jvp(tangent, (u,), (v,))[1]
        return _lat.neo_force_hessian_at(u, w, self.G, self.wdet, self.lam,
                                         self.mu, self.model)

    @property
    def mlump(self):
        """The lumped mass in the field's layout, computed once."""
        if self._mlump is None:
            self._mlump = self.lumped_mass()
        return self._mlump

    def mass_matvec(self, v):
        if self.params.mass == "lumped":
            return self.mlump * v
        if self.blocks:
            return self._assemble(FieldBlock.mass, v)
        if self.x is not None:  # B4 in its mass-only mode
            return lk.neo_force_gen(self.x, v, self.dN, self.w, self.N, 0.0,
                                    0.0, "svk", mcoef=self.density,
                                    stiff=False)
        return lk.stencil_matvec(self.mass_stencil, v)

    def _body_block(self, key):
        """A block's body-force data, formed at load time in float64 on the
        host (as ``_host_geometry``) and kept on the device: its Gauss
        points' coordinates xg (E, g, 3), the weights rho wdet_g N_a
        (E, g, nen) (rho 1 where the density is 0, as the reference has it)
        and the element dofs (E * nen * 3,)."""
        cell = get_cell(self.disc.blocks[key].cell)
        conn = self.disc.blocks[key].conn
        Xe = torch.as_tensor(self.disc.coords[conn])
        N = torch.as_tensor(cell.N)
        wdet = torch.cat([w for _, _, w in ops._chunks(Xe, cell,
                                                       ops.ELEMENT_CHUNK)])
        rho = float(self.block_mat[key].density or 0.0) or 1.0
        edof = (torch.as_tensor(conn[:, :, None], dtype=torch.int64)
                * self.ndpn + torch.arange(self.ndpn)).reshape(-1)
        return tuple(t.to(self.device) for t in (
            torch.einsum("eai,ga->egi", Xe, N),
            rho * wdet[:, :, None] * N[None], edof))

    def body_force(self, t):
        """The body forces at time t as a flat float64 dof vector on the
        device: sum_g rho wdet_g N_a val_k FUNCT_k(x_g, t), the FUNCTs
        evaluated by torch at the Gauss points (no host work per step)."""
        f = torch.zeros(self.ndof, dtype=torch.float64, device=self.device)
        for bf in self.body_forces:
            for xg, W, edof in self._body_data:
                b = torch.zeros_like(xg)
                for k in range(self.ndpn):
                    if k < len(bf.val) and bf.val[k] != 0:
                        fn = self.functions.get(bf.funct[k])
                        b[..., k] = bf.val[k] * fn.on_device(xg, t)
                fe = W[:, 0, :, None] * b[:, 0, None]  # (E, nen, 3)
                for g in range(1, W.shape[1]):  # in order, on any device
                    fe = fe + W[:, g, :, None] * b[:, g, None]
                f.index_add_(0, edof, fe.reshape(-1))
        return f

    def external_force(self, t):
        """Surface tractions at time t, assembled on the host in float64,
        plus the body forces (``body_force``, on the device)."""
        f = np.zeros(self.ndof)
        for nb, fc, conn, Xf in self._neumann_data:
            xg = gm.interp_field(Xf, fc.N)
            comps = []
            for k in range(self.ndpn):
                if k < len(nb.onoff) and nb.onoff[k]:
                    fn = self.functions.get(nb.funct[k])
                    comps.append(nb.val[k] * fn(xg, t, component=0))
                else:
                    comps.append(np.zeros(xg.shape[:2]))
            fe = ops.surface_traction_force(Xf, np.stack(comps, axis=-1), fc)
            edof = conn[:, :, None] * self.ndpn + np.arange(self.ndpn)
            f += np.bincount(edof.reshape(-1), weights=fe.reshape(-1),
                             minlength=self.ndof)
        if not self.body_forces:
            return self.to_lattice(self._t(f))
        f = torch.as_tensor(f, device=self.device) + self.body_force(t)
        return self.to_lattice(f.to(self.dtype))

    def _element_coords(self, key):
        """General topology: float64 element coordinates (E, nen, 3) of a
        block on the field's device."""
        conn = self.disc.blocks[key].conn
        return torch.as_tensor(self.disc.coords[conn], device=self.device)

    def lumped_mass(self):
        if self.blocks:
            return self.dofmap.scatter_add({
                b.key: ops.element_lumped_mass(
                    self._element_coords(b.key), b.cell,
                    b.density).T.repeat_interleave(3, dim=0)
                for b in self.blocks}).to(self.dtype)
        nshape = self.lattice.nshape
        if self.x is not None:  # every element's own geometry
            X = torch.as_tensor(self.disc.coords, device=self.device)
            nodal = ops.lattice_lumped_mass(
                X.reshape(self.lattice.pshape + (3,)), nshape, self.cell,
                self.density)
            return self.to_lattice(nodal.reshape(-1).to(self.dtype))
        ml = ops.lumped_mass(self.Xe1, self.cell, self.density)[0]  # (8,)
        nodal = _lat.assemble_uniform(np.repeat(ml[:, None], 3, axis=1),
                                      nshape)
        return self.to_lattice(self._t(nodal.reshape(-1)))

    def _mass_stencil(self):
        """Congruent-element consistent mass as an (8, 3, 8, 3) stencil,
        column k = M e_k of the element mass."""
        ve = np.eye(24).reshape(24, 8, 3)
        cols = ops.consistent_mass_matvec(np.repeat(self.Xe1, 24, axis=0), ve,
                                          self.cell, self.density)
        return _lat.collapse_stencil(cols.reshape(24, 24).T)

    def assemble_linear_operator(self, mass_shift=0.0, timings=None):
        """General topology: the linear-elastic stiffness of the mesh (each
        block from its law's ``elastic_moduli``) plus ``mass_shift``
        times the lumped mass, assembled on the host as a scipy CSR matrix
        in float64, with unit rows and columns on the constrained dofs.
        The element matrices come chunk by chunk from the field's device.
        ``timings`` (a dict) receives the seconds of the two stages."""
        import scipy.sparse as sp

        t0 = time.perf_counter()
        rows, cols, vals = [], [], []
        for b in self.blocks:
            moduli = elastic_moduli(b.material)
            if moduli is None:
                raise NotImplementedError(
                    f"the linear-elastic operator of block {b.key!r}: "
                    f"material {type(b.material).__name__} has no youngs "
                    f"and nue")
            lam, mu = (float(x) for x in lame(*moduli))
            Xe = self._element_coords(b.key)
            E, nd = Xe.shape[0], 3 * b.cell.nen
            v = np.empty((E, nd, nd))
            mdiag = None
            if mass_shift:
                ml = ops.element_lumped_mass(Xe, b.cell, b.density)
                mdiag = mass_shift * ml.repeat_interleave(3, dim=1)  # (E, nd)
            for sl, K in ops.element_stiffness_chunks(Xe, b.cell, lam, mu):
                if mdiag is not None:
                    K = K + torch.diag_embed(mdiag[sl])
                v[sl] = K.cpu().numpy()
            conn = self.disc.blocks[b.key].conn
            edof = (conn[:, :, None] * 3
                    + np.arange(3, dtype=np.int32)).reshape(E, nd)
            rows.append(np.repeat(edof, nd, axis=1).reshape(-1))
            cols.append(np.tile(edof, (1, nd)).reshape(-1))
            vals.append(v.reshape(-1))
        t1 = time.perf_counter()
        A0 = sp.coo_matrix(
            (np.concatenate(vals), (np.concatenate(rows),
                                    np.concatenate(cols))),
            shape=(self.ndof, self.ndof)).tocsr()  # duplicates summed
        free = self.dbc.free_mask
        D = sp.diags(free.astype(np.float64))
        A0 = (D @ A0 @ D + sp.diags((~free).astype(np.float64))).tocsr()
        if timings is not None:
            timings["element_stiffness"] = t1 - t0
            timings["coo_to_csr"] = time.perf_counter() - t1
        return A0

    def _build_amg(self, mass_shift=0.0):
        """Smoothed-aggregation AMG on the assembled linear-elastic
        rediscretisation: state-independent, built once per mass shift and
        reused across Newton and time steps."""
        from fourc_tpu_torch.linalg.amg import SmoothedAggregationAMG

        if self.lattice is not None:
            raise NotImplementedError(
                "precond 'amg' is ported for meshes of general topology; a "
                "lattice mesh takes 'gmg'")
        shift = round(float(mass_shift), 10)
        if shift not in self._amg_cache:
            timings = {}
            A0 = self.assemble_linear_operator(mass_shift, timings)
            M = SmoothedAggregationAMG(A0, self.ndpn, device=self.device,
                                       dtype=self.dtype)
            M.timings = {**timings, **M.timings}
            self._amg_cache[shift] = M
        return self._amg_cache[shift]

    def build_preconditioner(self, u, mass_shift=0.0, hist=None, dt=None):
        """Jacobi or nodal-block Jacobi (``params.precond``) from the 3x3
        nodal diagonal blocks of the element tangents at u (in the field's
        layout) plus ``mass_shift`` times the lumped mass; constrained
        dofs get identity rows and columns.  A hex8 block of a kernel law
        takes its blocks from B7 on the element batch, lattice or not (24
        launches); every other block from the element route, a history
        law's at the old history ``hist``.  The springs are not in it (nor
        in the reference's)."""
        if self._probe_blocks is None:
            blocks = self.blocks or [self._field_block(self.key)]
            self._probe_blocks = [
                (b, torch.as_tensor(self.disc.blocks[b.key].conn,
                                    device=self.device).long())
                for b in blocks]
        un = self.from_lattice(u).reshape(-1, 3)
        nn = un.shape[0]
        blocks = un.new_zeros((nn, 3, 3))
        hist = hist or {}
        per_block = {}
        for b, conn in self._probe_blocks:
            ue = un[conn].reshape(conn.shape[0], -1).T.contiguous()
            db = b.diag_blocks(ue, hist.get(b.key), dt)  # (nen, 3, 3, E)
            if self.blocks:
                per_block[b.key] = db
            else:
                blocks.index_add_(0, conn.T.reshape(-1),
                                  db.permute(0, 3, 1, 2).reshape(-1, 3, 3))
        if per_block:  # the dof map's slot-order sums: alike on any device
            blocks = torch.stack([self.dofmap.scatter_add({
                key: db[:, :, j].reshape(-1, db.shape[-1])
                for key, db in per_block.items()}) for j in range(3)],
                dim=-1).reshape(nn, 3, 3)
        eye = torch.eye(3, dtype=torch.bool, device=self.device)
        if mass_shift:
            ml = self.from_lattice(self.mlump).reshape(-1, 3)[:, 0]
            blocks = blocks + mass_shift * ml[:, None, None] * eye
        free = torch.as_tensor(self.dbc.free_mask,
                               device=self.device).reshape(nn, 3)
        blocks = torch.where(free[:, :, None] & free[:, None, :], blocks, 0.0)
        blocks = blocks + (~free[:, :, None] & eye).to(blocks.dtype)
        if self.params.precond == "jacobi":
            return jacobi(self.to_lattice(
                torch.diagonal(blocks, dim1=1, dim2=2).reshape(-1)))
        M = block_jacobi(blocks)
        if self.lattice is None:
            return M
        return lambda r: self.to_lattice(M(self.from_lattice(r)))

    def nodal_stresses(self, u):
        """Cauchy stresses at the nodes, (n_nodes, 3, 3): each element's
        Gauss-point stresses (``ops.gp_stresses``, under F-bar at F_bar)
        extrapolated to its nodes and averaged over the elements that share
        the node (the reference's code: the sum divided by the count of
        elements, whatever its docstring says).  ``u``: a flat dof vector
        or one in the field's layout; computed in the field's dtype on its
        device."""
        un = (u if u.dim() == 1 else self.from_lattice(u)).reshape(-1, 3)
        nn = un.shape[0]
        num = un.new_zeros((nn, 3, 3))
        den = un.new_zeros((nn,))
        for key, mat in self.block_mat.items():
            if isinstance(mat, HistoryMaterial):
                raise NotImplementedError(
                    f"nodal stresses of element block {key!r} "
                    f"({type(mat).__name__}, a law with history) are not "
                    f"ported")
            cell = get_cell(self.disc.blocks[key].cell)
            conn = torch.as_tensor(self.disc.blocks[key].conn,
                                   device=self.device).long()
            G, _ = self._host_geometry(key, ops.element_geometry)
            G0 = (self._host_geometry(
                key, lambda X, c: ops.origin_geometry(X, c)[0])
                if self.params.tech == "fbar" else None)
            ue = un[conn].reshape(conn.shape[0], -1).T
            sig = ops.gp_stresses(G, ue, mat, self.params.kinem,
                                  self.params.tech, G0)
            nod = ops.extrapolate_to_nodes(sig, cell)  # (nen, 3, 3, E)
            idx = conn.T.reshape(-1)
            num.index_add_(0, idx, nod.permute(0, 3, 1, 2).reshape(-1, 3, 3))
            den.index_add_(0, idx, torch.ones_like(idx, dtype=den.dtype))
        return num / torch.clamp(den, min=1.0)[:, None, None]


def init_state(f: SolidField):
    """Zero state, flat dof vectors, and ``hist``: for each block of a law
    with history its initial history (E, g, nh)."""
    z = torch.zeros(f.ndof, dtype=f.dtype, device=f.device)
    hist = {}
    for key, m in f.block_mat.items():
        if isinstance(m, HistoryMaterial):
            ne = f.disc.blocks[key].conn.shape[0]
            ngp = get_cell(f.disc.blocks[key].cell).ngp
            hist[key] = m.init_history(ne * ngp, f.dtype, f.device).reshape(
                ne, ngp, -1)
    return {"d": z, "v": z.clone(), "a": z.clone(), "t": 0.0, "step": 0,
            "fint": z.clone(), "fext": z.clone(), "hist": hist}


def update_prestress(f: SolidField, state):
    """MULF's update after a converged prestress step: each MULF block's
    prestretch becomes the total deformation gradient of the step,
    F0 <- F_tot (``MulfPrestress.total_gradient`` + I), and d, v, a and
    f_int restart from zero (4C's prestress update; the reference's
    ``update_prestress``)."""
    hist = dict(state["hist"])
    d = state["d"]
    for b in f.blocks:
        if not ops.is_prestressed(b.material):
            continue
        nen, _, g, E = b.G.shape
        H = ops._grad(f.dofmap.gather(d, b.key).reshape(nen, 3, E), b.G)
        F0 = ops._prestretch(hist[b.key])
        Ht = b.material.total_gradient(H, F0)
        hist[b.key] = (Ht + gm.eye3l(Ht)).reshape(9, g, E).permute(2, 1, 0)
    new = dict(state)
    new.update({k: torch.zeros_like(d) for k in ("d", "v", "a", "fint")},
               hist=hist)
    return new


def compute_initial_state(f: SolidField, state, consistent_mass_tol=1e-10):
    """Forces and the acceleration consistent with (d, v, t):
    M a0 = f_ext(0) - f_int(d0), solved with Jacobi-preconditioned CG for
    the consistent mass, divided by the lumped mass where it is positive,
    and a0 = 0 under statics.  The internal force is taken at the state's
    history without dt (a viscous law's factors are then 1, as the
    reference's), f_ext includes the constraints' forces at d0."""
    t0 = state["t"]
    d0 = f.dbc.apply(state["d"], t0)
    d0l = f.to_lattice(d0)
    fint0 = f.internal_force(d0l, state.get("hist"))
    fext0 = f.external_force(t0)
    if f.constraints:
        fext0 = fext0 - f.constraint_force(d0l, t0)
    rhs = torch.where(f.free, fext0 - fint0, 0.0)
    if f.params.dyntype == "statics":
        a0 = torch.zeros_like(rhs)
    elif f.params.mass == "lumped":
        ml = f.mlump
        a0 = torch.where(ml > 0, rhs / torch.clamp(ml, min=1e-300), 0.0)
    else:
        def Mop(v):
            vm = torch.where(f.free, v, 0.0)
            return torch.where(f.free, f.mass_matvec(vm), v)

        res = solvers.cg(Mop, rhs, M=jacobi(torch.clamp(f.mlump, min=1e-300)),
                         tol=consistent_mass_tol, maxiter=200)
        a0 = torch.where(f.free, res.x, 0.0)
    new = dict(state)
    new.update(d=d0, a=f.from_lattice(a0), fint=f.from_lattice(fint0),
               fext=f.from_lattice(fext0))
    return new


def make_zienxie_error_fn(f: SolidField):
    """Zienkiewicz-Xie local error estimate of a Newmark-family step: the
    RMS over the dofs of e = |beta - 1/6| dt^2 (a_{n+1} - a_n), with
    beta = theta / 2 for one-step-theta (the reference's)."""
    typ = f.params.dyntype
    if typ == "genalpha":
        beta = float(f.params.genalpha.beta)
    elif typ == "onesteptheta":
        beta = float(f.params.theta) / 2.0
    else:
        raise ValueError(
            f"Zienkiewicz-Xie adaptivity needs a dynamic Newmark-family "
            f"integrator (genalpha/onesteptheta), got dyntype={typ!r}")
    coef = abs(beta - 1.0 / 6.0)

    def flat(a):  # a lattice field's states after the first step
        return a if a.dim() == 1 else f.from_lattice(a)

    def error_fn(state_old, state_new, dt):
        da = flat(state_new["a"]) - flat(state_old["a"])
        return (coef * dt * dt * float(torch.linalg.vector_norm(da))
                / f.ndof ** 0.5)

    return error_fn


def _predict(kind: str, dt, d_n, v_n, a_n):
    """Displacement predictor; tangdis maps to constdis (the first Newton
    iteration is the tangential solve)."""
    if kind == "constvelacc":
        return d_n + dt * v_n + 0.5 * dt * dt * a_n
    if kind == "constvel":
        return d_n + dt * v_n
    return d_n


def _newmark_updates(dt, d_new, d_n, v_n, a_n, beta, gamma):
    a_new = ((d_new - d_n) / (beta * dt * dt) - v_n / (beta * dt)
             - (0.5 - beta) / beta * a_n)
    v_new = v_n + dt * ((1 - gamma) * a_n + gamma * a_new)
    return v_new, a_new


DYNTYPES = ("statics", "onesteptheta", "genalpha", "explicit")
PRECONDS = ("none", "jacobi", "block_jacobi", "gmg", "amg")


def make_step(f: SolidField, dt: float | None = None):
    """Build ``step(state) -> (state, stats)`` for the configured
    integrator: statics, one-step-theta or gen-alpha with Newton (CG, GMRES
    or BiCGStab with a preconditioner of PRECONDS, or the direct solve), or
    explicit central differences."""
    from fourc_tpu_torch.physics import solid_lattice as sl

    dt = float(dt if dt is not None else f.params.dt)
    p = f.params
    if p.dyntype not in DYNTYPES:
        raise NotImplementedError(
            f"DYNAMICTYPE {p.dyntype!r} is not ported ({', '.join(DYNTYPES)} "
            f"are)")
    if (p.rayleigh_alpha or p.rayleigh_beta) and p.dyntype != "genalpha":
        raise NotImplementedError(
            f"Rayleigh damping under DYNAMICTYPE {p.dyntype!r} is not ported "
            f"(genalpha carries it; the reference's statics, one-step-theta "
            f"and central-difference steps drop it)")
    if p.dyntype == "explicit":
        return sl.make_explicit_step(f, dt)
    if p.newton.lin_method not in solvers.SOLVERS:
        raise NotImplementedError(
            f"linear solver {p.newton.lin_method!r} is not ported "
            f"({', '.join(solvers.SOLVERS)} are)")
    if p.newton.lin_method != "direct" and p.precond not in PRECONDS:
        raise NotImplementedError(
            f"precond {p.precond!r} is not ported ({', '.join(PRECONDS)} "
            f"are)")
    if p.dyntype == "statics":
        shift, build = 0.0, sl.make_statics_step
    elif p.dyntype == "onesteptheta":
        shift, build = 1.0 / (p.theta * dt * dt), sl.make_ost_step
    else:
        ga = p.genalpha
        shift = (1 - ga.alpha_m) / (ga.beta * dt * dt)
        build = sl.make_lattice_genalpha_step
    M = _static_precond(f, mass_shift=shift)
    if (M is None and p.newton.lin_method != "direct"
            and p.precond in ("jacobi", "block_jacobi")):
        def precond_at(u0, hist=None):
            return f.build_preconditioner(u0, mass_shift=shift, hist=hist,
                                          dt=dt)
    else:
        def precond_at(u0, hist=None):
            return M
    step = build(f, dt, precond_at)
    step.precond = M  # for reports: the hierarchy and its setup times
    return step


def _static_precond(f: SolidField, mass_shift: float = 0.0):
    """The state-independent preconditioner, built once per step function:
    GMG on a lattice, SA-AMG on general topology; None for the direct
    solve (the reference builds a block-Jacobi there that the direct solve
    never reads), for no preconditioner and for the per-state Jacobi and
    block-Jacobi."""
    if (f.params.newton.lin_method == "direct"
            or f.params.precond not in ("gmg", "amg")):
        return None
    if f.params.precond == "amg":
        return f._build_amg(mass_shift)
    if f.lattice is None:
        # general topology: fall back to SA-AMG, the multigrid that works
        # on any mesh, not to a one-level method
        warnings.warn("gmg preconditioner needs a structured single-block "
                      "mesh; falling back to SA-AMG")
        return f._build_amg(mass_shift)
    from fourc_tpu_torch.linalg import gmg

    return gmg.build_for_solid(f, mass_shift=mass_shift)
