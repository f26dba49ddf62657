"""Structural field on a uniform hex8 lattice: forces, mass, gen-alpha step.

Counterpart of the subset of fourc_tpu/physics/solid.py that the flagship
problem runs: one hex8 block on a uniform lattice, a Neo-Hooke or SVK law,
consistent mass, Dirichlet and surface-traction conditions, gen-alpha in
time with Newton-Krylov (CG + geometric multigrid).  The field's operators
work on the padded lattice layout of ops/lattice.py and run the CUDA
kernels of ops/lattice_kernels.py on a CUDA device (their twins on the CPU).
State dicts from ``init_state``/``compute_initial_state`` hold flat dof
vectors, as in the reference; the step turns them into lattices
(physics/solid_lattice.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from fourc_tpu_torch.core.cells import get_cell
from fourc_tpu_torch.core.conditions import DirichletHandler
from fourc_tpu_torch.core.functions import FunctionManager
from fourc_tpu_torch.core.mesh import Discretization
from fourc_tpu_torch.linalg import solvers
from fourc_tpu_torch.linalg.precond import jacobi
from fourc_tpu_torch.materials.elastic import lame
from fourc_tpu_torch.ops import common as gm
from fourc_tpu_torch.ops import lattice as _lat
from fourc_tpu_torch.ops import lattice_kernels as lk
from fourc_tpu_torch.ops import solid as ops
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
    """Reference defaults.  The lattice slice runs kinem "nonlinear",
    tech "none", dyntype "genalpha", precond "gmg", consistent mass and no
    Rayleigh damping; SolidField and make_step refuse anything else."""

    kinem: str = "nonlinear"
    tech: str = "none"
    dyntype: str = "statics"
    dt: float = 1.0
    genalpha: GenAlphaParams = field(default_factory=GenAlphaParams)
    newton: NewtonParams = field(default_factory=NewtonParams)
    precond: str = "block_jacobi"
    mass: str = "consistent"
    rayleigh_alpha: float = 0.0
    rayleigh_beta: float = 0.0
    predictor: str = "constdis"


class SolidField:
    """Discretization + material + conditions -> lattice operators."""

    def __init__(self, disc: Discretization, materials: dict,
                 params: SolidParams, dirichlet=(), neumann=(),
                 functions: FunctionManager | None = None,
                 device="cpu", dtype=torch.float64):
        self.disc = disc
        self.params = params
        self.device = torch.device(device)
        self.dtype = dtype
        self.functions = functions or FunctionManager()
        self.ndpn = disc.dim
        self.dofmap = disc.dofmap(self.ndpn)
        self.ndof = self.dofmap.ndof
        self.dbc = DirichletHandler(list(dirichlet), disc.coords, self.ndpn,
                                    self.functions)
        self.neumann = list(neumann)
        self.block_mat = {}
        for key, blk in disc.blocks.items():
            mid = int(blk.mat_id[0])
            if not np.all(blk.mat_id == mid):
                raise ValueError(f"block {key} mixes materials")
            self.block_mat[key] = materials[mid]
        self._check_supported()
        self.lattice = _lat.detect_lattice(disc)
        if self.lattice is None:
            raise NotImplementedError(
                "only a single-block uniform hex8 lattice is ported")
        key = next(iter(self.block_mat))
        mat = self.block_mat[key]
        self.cell = get_cell("hex8")
        self.model = _lat.material_model(mat)
        if self.model is None:
            raise NotImplementedError(f"no lattice kernel for {mat!r}")
        self.lam, self.mu = (float(x) for x in lame(mat.youngs, mat.nue))
        self.density = float(mat.density or 0.0)
        G, wdet = _lat.uniform_geometry(self.cell, self.lattice)
        self.G, self.wdet, self.N = (self._t(x) for x in (G, wdet,
                                                          self.cell.N))
        self.Xe1 = disc.coords[disc.blocks[key].conn[:1]]  # (1, 8, 3)
        self.mass_stencil = self._t(self._mass_stencil())
        free = torch.as_tensor(self.dbc.free_mask, dtype=torch.float64)
        self.free = self.to_lattice(free.to(self.device)) > 0
        self._neumann_data = []
        for nb in self.neumann:
            if nb.kind != "traction":
                raise NotImplementedError(f"Neumann kind {nb.kind!r}")
            for fb in nb.faces:
                fc = get_cell(fb.cell)
                self._neumann_data.append((nb, fc, fb.conn,
                                           disc.coords[fb.conn]))

    def _check_supported(self):
        p = self.params
        if (len(self.block_mat) != 1 or self.ndpn != 3
                or p.kinem != "nonlinear" or p.tech != "none"
                or p.mass != "consistent" or p.rayleigh_alpha
                or p.rayleigh_beta):
            raise NotImplementedError(
                "the lattice slice supports one hex8 block, kinem "
                "'nonlinear', tech 'none', consistent mass, no Rayleigh "
                "damping")

    def _t(self, x):
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=self.device).contiguous()

    # -- layout -----------------------------------------------------------

    def to_lattice(self, v):
        return _lat.to_lattice(v, self.lattice)

    def from_lattice(self, x):
        return _lat.from_lattice(x, self.lattice)

    # -- operators (padded lattice layout) --------------------------------

    def internal_force(self, u):
        return lk.neo_force(u, self.G, self.wdet, self.lam, self.mu,
                            self.model)

    def tangent(self, u, v, mcoef=0.0):
        """K(u) v + mcoef * sum_g wdet N N^T v (mcoef includes rho)."""
        return lk.neo_tangent(u, v, self.G, self.wdet, self.N, self.lam,
                              self.mu, self.model, mcoef)

    def mass_matvec(self, v):
        return lk.stencil_matvec(self.mass_stencil, v)

    def external_force(self, t):
        """Surface tractions at time t, assembled on the host in float64."""
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
        return self.to_lattice(self._t(f))

    def lumped_mass(self):
        ml = ops.lumped_mass(self.Xe1, self.cell, self.density)[0]  # (8,)
        nodal = _lat.assemble_uniform(np.repeat(ml[:, None], 3, axis=1),
                                      self.lattice.nshape)
        return self.to_lattice(self._t(nodal.reshape(-1)))

    def _mass_stencil(self):
        """Congruent-element consistent mass as an (8, 3, 8, 3) stencil,
        column k = M e_k of the element mass."""
        ve = np.eye(24).reshape(24, 8, 3)
        cols = ops.consistent_mass_matvec(np.repeat(self.Xe1, 24, axis=0), ve,
                                          self.cell, self.density)
        return _lat.collapse_stencil(cols.reshape(24, 24).T)


def init_state(f: SolidField):
    """Zero state, flat dof vectors."""
    z = torch.zeros(f.ndof, dtype=f.dtype, device=f.device)
    return {"d": z, "v": z.clone(), "a": z.clone(), "t": 0.0, "step": 0,
            "fint": z.clone(), "fext": z.clone()}


def compute_initial_state(f: SolidField, state, consistent_mass_tol=1e-10):
    """Forces and the acceleration consistent with (d, v, t):
    M a0 = f_ext(0) - f_int(d0), solved with Jacobi-preconditioned CG."""
    t0 = state["t"]
    d0 = f.dbc.apply(state["d"], t0)
    fint0 = f.internal_force(f.to_lattice(d0))
    fext0 = f.external_force(t0)
    rhs = torch.where(f.free, fext0 - fint0, 0.0)

    def Mop(v):
        vm = torch.where(f.free, v, 0.0)
        return torch.where(f.free, f.mass_matvec(vm), v)

    res = solvers.cg(Mop, rhs, M=jacobi(torch.clamp(f.lumped_mass(),
                                                    min=1e-300)),
                     tol=consistent_mass_tol, maxiter=200)
    a0 = torch.where(f.free, res.x, 0.0)
    new = dict(state)
    new.update(d=d0, a=f.from_lattice(a0), fint=f.from_lattice(fint0),
               fext=f.from_lattice(fext0))
    return new


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


def make_step(f: SolidField, dt: float | None = None):
    """Build ``step(state) -> (state, stats)`` for the configured
    integrator (gen-alpha with GMG on this slice)."""
    dt = float(dt if dt is not None else f.params.dt)
    if f.params.dyntype != "genalpha":
        raise NotImplementedError(
            f"DYNAMICTYPE {f.params.dyntype!r} is not ported (genalpha is)")
    if f.params.precond != "gmg":
        raise NotImplementedError(
            f"precond {f.params.precond!r} is not ported (gmg is)")
    return _make_genalpha_step(f, dt)


def _make_genalpha_step(f: SolidField, dt: float):
    from fourc_tpu_torch.linalg import gmg
    from fourc_tpu_torch.physics import solid_lattice

    ga = f.params.genalpha
    M_gmg = gmg.build_for_solid(
        f, mass_shift=(1 - ga.alpha_m) / (ga.beta * dt * dt))
    return solid_lattice.make_lattice_genalpha_step(f, dt, M_gmg)
