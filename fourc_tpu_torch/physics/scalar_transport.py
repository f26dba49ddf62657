"""Scalar-transport field (scatra and thermo share it) and its time steps.

Counterpart of fourc_tpu/physics/scalar_transport.py for one scalar per
node: ``ScalarField`` holds the mesh, the laws and the conditions and
gives the residual r(phi, phidot, t) (ops/scalar.py per block, assembled by
the dof map's slot-order sums), the lumped capacity and the Jacobi
preconditioner; ``make_step`` builds the stationary, one-step-theta, BDF2
or gen-alpha step (first-order gen-alpha with the reference's rho_inf
parametrisation or explicit coefficients).  Newton's operator is the exact
derivative of the residual, as the reference takes ``jax.jvp``: the
residual is affine in (phi, phidot) (the velocity and the reaction
coefficient do not depend on phi), so its derivative is its linear part,
``residual_transient(..., linear=True)`` at the increments, which performs
forward mode's operations on the tangent to the bit
(tests/port/test_torch_thermo.py; ``chip_smoke.py`` phase 15 (b) times the
two against each other).  During a step the Dirichlet rows of the rate
carry the exact time derivative of the prescribed values
(``DirichletHandler.rates``, once per step).  Everything runs on the
field's device: the CUDA card unless the CPU is asked for.  Several scalars
per node (the reference's ``ndpn > 1`` branch) are refused by name.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from fourc_tpu_torch.core.cells import get_cell
from fourc_tpu_torch.core.conditions import DirichletHandler
from fourc_tpu_torch.core.device import resolve_device
from fourc_tpu_torch.core.functions import FunctionManager, FunctionOfSpaceTime
from fourc_tpu_torch.core.mesh import Discretization
from fourc_tpu_torch.linalg import solvers
from fourc_tpu_torch.linalg.precond import jacobi
from fourc_tpu_torch.ops import common as gm
from fourc_tpu_torch.ops import scalar as ops
from fourc_tpu_torch.ops.solid import element_geometry
from fourc_tpu_torch.physics.newton import NewtonParams, newton_solve


@dataclass
class GenAlphaScalarParams:
    """First-order gen-alpha: alpha_f = 1 / (1 + rho_inf), alpha_m =
    (3 - rho_inf) / (2 (1 + rho_inf)), gamma = 1/2 + alpha_m - alpha_f,
    each overridden where the deck gives it (ALPHA_F, ALPHA_M, GAMMA)."""

    rho_inf: float = 1.0
    alpha_f_in: float | None = None
    alpha_m_in: float | None = None
    gamma_in: float | None = None

    @property
    def alpha_f(self):
        if self.alpha_f_in is not None:
            return float(self.alpha_f_in)
        return 1.0 / (1.0 + self.rho_inf)

    @property
    def alpha_m(self):
        if self.alpha_m_in is not None:
            return float(self.alpha_m_in)
        return 0.5 * (3.0 - self.rho_inf) / (1.0 + self.rho_inf)

    @property
    def gamma(self):
        if self.gamma_in is not None:
            return float(self.gamma_in)
        return 0.5 + self.alpha_m - self.alpha_f


DYNTYPES = ("stationary", "onesteptheta", "bdf2", "genalpha")


@dataclass
class ScalarParams:
    dyntype: str = "onesteptheta"  # one of DYNTYPES
    dt: float = 1.0
    n_steps: int = 1
    theta: float = 0.5
    genalpha: GenAlphaScalarParams = field(
        default_factory=GenAlphaScalarParams)
    newton: NewtonParams = field(default_factory=NewtonParams)
    stab: str = "taylor"  # SUPG tau: ops.TAU_KINDS
    velocity: list | None = None  # convective velocity expressions
    initial_funct: int = 0  # initial field function id
    divercont: str = "stop"
    max_halvings: int = 5


class ScalarField:
    """Discretization + scalar laws + conditions -> the residual and its
    helpers, on ``device`` in ``dtype``.  materials: {mat_id: law}; a
    ``scatra`` law (diffusivity, reaction, capacity) or a thermal one
    (conductivity, density times capacity)."""

    quantity = "phi"

    def __init__(self, disc: Discretization, materials: dict,
                 params: ScalarParams, dirichlet=(), neumann=(),
                 body_forces=(), functions: FunctionManager | None = None,
                 device="cuda", dtype=torch.float64):
        self.disc = disc
        self.params = params
        self.device = resolve_device(device)
        self.dtype = dtype
        self.functions = functions or FunctionManager()
        self.ndpn = 1
        self.dofmap = disc.dofmap(1, lattice=False)
        self.ndof = self.dofmap.ndof
        self.dbc = DirichletHandler(list(dirichlet), disc.coords, 1,
                                    self.functions)
        self.free = torch.as_tensor(self.dbc.free_mask, device=self.device)
        self.neumann = list(neumann)
        self.body_forces = list(body_forces)
        self.block_mat, self.geometry, self.props = {}, {}, {}
        for key, blk in disc.blocks.items():
            m = materials[int(blk.mat_id[0])]
            if getattr(m, "nspec", 1) > 1:
                raise NotImplementedError(
                    f"element block {key!r}: {getattr(m, 'nspec')} scalars "
                    f"per node (multi-species transport) is not ported")
            self.block_mat[key] = m
            self.props[key] = self._mat_props(key, m)
            cell = get_cell(blk.cell)
            X = torch.as_tensor(disc.coords[blk.conn])  # float64, host
            X = X.reshape(X.shape[0], -1).T.contiguous()
            G, wdet = element_geometry(X, cell)
            N = torch.as_tensor(np.asarray(cell.N))
            self.geometry[key] = tuple(
                t.to(self.device, self.dtype) for t in (
                    G, wdet, N, ops.gp_coords(X, N)))
        self._vel_fn = (FunctionOfSpaceTime.from_spec(
            [str(v) for v in params.velocity])
            if params.velocity is not None else None)
        self._neumann_data = []
        for nb in self.neumann:
            for fb in nb.faces:
                self._neumann_data.append((nb, get_cell(fb.cell), fb.conn,
                                           disc.coords[fb.conn]))
        self._at_t = {}  # loads and velocities of the last time asked for

    def _mat_props(self, key, m):
        """(diff, rhoc, reaction) of a block's law: the scatra law's
        diffusivity, capacity and reaction; a thermal law's conductivity
        and density times capacity (0 read as 1, as the reference)."""
        kind = getattr(m, "kind", None)
        if kind == "scatra":
            diff = m.diff()
            if isinstance(diff, np.ndarray):
                d = self.disc.dim
                if diff.shape != (d, d):
                    raise NotImplementedError(
                        f"element block {key!r}: a {diff.shape} "
                        f"diffusivity on a {d}D mesh")
                diff = torch.as_tensor(diff, dtype=self.dtype,
                                       device=self.device)
            return diff, float(m.capacity or 1.0), m.reaction
        if kind in ("thermo", "thermo_solid"):
            rhoc = float(m.density or 1.0) * float(m.capacity or 1.0)
            return float(m.conductivity), rhoc, None
        raise NotImplementedError(
            f"element block {key!r}: material {type(m).__name__} in a "
            f"scalar field (scatra, fourier and thermostvenantkirchhoff "
            f"are ported)")

    def _loads(self, t):
        """{block: (velocity (d, g, E) or None, source (g, E) or None)} and
        the Neumann flux vector at time t, computed once per t."""
        if t not in self._at_t:
            per_block = {}
            for key, (_, _, _, xg) in self.geometry.items():
                vel = None
                if self._vel_fn is not None:
                    vel = torch.stack([self._vel_fn.on_device(xg, t, k)
                                       for k in range(self.disc.dim)])
                src = None
                for bf in self.body_forces:
                    s = bf.val[0] * self.functions.get(
                        bf.funct[0]).on_device(xg, t, 0)
                    src = s if src is None else src + s
                per_block[key] = (vel, src)
            self._at_t = {t: (per_block, self.neumann_flux(t))}
        return self._at_t[t]

    def residual_transient(self, phi, phidot, t, dt=None, extra_source=None,
                           linear=False):
        """The global residual r(phi, phidot) at time t; ``extra_source``
        {block: (g, E)} adds a source at the Gauss points (TSI's heating);
        dt None is the stationary SUPG parameter.  With ``linear`` only its
        part linear in (phi, phidot, extra_source), without the body-force
        source and the Neumann flux: at increments, the residual's
        derivative along them."""
        loads, flux = self._loads(t)
        if linear:
            flux = None
        dm = self.dofmap
        stab = self.params.stab if self._vel_fn is not None else "zero"
        per_block = {}
        for key, (G, wdet, N, _) in self.geometry.items():
            diff, rhoc, reaction = self.props[key]
            vel, src = loads[key]
            per_block[key] = ops.residual(
                G, wdet, N, dm.gather(phi, key), dm.gather(phidot, key),
                diff, rhoc, vel=vel, reaction=reaction,
                source=None if linear else src,
                tau_kind=stab, dt=dt,
                extra_source=None if extra_source is None
                else extra_source.get(key))
        r = dm.scatter_add(per_block)
        return r if flux is None else r - flux

    def neumann_flux(self, t):
        """Prescribed boundary flux (positive into the domain), assembled
        on the host in float64 at time t; None without Neumann conditions.
        One scalar per node: the reference's node index is its dof."""
        if not self._neumann_data:
            return None
        f = np.zeros(self.ndof)
        for nb, fc, conn, Xf in self._neumann_data:
            xg = gm.interp_field(Xf, fc.N)
            q = nb.val[0] * self.functions.get(nb.funct[0])(xg, t,
                                                           component=0)
            fe = ops.surface_flux(Xf, np.broadcast_to(q, xg.shape[:2]), fc)
            f += np.bincount(conn.reshape(-1), weights=fe.reshape(-1),
                             minlength=self.ndof)
        return torch.as_tensor(f, dtype=self.dtype, device=self.device)

    def lumped_capacity(self):
        return self.dofmap.scatter_add({
            key: ops.capacity_lumped(wdet, N, self.props[key][1])
            for key, (_, wdet, N, _) in self.geometry.items()})

    def build_preconditioner(self, dt_factor=0.0):
        """Jacobi from the diffusion operator's diagonal (D sum_g wdet
        grad N_a . grad N_a, D's mean principal value where it is a
        tensor) plus ``dt_factor`` times the lumped capacity; constrained
        dofs 1."""
        per_block = {}
        for key, (G, wdet, N, _) in self.geometry.items():
            diff, rhoc, _ = self.props[key]
            if torch.is_tensor(diff):
                diff = float(torch.diagonal(diff).sum()) / diff.shape[0]
            kdiag = diff * ops.diffusion_diagonal(G, wdet)
            if dt_factor:
                kdiag = kdiag + dt_factor * ops.capacity_lumped(wdet, N, rhoc)
            per_block[key] = kdiag
        diag = self.dofmap.scatter_add(per_block)
        return jacobi(torch.where(self.free, torch.clamp(diag, min=1e-300),
                                  1.0))


# ---------------------------------------------------------------------------
# state and steps
# ---------------------------------------------------------------------------


def init_state(f: ScalarField):
    """phi(0) from the initial-field FUNCT (0 without one), the prescribed
    values at t = 0 on its Dirichlet rows; phidot 0."""
    phi0 = np.zeros(f.ndof)
    if f.params.initial_funct:
        phi0 = np.array(f.functions.get(f.params.initial_funct)(
            f.disc.coords, 0.0, component=0))
    phi0 = f.dbc.apply(torch.as_tensor(phi0, dtype=f.dtype, device=f.device),
                       0.0)
    return {"phi": phi0, "phidot": torch.zeros_like(phi0),
            "phi_nm1": phi0, "t": 0.0, "step": 0}


def compute_initial_state(f: ScalarField, state):
    """The consistent initial rate: C phidot0 = -r(phi0, 0), with the
    consistent capacity C applied as the residual's change in phidot (it
    is affine in phidot), solved by CG with the lumped capacity as Jacobi
    (tol 1e-12, at most 200 iterations), as the reference's; the residual
    at phidot = 0 is evaluated once.  A stationary field keeps its state."""
    if f.params.dyntype == "stationary":
        return state
    t0, phi = state["t"], state["phi"]
    zero = torch.zeros_like(phi)
    r0 = f.residual_transient(phi, zero, t0, dt=f.params.dt)

    def massmat(v):
        return f.dbc.mask(f.residual_transient(phi, v, t0, dt=f.params.dt)
                          - r0)

    c = f.lumped_capacity()
    cinv = torch.where(f.free, 1.0 / torch.clamp(c, min=1e-300), 1.0)
    res = solvers.cg(massmat, f.dbc.mask(-r0), M=lambda x: cinv * x,
                     tol=1e-12, maxiter=200)
    new = dict(state)
    new["phidot"] = f.dbc.mask(res.x)
    return new


def make_step(f: ScalarField, dt: float | None = None):
    """``step(state) -> (state, stats)`` of the field's DYNAMICTYPE."""
    dt = float(dt if dt is not None else f.params.dt)
    typ = f.params.dyntype
    if typ not in DYNTYPES:
        raise ValueError(f"unknown scalar DYNAMICTYPE {typ!r}")
    return {"stationary": _stationary_step, "onesteptheta": _ost_step,
            "bdf2": _bdf2_step, "genalpha": _genalpha_step}[typ](f, dt)


def _solve(f, residual, phi0, M, tangent):
    """Newton with the derivative ``tangent(v)`` of ``residual``."""
    return newton_solve(residual, phi0, f.free, M, f.params.newton,
                        lambda _, v: tangent(v), batched=True)


def _finish(state, phi, phidot, t1, stats):
    new = dict(state)
    new.update(phi=phi, phidot=phidot, phi_nm1=state["phi"], t=t1,
               step=state["step"] + 1)
    return new, stats


def _stationary_step(f, dt):
    def step(state):
        t1 = state["t"] + dt
        zero = torch.zeros_like(state["phi"])

        def residual(phi):
            return f.residual_transient(phi, zero, t1, dt=None)

        def tangent(v):
            return f.residual_transient(v, zero, t1, dt=None, linear=True)

        phi, stats = _solve(f, residual, f.dbc.apply(state["phi"], t1),
                            f.build_preconditioner(), tangent)
        new, stats = _finish(state, phi, state["phidot"], t1, stats)
        return new, stats

    return step


def _ost_step(f, dt):
    th = f.params.theta

    def step(state):
        t1 = state["t"] + dt
        phi_n, phidot_n = state["phi"], state["phidot"]
        rates = f.dbc.rates(t1, phi_n)

        def rate_of(phi):
            return torch.where(f.free, (phi - phi_n) * (1.0 / (th * dt))
                               - (1 - th) / th * phidot_n, rates)

        def residual(phi):
            return f.residual_transient(phi, rate_of(phi), t1, dt=dt)

        def tangent(v):
            rate = torch.where(f.free, v * (1.0 / (th * dt)), 0.0)
            return f.residual_transient(v, rate, t1, dt=dt, linear=True)

        phi, stats = _solve(f, residual, f.dbc.apply(phi_n, t1),
                            f.build_preconditioner(1.0 / (th * dt)), tangent)
        return _finish(state, phi, rate_of(phi), t1, stats)

    return step


def _bdf2_step(f, dt):
    """BDF2; its first step is backward Euler."""

    def step(state):
        t1 = state["t"] + dt
        phi_n, phi_nm1 = state["phi"], state["phi_nm1"]
        first = state["step"] == 0
        rates = f.dbc.rates(t1, phi_n)

        def rate_of(phi):
            rate = ((phi - phi_n) * (1.0 / dt) if first else
                    (3.0 * phi - 4.0 * phi_n + phi_nm1) * (1.0 / (2.0 * dt)))
            return torch.where(f.free, rate, rates)

        def residual(phi):
            return f.residual_transient(phi, rate_of(phi), t1, dt=dt)

        def tangent(v):
            rate = (v * (1.0 / dt) if first else
                    (3.0 * v) * (1.0 / (2.0 * dt)))
            return f.residual_transient(v, torch.where(f.free, rate, 0.0),
                                        t1, dt=dt, linear=True)

        phi, stats = _solve(f, residual, f.dbc.apply(phi_n, t1),
                            f.build_preconditioner(1.5 / dt), tangent)
        return _finish(state, phi, rate_of(phi), t1, stats)

    return step


def _genalpha_step(f, dt):
    ga = f.params.genalpha
    af, am, gamma = ga.alpha_f, ga.alpha_m, ga.gamma

    def step(state):
        t1 = state["t"] + dt
        taf = state["t"] + af * dt
        phi_n, phidot_n = state["phi"], state["phidot"]
        rates = f.dbc.rates(t1, phi_n)

        def rate_of(phi1):
            return torch.where(f.free, (phi1 - phi_n) * (1.0 / (gamma * dt))
                               + (1.0 - 1.0 / gamma) * phidot_n, rates)

        def residual(phi1):
            phi_af = af * phi1 + (1 - af) * phi_n
            phidot_am = am * rate_of(phi1) + (1 - am) * phidot_n
            return f.residual_transient(phi_af, phidot_am, taf, dt=dt)

        def tangent(v):
            rate = torch.where(f.free, v * (1.0 / (gamma * dt)), 0.0)
            return f.residual_transient(af * v, am * rate, taf, dt=dt,
                                        linear=True)

        phi, stats = _solve(f, residual, f.dbc.apply(phi_n, t1),
                            f.build_preconditioner(
                                am / (gamma * dt * af + 1e-300)), tangent)
        return _finish(state, phi, rate_of(phi), t1, stats)

    return step
