"""Incompressible fluid field: stabilized Navier-Stokes and its time steps.

Counterpart of fourc_tpu/physics/fluid.py: ``FluidField`` holds the mesh,
the Newtonian law, the conditions (Dirichlet, Neumann tractions, body
forces, Windkessel outflows) and gives the residual r(x, xdot, t) (the
element operators of ops/fluid.py per block, assembled by the dof map's
slot-order sums), optionally on a moving (ALE) mesh; ``init_state`` and
``make_step`` build the stationary, one-step-theta, BDF2 and gen-alpha
steps.  Dofs per node: [u_1 .. u_d, p].

Newton's operator is the exact Jacobian action of the residual, the
reference's ``jax.jvp``: ``linearize`` gives it in closed form from the
residual's intermediates (ops/fluid.py), with the stabilization parameters
and the LES closures frozen (computed from detached inputs).  Forward mode
through the residual gives the same action at 16-26x the time per apply
(``tools/fluid_tangent_ab.py``).  The geometry is computed on the host in
float64 (once per mesh, or once per step on a moving mesh) and the loads
of a time on the host too, then moved to the field's device in its dtype,
so that every device starts from the same bits.  Everything else runs on
the field's device: the CUDA card unless the CPU is asked for.
Turbulence statistics (``sampling_start``) and AVM3 are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from fourc_tpu_torch.core.cells import get_cell
from fourc_tpu_torch.core.conditions import DirichletHandler
from fourc_tpu_torch.core.device import resolve_device
from fourc_tpu_torch.core.functions import FunctionManager
from fourc_tpu_torch.core.mesh import Discretization
from fourc_tpu_torch.linalg.precond import jacobi
from fourc_tpu_torch.linalg.solvers import tree_sum
from fourc_tpu_torch.ops import common as gm
from fourc_tpu_torch.ops import fluid as ops
from fourc_tpu_torch.ops import turbulence as tops
from fourc_tpu_torch.ops.scalar import _test, diffusion_diagonal
from fourc_tpu_torch.ops.solid import element_geometry
from fourc_tpu_torch.physics.newton import NewtonParams, newton_solve

DYNTYPES = ("stationary", "onesteptheta", "bdf2", "genalpha")
TURBULENCE_MODELS = ("none", "smagorinsky", "dynamic_smagorinsky",
                     "multifractal")


@dataclass
class FluidParams:
    dyntype: str = "onesteptheta"  # one of DYNTYPES
    dt: float = 1.0
    theta: float = 0.5
    rho_inf: float = 0.5  # gen-alpha spectral radius
    newton: NewtonParams = field(default_factory=NewtonParams)
    stab: bool = True  # SUPG, PSPG and grad-div
    smagorinsky_cs: float = 0.0  # constant-Smagorinsky Cs (0 = laminar)
    turbulence_model: str = "none"  # one of TURBULENCE_MODELS
    csgs: float = 0.25  # multifractal subgrid coefficient
    initial_funct: int = 0


def _host_geometry(X, cell):
    """(G, wdet) of element coordinates X (E, nen, d) on the host in
    float64, element index last."""
    Xt = torch.as_tensor(np.ascontiguousarray(
        X.reshape(X.shape[0], -1).T), dtype=torch.float64)
    return element_geometry(Xt, cell)


class FluidField:
    """Discretization + Newtonian laws + conditions -> the stabilized
    residual and its helpers, on ``device`` in ``dtype``.  materials:
    {mat_id: law}; windkessel: the deck's ``windkessel_outflow`` entries
    ({faces, r1, r2, c, p0})."""

    quantity = "velocity"

    def __init__(self, disc: Discretization, materials: dict,
                 params: FluidParams, dirichlet=(), neumann=(),
                 body_forces=(), functions: FunctionManager | None = None,
                 windkessel=(), device="cuda", dtype=torch.float64):
        if params.turbulence_model not in TURBULENCE_MODELS:
            raise NotImplementedError(
                f"turbulence_model {params.turbulence_model!r} is not "
                f"ported ({', '.join(TURBULENCE_MODELS)} are)")
        self.disc = disc
        self.params = params
        self.device = resolve_device(device)
        self.dtype = dtype
        self.functions = functions or FunctionManager()
        self.dim = disc.dim
        self.ndpn = disc.dim + 1  # velocity + pressure
        self.dofmap = disc.dofmap(self.ndpn, lattice=False)
        self.ndof = self.dofmap.ndof
        self.dbc = DirichletHandler(list(dirichlet), disc.coords, self.ndpn,
                                    self.functions)
        self.free = torch.as_tensor(self.dbc.free_mask, device=self.device)
        self.pdof = torch.as_tensor(
            np.arange(self.ndof) % self.ndpn == self.dim, device=self.device)
        self.neumann = list(neumann)
        self.body_forces = list(body_forces)
        self.block_mat, self.cells, self.geo64, self.geometry = {}, {}, {}, {}
        self.patches, self.xg = {}, {}
        for key, blk in disc.blocks.items():
            m = materials[int(blk.mat_id[0])]
            if getattr(m, "kind", None) != "fluid":
                raise NotImplementedError(
                    f"element block {key!r}: material {type(m).__name__} in "
                    f"a fluid field (newtonianfluid is ported)")
            cell = get_cell(blk.cell)
            self.block_mat[key], self.cells[key] = m, cell
            self.geo64[key] = _host_geometry(disc.coords[blk.conn], cell)
            self.geometry[key] = self._to_device(self.geo64[key], cell)
            self.xg[key] = np.einsum("ga,ead->egd", cell.N,
                                     disc.coords[blk.conn])
            self.patches[key] = tops.PatchFilter(self.dofmap.blocks[key],
                                                 disc.n_nodes)
        self.windkessel = []
        for wk in windkessel:
            self.windkessel.append(dict(
                W=self._to(self._flux_weights(wk["faces"])),
                r1=float(wk.get("r1", 0.0)), r2=float(wk.get("r2", 1.0)),
                c=float(wk.get("c", 1.0)), p0=float(wk.get("p0", 0.0))))
        self._moving = (None, None)  # (mesh displacement, its geometry)
        self._at_t = {}  # loads of the last time asked for
        self._preconditioners = {}

    def _to(self, a):
        """A host array, list or tensor -> the field's device and dtype."""
        if not torch.is_tensor(a):
            a = torch.as_tensor(np.asarray(a, np.float64))
        return a.to(self.device, self.dtype)

    def _to_device(self, geo, cell):
        G, wdet = geo
        return (self._to(G), self._to(wdet), self._to(np.asarray(cell.N)))

    # -- geometry ------------------------------------------------------------

    def _geometry(self, mesh_disp):
        """{block: (G, wdet, N)} at the reference coordinates, or at the
        coordinates moved by ``mesh_disp`` (n_nodes, d), computed on the
        host once per displacement tensor."""
        if mesh_disp is None:
            return self.geometry
        if self._moving[0] is not mesh_disp:
            X = self.disc.coords + mesh_disp.detach().cpu().double().numpy()
            self._moving = (mesh_disp, {
                key: self._to_device(_host_geometry(
                    X[blk.conn], self.cells[key]), self.cells[key])
                for key, blk in self.disc.blocks.items()})
        return self._moving[1]

    def split(self, x):
        """Global vector -> (velocity (n_nodes, d), pressure (n_nodes,))."""
        xn = x.reshape(-1, self.ndpn)
        return xn[:, :self.dim], xn[:, self.dim]

    # -- loads ---------------------------------------------------------------

    def _loads(self, t):
        """({block: body acceleration (d, g, E) or None}, the Neumann
        traction vector or None) at time t, evaluated on the host and
        kept for the last t asked for."""
        if t not in self._at_t:
            body = {key: self.body_at_gps(key, t) for key in self.geometry}
            self._at_t = {t: (body, self.external_traction(t))}
        return self._at_t[t]

    def body_at_gps(self, key, t):
        """The body acceleration at a block's Gauss points (reference
        coordinates), (d, g, E), or None: per component VAL * FUNCT."""
        if not self.body_forces:
            return None
        xg = self.xg[key]
        out = np.zeros((self.dim,) + xg.shape[:2])
        for bf in self.body_forces:
            for k in range(self.dim):
                if k < len(bf.val) and bf.val[k] != 0:
                    fn = self.functions.get(bf.funct[k])
                    out[k] += bf.val[k] * fn(xg, t, component=0)
        return self._to(np.ascontiguousarray(np.transpose(out, (0, 2, 1))))

    def external_traction(self, t):
        """The Neumann tractions on the velocity dofs (VAL * FUNCT, the
        FUNCT's first component, as the reference's), assembled on the host
        in float64; None without Neumann conditions.  Faces are quad4 (3D)
        or line2 (2D) at the reference coordinates."""
        if not self.neumann:
            return None
        f = np.zeros((self.disc.n_nodes, self.ndpn))
        for nb in self.neumann:
            for fb in nb.faces:
                fc = get_cell(fb.cell)
                Xf = self.disc.coords[fb.conn]
                dA, _ = gm.surface_measure(Xf, fc.dN)
                xg = gm.interp_field(Xf, fc.N)
                trac = np.zeros(dA.shape + (self.dim,))
                for k in range(self.dim):
                    if k < len(nb.onoff) and nb.onoff[k]:
                        fn = self.functions.get(nb.funct[k])
                        trac[..., k] = nb.val[k] * fn(xg, t, component=0)
                fe = np.einsum("g,eg,ga,egd->ead", fc.gauss_weights, dA,
                               fc.N, trac)
                np.add.at(f[:, :self.dim], fb.conn, fe)
        return self._to(f.reshape(-1))

    # -- residual ------------------------------------------------------------

    def residual_transient(self, x, xdot, t, dt=None, mesh_disp=None,
                           mesh_vel=None, rho_gp=None, cont_src_gp=None):
        """The global stabilized residual at time t; x = [u, p] per node.
        mesh_disp / mesh_vel (n_nodes, d): the ALE mesh motion (the
        residual on the moved mesh, convective velocity u - u_grid).
        ``rho_gp`` and ``cont_src_gp`` (low-Mach flow) are refused."""
        if rho_gp is not None or cont_src_gp is not None:
            raise NotImplementedError(
                "fluid residual: rho_gp / cont_src_gp (low-Mach flow) is not "
                "ported")
        return self.linearize(x, xdot, t, dt, mesh_disp, mesh_vel)[0]

    def linearize(self, x, xdot, t, dt=None, mesh_disp=None, mesh_vel=None):
        """The residual of ``residual_transient`` and its derivative
        ``apply(dx, dxdot)`` along increments of x and xdot (the loads do
        not depend on them; tau and the LES closures frozen, as forward
        mode through the residual sees them)."""
        body, traction = self._loads(t)
        dm, p, d, ndpn = self.dofmap, self.params, self.dim, self.ndpn
        per_block, tangents = {}, {}
        for key, (G, wdet, N) in self._geometry(mesh_disp).items():
            m = self.block_mat[key]
            nen = self.cells[key].nen
            xe = dm.gather(x, key).reshape(nen, ndpn, -1)
            ue, pe = xe[:, :d], xe[:, d]
            udote = dm.gather(xdot, key).reshape(nen, ndpn, -1)[:, :d]
            gv = None
            if mesh_vel is not None:
                gv = _nodal(mesh_vel, dm.blocks[key].conn)
            cs2 = mfs_B = mfs_hat = None
            if p.turbulence_model == "dynamic_smagorinsky":
                cs2 = tops.dynamic_cs2(G, wdet, N, ue, self.patches[key])
            elif p.turbulence_model == "multifractal":
                nu = float(m.visc()) / float(m.density)
                mfs_B, u_hat = tops.mfs_fields(G, wdet, N, ue,
                                               self.patches[key], nu,
                                               csgs=p.csgs)
                mfs_hat = _nodal(u_hat, dm.blocks[key].conn)
            f_mom, f_cont, tangents[key] = ops.linearize(
                G, wdet, N, ue, pe, udote, mu=float(m.visc()),
                rho=float(m.density), body=body[key], dt=dt,
                stab=p.stab, grid_vel=gv,
                smagorinsky_cs=p.smagorinsky_cs, cs2=cs2, mfs_B=mfs_B,
                mfs_ue_hat=mfs_hat)
            per_block[key] = torch.cat([f_mom, f_cont[:, None]],
                                       dim=1).reshape(nen * ndpn, -1)
        r = dm.scatter_add(per_block)
        if traction is not None:
            r = r - traction

        def apply(dx, dxdot):
            out = {}
            for key, tangent in tangents.items():
                nen = self.cells[key].nen
                dxe = dm.gather(dx, key).reshape(nen, ndpn, -1)
                dxde = dm.gather(dxdot, key).reshape(nen, ndpn, -1)
                df_mom, df_cont = tangent(dxe[:, :d], dxe[:, d], dxde[:, :d])
                out[key] = torch.cat([df_mom, df_cont[:, None]],
                                     dim=1).reshape(nen * ndpn, -1)
            return dm.scatter_add(out)

        return r, apply

    # -- Windkessel outflow (lumped RCR impedance) ----------------------------

    def _flux_weights(self, faces):
        """W (ndof,) with W . x = int_faces u . n dA: on each velocity dof
        sum_g w dA N_a n_i (host, float64); the pressure dofs 0.  The
        force of an applied pressure p is p W."""
        W = np.zeros((self.disc.n_nodes, self.ndpn))
        for fb in faces:
            fc = get_cell(fb.cell)
            Xf = self.disc.coords[fb.conn]
            dA, n = gm.surface_measure(Xf, fc.dN)
            fe = np.einsum("g,eg,ga,egd->ead", fc.gauss_weights, dA, fc.N, n)
            np.add.at(W[:, :self.dim], fb.conn, fe)
        return W.reshape(-1)

    def _wk_pressure(self, cond, Q, pd_old, dt):
        """Backward-Euler distal pressure and the applied pressure."""
        if dt is None:  # stationary limit: C dp/dt = 0
            pd = cond["r2"] * Q
        else:
            pd = (pd_old + (dt / cond["c"]) * Q) * (
                1.0 / (1.0 + dt / (cond["r2"] * cond["c"])))
        return pd, pd + cond["r1"] * Q

    def windkessel_residual(self, x, pwk, dt):
        """The Windkessel conditions' residual, implicit in x: each applies
        p_d + R1 Q on its faces, Q = int u.n dA."""
        r = torch.zeros_like(x)
        for i, cond in enumerate(self.windkessel):
            Q = tree_sum(cond["W"] * x)
            _, p_app = self._wk_pressure(cond, Q, pwk[i], dt)
            r = r + cond["W"] * p_app
        return r

    def windkessel_tangent(self, dx, dt):
        """The derivative of ``windkessel_residual`` along dx (it is
        affine in x)."""
        r = torch.zeros_like(dx)
        for cond in self.windkessel:
            if dt is None:
                slope = cond["r2"] + cond["r1"]
            else:
                slope = (dt / cond["c"]) * (
                    1.0 / (1.0 + dt / (cond["r2"] * cond["c"]))) + cond["r1"]
            r = r + cond["W"] * (slope * tree_sum(cond["W"] * dx))
        return r

    def windkessel_update(self, x, pwk, dt):
        """The distal pressures after a solve, (n_conditions,)."""
        return torch.stack([
            self._wk_pressure(cond, tree_sum(cond["W"] * x), pwk[i], dt)[0]
            for i, cond in enumerate(self.windkessel)])

    # -- preconditioner ------------------------------------------------------

    def build_preconditioner(self, dt_factor=0.0, dt=None):
        """Physics-based Jacobi at the reference coordinates: velocity
        diagonal mu sum_g wdet grad N_a . grad N_a + rho dt_factor
        sum_g wdet N_a^2, pressure diagonal the PSPG one (tau_M at u = 0)
        / rho; constrained dofs 1.  Built on the host in float64, once
        per (dt_factor, dt)."""
        key = (dt_factor, dt)
        if key not in self._preconditioners:
            self._preconditioners[key] = jacobi(self._to(
                self._jacobi_diagonal(dt_factor, dt)))
        return self._preconditioners[key]

    def _jacobi_diagonal(self, dt_factor, dt):
        per_block = {}
        for key, (G, wdet) in self.geo64.items():
            m = self.block_mat[key]
            mu, rho = float(m.visc()), float(m.density)
            N = torch.as_tensor(np.asarray(self.cells[key].N))
            vdiag = mu * diffusion_diagonal(G, wdet) \
                + (rho * dt_factor) * _test(N * N, wdet)
            u0 = torch.zeros((self.dim,) + wdet.shape, dtype=wdet.dtype)
            tau_m, _ = ops.stab_params(u0, mu, rho, G, wdet, dt)
            pdiag = diffusion_diagonal(G, wdet * tau_m) * (1.0 / rho)
            per_block[key] = torch.cat(
                [vdiag[:, None].expand(-1, self.dim, -1), pdiag[:, None]],
                dim=1).reshape(-1, wdet.shape[1])
        dm64 = self.disc.dofmap(self.ndpn, lattice=False)
        diag = dm64.scatter_add(per_block)
        return torch.where(torch.as_tensor(self.dbc.free_mask),
                           torch.clamp(diag, min=1e-300), 1.0)


def _nodal(v, conn):
    """Nodal vectors v (n_nodes, d) of a block's elements, (nen, d, E)."""
    idx = torch.as_tensor(conn.T, dtype=torch.int64, device=v.device)
    return v[idx].permute(0, 2, 1)


# ---------------------------------------------------------------------------
# state and steps
# ---------------------------------------------------------------------------


def init_state(f: FluidField):
    """x(0) from the initial-field FUNCT (evaluated on the host; velocity
    components first, zeros beyond its components), the prescribed values
    at t = 0 on its Dirichlet rows; xdot 0; the Windkessel distal
    pressures at p0."""
    x0 = np.zeros((f.disc.n_nodes, f.ndpn))
    if f.params.initial_funct:
        vals = np.asarray(f.functions.get(f.params.initial_funct)(
            f.disc.coords, 0.0))
        if vals.ndim == 1:
            vals = vals[:, None]
        k = min(vals.shape[1], f.ndpn)
        x0[:, :k] = vals[:, :k]
    x0 = f.dbc.apply(f._to(x0.reshape(-1)), 0.0)
    state = {"x": x0, "xdot": torch.zeros_like(x0), "x_nm1": x0, "t": 0.0,
             "step": 0}
    if f.windkessel:
        state["pwk"] = f._to([c["p0"] for c in f.windkessel])
    return state


def kept_jacobian(jacobian_at):
    """newton_solve's ``matvec_fn(u, v)`` from ``jacobian_at(u) -> (v ->
    J(u) v)``, linearized once per Newton iterate (the Krylov applies of
    one iterate share u)."""
    kept = [None, None]

    def matvec(u, v):
        if kept[0] is not u:
            kept[0], kept[1] = u, jacobian_at(u)
        return kept[1](v)

    return matvec


def _nonsym(params: NewtonParams) -> NewtonParams:
    """CG cannot solve the nonsymmetric fluid operator: GMRES instead, as
    the reference switches."""
    if params.lin_method == "cg":
        return replace(params, lin_method="gmres")
    return params


def zero_pressure_rate(f: FluidField, xdot):
    """The pressure is not a dynamic variable: its rate is 0."""
    return torch.where(f.pdof, 0.0, xdot)


def solve(f, residual, jacobian_at, x0, M):
    """Newton-Krylov on the free dofs, GMRES where the deck asks for CG."""
    return newton_solve(residual, x0, f.free, M, _nonsym(f.params.newton),
                        kept_jacobian(jacobian_at))


def _finish(f, state, x, xdot, dt, stationary, stats):
    """The state after a converged solve x: the Windkessel pressures, the
    rate (masked; kept by a stationary step), x_nm1, t and the step."""
    new = dict(state)
    if f.windkessel:
        new["pwk"] = f.windkessel_update(x, state["pwk"],
                                         None if stationary else dt)
    if not stationary:
        new["xdot"] = f.dbc.mask(xdot)
    new.update(x=x, x_nm1=state["x"], t=state["t"] + dt,
               step=state["step"] + 1)
    return new, stats


def make_step(f: FluidField, dt: float | None = None):
    """The step function state -> (state, Newton stats) of the deck's
    integrator."""
    dt = float(dt if dt is not None else f.params.dt)
    steps = {"stationary": _stationary_step, "onesteptheta": _ost_step,
             "bdf2": _bdf2_step, "genalpha": _genalpha_step}
    if f.params.dyntype not in steps:
        raise ValueError(f"unknown FLUID DYNAMICTYPE {f.params.dyntype!r}")
    return steps[f.params.dyntype](f, dt)


def _stationary_step(f, dt):
    def step(state):
        t1 = state["t"] + dt
        zero = torch.zeros_like(state["x"])

        def residual(x):
            r = f.residual_transient(x, zero, t1, dt=None)
            if f.windkessel:
                r = r + f.windkessel_residual(x, state["pwk"], None)
            return r

        def jacobian_at(x):
            _, apply = f.linearize(x, zero, t1, dt=None)

            def J(v):
                out = apply(v, zero)
                if f.windkessel:
                    out = out + f.windkessel_tangent(v, None)
                return out

            return J

        x, stats = solve(f, residual, jacobian_at,
                         f.dbc.apply(state["x"], t1), f.build_preconditioner())
        return _finish(f, state, x, None, dt, True, stats)

    return step


def _implicit_step(f, dt, rates, drate, dt_factor, alphas=None):
    """One implicit step of the unknown x_{n+1}: the residual at
    (x, rates(x, state), t_n + dt), or with ``alphas`` (af, am) (gen-alpha)
    at (x_{n+af}, xdot_{n+am}, t_n + af dt), x_{n+af} = (1 - af) x_n
    + af x, xdot_{n+am} = (1 - am) xdot_n + am rates(x, state); the
    Windkessel's at x.  drate is the factor of x in the rate; the Jacobi
    preconditioner carries ``dt_factor`` times the mass."""
    af, am = alphas or (1.0, 1.0)

    def step(state):
        t1 = state["t"] + dt
        t_af = state["t"] + af * dt if alphas else t1
        x_n, xdot_n = state["x"], state["xdot"]

        def point(x):
            if not alphas:
                return x, rates(x, state)
            return ((1.0 - af) * x_n + af * x,
                    (1.0 - am) * xdot_n + am * rates(x, state))

        def residual(x):
            r = f.residual_transient(*point(x), t_af, dt=dt)
            if f.windkessel:
                r = r + f.windkessel_residual(x, state["pwk"], dt)
            return r

        def jacobian_at(x):
            _, apply = f.linearize(*point(x), t_af, dt=dt)

            def J(v):
                dxdot = zero_pressure_rate(f, v * drate)
                out = apply(af * v, am * dxdot) if alphas else \
                    apply(v, dxdot)
                if f.windkessel:
                    out = out + f.windkessel_tangent(v, dt)
                return out

            return J

        x, stats = solve(f, residual, jacobian_at, f.dbc.apply(x_n, t1),
                         f.build_preconditioner(dt_factor=dt_factor, dt=dt))
        return _finish(f, state, x, rates(x, state), dt, False, stats)

    return step


def _ost_step(f, dt):
    th = f.params.theta
    c1, c0 = 1.0 / (th * dt), (1.0 - th) / th

    def rates(x, state):
        return zero_pressure_rate(f, (x - state["x"]) * c1
                                  - c0 * state["xdot"])

    return _implicit_step(f, dt, rates, c1, c1)


def _bdf2_step(f, dt):
    inv_dt, inv_2dt = 1.0 / dt, 1.0 / (2.0 * dt)

    def rates(x, state):
        if state["step"] == 0:  # backward Euler on the first step
            return zero_pressure_rate(f, (x - state["x"]) * inv_dt)
        return zero_pressure_rate(
            f, (3.0 * x - 4.0 * state["x"] + state["x_nm1"]) * inv_2dt)

    def step(state):
        drate = inv_dt if state["step"] == 0 else 3.0 * inv_2dt
        return _implicit_step(f, dt, rates, drate, 1.5 / dt)(state)

    return step


def _genalpha_step(f, dt):
    """First-order generalized-alpha (Jansen-Whiting-Hulbert): alpha_m =
    (3 - rho_inf) / (2 (1 + rho_inf)), alpha_f = 1 / (1 + rho_inf),
    gamma = 1/2 + alpha_m - alpha_f."""
    rho = f.params.rho_inf
    am = 0.5 * (3.0 - rho) / (1.0 + rho)
    af = 1.0 / (1.0 + rho)
    gam = 0.5 + am - af
    c1, c0 = 1.0 / (gam * dt), 1.0 - 1.0 / gam

    def rates(x, state):
        return zero_pressure_rate(f, (x - state["x"]) * c1
                                  + c0 * state["xdot"])

    return _implicit_step(f, dt, rates, c1, am / (af * gam * dt),
                          alphas=(af, am))
