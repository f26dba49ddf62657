"""Thermo-structure interaction (TSI): the coupled field.

Counterpart of fourc_tpu/physics/tsi.py: a solid field and a thermo field
on the same mesh (the thermo field clones the structure's), the coupling
terms at the Gauss points and the stacked layout y = [d; T] of the
monolithic Newton.

Physics (linear thermo-elasticity, e.g. ``thermostvenantkirchhoff``):
  structure: div P(F, T) + b = rho a, S += -(3 lam + 2 mu) alpha (T - T0) I
  thermo:    rho c Tdot = div(k grad T) - T0 (3 lam + 2 mu) alpha tr(eps_dot)
The solid field takes general topology (``SolidField(general=True)``): its
temperatures reach the element route, and its hex8 mass stays B6's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from fourc_tpu_torch.ops import scalar as ops
from fourc_tpu_torch.physics import scalar_transport as st
from fourc_tpu_torch.physics import solid as ps

COUPLINGS = ("oneway", "partitioned", "monolithic")


@dataclass
class TsiParams:
    coupling: str = "monolithic"  # one of COUPLINGS
    dt: float = 1.0
    n_steps: int = 1
    itemax_outer: int = 20  # partitioned outer fixed-point iterations
    convtol_outer: float = 1e-8


class TsiField:
    """A solid and a thermo field on one mesh (the reference's field
    cloning: the same nodes, elements and block keys)."""

    def __init__(self, solid: ps.SolidField, thermo: st.ScalarField,
                 params: TsiParams):
        if solid.disc.n_nodes != thermo.disc.n_nodes or solid.lattice \
                is not None:
            raise ValueError("TSI needs cloned meshes and a solid field of "
                             "general topology")
        self.solid = solid
        self.thermo = thermo
        self.params = params
        self.nd = solid.ndof
        self.nt = thermo.ndof

    def temps_at_gps(self, T):
        """Nodal temperatures -> {block: (g, E)} at the Gauss points."""
        return {key: ops.interp(N, self.thermo.dofmap.gather(T, key))
                for key, (_, _, N, _) in self.thermo.geometry.items()}

    def heating_at_gps(self, v):
        """The Gough-Joule heating source -T0 (3 lam + 2 mu) alpha
        tr(grad v) at the Gauss points of every thermo-elastic block, from
        the structure's velocity v: {block: (g, E)}."""
        out = {}
        for key, m in self.solid.block_mat.items():
            if getattr(m, "kind", None) != "thermo_solid":
                continue
            lam, mu = m._lame()
            c = (3.0 * lam + 2.0 * mu) * m.thexpans * m.inittemp
            G = self.thermo.geometry[key][0]
            nen, E = G.shape[0], G.shape[-1]
            ve = self.solid.dofmap.gather(v, key).reshape(nen, 3, E)
            div = None  # tr grad v, summed node by node, component by one
            for a in range(nen):
                for i in range(3):
                    term = G[a, i] * ve[a, i]
                    div = term if div is None else div + term
            out[key] = -c * div
        return out

    def split(self, y):
        return y[:self.nd], y[self.nd:]

    def join(self, d, T):
        return torch.cat([d, T])

    @property
    def free_mask(self):
        return self.join(self.solid.free, self.thermo.free)

    def solid_preconditioner(self, u0, dt, mass_shift=0.0):
        """The solid's preconditioner (``params.precond``): SA-AMG from its
        laws' youngs and nue (``gmg`` falls back to it), Jacobi or
        nodal-block Jacobi at u0, or none."""
        sol = self.solid
        M = ps._static_precond(sol, mass_shift)
        if M is not None:
            return M
        if sol.params.precond in ("jacobi", "block_jacobi"):
            return sol.build_preconditioner(u0, mass_shift=mass_shift, dt=dt)
        return lambda r: r

    def block_precond(self, u0, dt, solid_mass_shift=0.0,
                      thermo_dt_factor=0.0):
        """Block-diagonal: the solid's on d, the thermo field's Jacobi on
        T."""
        Ms = self.solid_preconditioner(u0, dt, solid_mass_shift)
        Mt = self.thermo.build_preconditioner(dt_factor=thermo_dt_factor)

        def M(r):
            rs, rt = self.split(r)
            return self.join(Ms(rs), Mt(rt))

        return M
