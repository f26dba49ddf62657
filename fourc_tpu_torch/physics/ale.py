"""ALE mesh-motion field.

Counterpart of fourc_tpu/physics/ale.py: given prescribed displacements of
the moving interface nodes (and zero on the other fixed nodes), the mesh
displacement of the interior solves

- ``laplace``: one scalar Laplace problem per coordinate (2D and 3D),
  matrix-free CG with the Laplacian's Jacobi diagonal;
- ``elastic``: linear pseudo-elasticity (E = 1, nu = 0, small strain,
  through the solid's element route, ``ops.solid.element_force`` with
  ``kinem`` linear) with every element's stiffness scaled by V_mean / V_e,
  so that small elements resist distortion hardest; CG with the Laplacian's
  diagonal repeated per component.  3D only: a 2D structure field is not
  ported, and ``elastic`` on a 2D mesh is refused by name.

The geometry is computed once on the host in float64 and moved to the
field's device in its dtype.  The operators sum in a fixed order (the dof
map's slot order, ops/scalar.py's term-by-term sums).
"""

from __future__ import annotations

import numpy as np
import torch

from fourc_tpu_torch.core.cells import get_cell
from fourc_tpu_torch.core.device import resolve_device
from fourc_tpu_torch.core.mesh import Discretization
from fourc_tpu_torch.linalg import solvers
from fourc_tpu_torch.linalg.precond import jacobi
from fourc_tpu_torch.materials.elastic import StVenantKirchhoff
from fourc_tpu_torch.ops import scalar as sops
from fourc_tpu_torch.ops.solid import element_force
from fourc_tpu_torch.physics.fluid import _host_geometry

METHODS = ("laplace", "elastic")


class AleField:
    """Harmonic or pseudo-elastic mesh motion on ``device`` in ``dtype``.

    boundary_nodes: node ids held fixed (zero displacement) unless they are
    interface nodes; interface_nodes: ids receiving prescribed values."""

    def __init__(self, disc: Discretization, interface_nodes, boundary_nodes,
                 method: str = "laplace", device="cuda", dtype=torch.float64):
        if method not in METHODS:
            raise NotImplementedError(f"ALE method {method!r} is not ported "
                                      f"({', '.join(METHODS)} are)")
        if method == "elastic" and disc.dim != 3:
            raise NotImplementedError(
                f"ALE method 'elastic' on a {disc.dim}D mesh is not ported "
                f"(it needs the 2D structure field)")
        self.disc = disc
        self.dim = disc.dim
        self.method = method
        self.device = resolve_device(device)
        self.dtype = dtype
        self.dofmap = disc.dofmap(1, lattice=False)
        n = disc.n_nodes
        fixed = np.zeros(n, dtype=bool)
        fixed[np.asarray(boundary_nodes, np.int64)] = True
        fixed[np.asarray(interface_nodes, np.int64)] = True
        self.free = torch.as_tensor(~fixed, device=self.device)
        self.interface = torch.as_tensor(
            np.asarray(interface_nodes, np.int64), device=self.device)
        self.geometry, stiffen = {}, {}
        for key, blk in disc.blocks.items():
            G, wdet = _host_geometry(disc.coords[blk.conn],
                                     get_cell(blk.cell))
            self.geometry[key] = (self._to(G), self._to(wdet))
            V = wdet.sum(dim=0)
            stiffen[key] = self._to(V.mean() / V)
        diag = self.dofmap.scatter_add({
            key: sops.diffusion_diagonal(G, wdet)
            for key, (G, wdet) in self.geometry.items()})
        # the Laplacian's Jacobi diagonal, 1 on the fixed nodes
        self.diag = torch.where(self.free, torch.clamp(diag, min=1e-30), 1.0)
        self.last_iters = 0  # CG iterations of the last solve
        if method == "elastic":
            self._stiffen = stiffen
            self._vdofmap = disc.dofmap(self.dim, lattice=False)
            self._mat = StVenantKirchhoff(youngs=1.0, nue=0.0)

    def _to(self, a):
        return torch.as_tensor(a).to(self.device, self.dtype)

    def _laplace(self, phi):
        """K_lap phi of a nodal scalar field."""
        dm = self.dofmap
        return dm.scatter_add({
            key: sops._test_gradient(
                G, wdet * sops.nodal_gradient(G, dm.gather(phi, key)))
            for key, (G, wdet) in self.geometry.items()})

    def _elastic_force(self, u):
        """The stiffened linear-elastic mesh force of nodal displacements
        u (n * d,)."""
        dm = self._vdofmap
        return dm.scatter_add({
            key: element_force(G, wdet, dm.gather(u, key), self._mat,
                               kinem="linear") * self._stiffen[key]
            for key, (G, wdet) in self.geometry.items()})

    def solve(self, interface_disp, tol=1e-8, maxiter=400):
        """interface_disp (n_interface, d) -> the mesh displacement
        (n_nodes, d); ``last_iters`` counts the CG iterations."""
        n, d = self.disc.n_nodes, self.dim
        if self.method == "elastic":
            bc = torch.zeros((n, d), dtype=self.dtype, device=self.device)
            bc[self.interface] = interface_disp
            bc = bc.reshape(-1)
            freev = self.free.repeat_interleave(d)

            def A(v):
                f = self._elastic_force(torch.where(freev, v, 0.0))
                return torch.where(freev, f, v)

            rhs = torch.where(freev, -self._elastic_force(bc), 0.0)
            res = solvers.cg(A, rhs, M=jacobi(self.diag.repeat_interleave(d)),
                             tol=tol, maxiter=maxiter)
            self.last_iters = res.iters
            return torch.where(freev, res.x, bc).reshape(n, d)
        out, self.last_iters = [], 0
        M = jacobi(self.diag)

        def A(v):
            return torch.where(self.free,
                               self._laplace(torch.where(self.free, v, 0.0)),
                               v)

        for c in range(d):
            bc = torch.zeros(n, dtype=self.dtype, device=self.device)
            bc[self.interface] = interface_disp[:, c]
            rhs = torch.where(self.free, -self._laplace(bc), 0.0)
            res = solvers.cg(A, rhs, M=M, tol=tol, maxiter=maxiter)
            self.last_iters += res.iters
            out.append(torch.where(self.free, res.x, bc))
        return torch.stack(out, dim=-1)
