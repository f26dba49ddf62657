"""Global structural constraints: the enclosed volume, by penalty.

Counterpart of ``VolumeConstraint`` of fourc_tpu/physics/constraints.py in
its penalty mode: the volume enclosed by a set of faces is computed by the
divergence theorem, V(u) = (1/3) sum over the faces of the integral of
x . n dA on the deformed faces, and the constraint force
k (V(u) - V0 f(t)) dV/du enters the residual as a negative external force
(the reference's ``external_force``).  dV/du and the Hessian H_V come
from torch's AD of V (``torch.func.grad``, and ``jacfwd`` of it over the
faces' dofs, once per linearization point), as the reference takes
``jax.grad``.  Lagrange enforcement and the multipoint
kinds are not ported (physics/structure_driver.py refuses them).
"""

from __future__ import annotations

import numpy as np
import torch

from fourc_tpu_torch.core.cells import get_cell


class VolumeConstraint:
    """k (V(u) - V0 f(t)) dV/du over outward-oriented faces (FaceBlocks);
    V0 the volume of the undeformed faces, f the FUNCT ``funct_id`` (1
    without one).  u is a flat dof vector of the field's dtype and
    device."""

    def __init__(self, faces, coords, ndpn, penalty, funct_id, functions,
                 device="cpu", dtype=torch.float64):
        self.ndpn = ndpn
        self.k = float(penalty)
        self.fn = functions.get(int(funct_id)) if funct_id else None
        self.coords = torch.as_tensor(np.asarray(coords), dtype=dtype,
                                      device=device)
        self._faces = []
        nodes = np.unique(np.concatenate([np.asarray(fb.conn).reshape(-1)
                                          for fb in faces]))
        self.dofs = torch.as_tensor(
            (nodes[:, None] * ndpn + np.arange(ndpn)).reshape(-1),
            device=device)  # the dofs V depends on
        for fb in faces:
            fc = get_cell(fb.cell)
            conn = torch.as_tensor(np.asarray(fb.conn), device=device)
            self._faces.append(tuple(
                torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
                for a in (fc.dN, fc.N, fc.gauss_weights)) + (conn.long(),))
        self.V0 = float(self.volume(self.coords.new_zeros(
            self.coords.numel())))

    def volume(self, u):
        """V = (1/3) oint x . n dA (the divergence theorem)."""
        x = self.coords + u.reshape(-1, self.ndpn)
        V = x.new_zeros(())
        for dN, N, w, conn in self._faces:
            Xf = x[conn]  # (F, nen_f, 3)
            t = torch.einsum("eai,gap->egip", Xf, dN)
            n = torch.linalg.cross(t[..., 0], t[..., 1])
            dA = torch.linalg.vector_norm(n, dim=-1)
            nrm = n / (dA[..., None] + 1e-300)
            xg = torch.einsum("eac,ga->egc", Xf, N)
            V = V + torch.einsum("g,eg,egd,egd->", w, dA, xg, nrm) / 3.0
        return V

    def error(self, u, t):
        scale = (float(np.asarray(self.fn(np.zeros((1, 3)), t,
                                          component=0)).reshape(-1)[0])
                 if self.fn is not None else 1.0)
        return self.volume(u) - self.V0 * scale

    def force(self, u, t):
        """The penalty force (k e) dV/du."""
        return (self.k * self.error(u, t)) * torch.func.grad(self.volume)(u)

    def linearize(self, u, t):
        """v -> the force's derivative along v at u,
        k ((dV/du . v) dV/du + e H_V v), with dV/du, e and the dense Hessian
        of V over the faces' dofs formed once here: a direct solve probes it
        once per dof."""
        g = torch.func.grad(self.volume)(u)
        e = self.error(u, t)
        dofs = self.dofs

        def face_volume(x):
            return self.volume(u.index_put((dofs,), x))

        H = torch.func.jacfwd(torch.func.grad(face_volume))(u[dofs])

        def apply(v):
            Hv = torch.zeros_like(v).index_put((dofs,), H @ v[dofs])
            return self.k * ((g * v).sum() * g + e * Hv)

        return apply
