"""Geometric multigrid preconditioner on a hex8 lattice.

Counterpart of fourc_tpu/linalg/gmg.py for lattice levels.  Levels halve the
element count per axis while every axis is even; a coarse level's nodes are
every second fine node, coordinates included.  Each level's operator is the
small-strain linear-elastic rediscretisation plus the lumped-mass shift of
the dynamic Newton operator:

- on a uniform level, collapsed to one (8, 3, 8, 3) stencil applied by the
  B3 kernel, with lambda_max from a 12-step power iteration checked against
  the Gershgorin bound;
- on a general-geometry level (box topology, e.g. a jittered box), the exact
  operator with every element's own Jacobians: the B5 kernel in its linear
  mode (u = 0) on the level's coordinate lattice.  The Jacobi diagonal and
  the Gershgorin row sums are assembled from the per-element stiffness
  (ops/solid.py, chunked, float64 on the level's device), and lambda_max is
  the Gershgorin bound times 1.02, with no power iteration, as in the
  reference's wide path.

Smoother: Chebyshev on the Jacobi-scaled operator.  Cycle: V(1,1),
Chebyshev on the coarsest level.  All vectors stay in the padded lattice
layout; transfers are axis-wise linear interpolation and its transpose.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from fourc_tpu_torch.core import cells as _cells
from fourc_tpu_torch.core.device import resolve_device
from fourc_tpu_torch.core.mesh import HEX8_OFFSETS
from fourc_tpu_torch.materials.small_strain import LinearElastic
from fourc_tpu_torch.ops import lattice as _lat
from fourc_tpu_torch.ops import lattice_kernels as lk
from fourc_tpu_torch.ops import solid as sops

POWER_ITERS = 12  # power-iteration steps for lambda_max
CHEBY_DEGREE = 3  # smoother degree on every level but the coarsest
COARSEST_DEGREE = 6  # Chebyshev degree of the coarsest-level solve
COARSEST = 8  # stop coarsening at this many elements (or odd/<=2 axes)


def _ax(nd, axis, sl):
    return tuple(sl if i == axis else slice(None) for i in range(nd))


def _interp_axis(c, axis):
    """Linear interpolation along one axis: coarse m+1 -> fine 2m+1 points."""
    nd, m1 = c.dim(), c.shape[axis]
    shape = list(c.shape)
    shape[axis] = 2 * (m1 - 1) + 1
    f = c.new_zeros(shape)
    f[_ax(nd, axis, slice(0, None, 2))] = c
    f[_ax(nd, axis, slice(1, None, 2))] = 0.5 * (
        c.narrow(axis, 0, m1 - 1) + c.narrow(axis, 1, m1 - 1))
    return f


def _restrict_axis(f, axis):
    """Transpose of _interp_axis: fine 2m+1 -> coarse m+1 points."""
    nd = f.dim()
    odd = 0.5 * f[_ax(nd, axis, slice(1, None, 2))]
    c = f[_ax(nd, axis, slice(0, None, 2))].clone()
    c[_ax(nd, axis, slice(0, -1))] += odd
    c[_ax(nd, axis, slice(1, None))] += odd
    return c


def _crop(x):
    return x[:, 1:-1, 1:-1, 1:-1]


def _pad(x):
    return F.pad(x, (1, 1, 1, 1, 1, 1))


def _to_lattice_np(x, device, dtype):
    """(px, py, pz, 3) numpy -> padded lattice tensor."""
    t = torch.as_tensor(np.ascontiguousarray(np.moveaxis(x, -1, 0)),
                        dtype=torch.float64)
    return _pad(t).to(device=device, dtype=dtype).contiguous()


class _Level:
    """One lattice level: operator (uniform stencil or exact general
    geometry), Jacobi diagonal, Chebyshev bounds."""

    def __init__(self, shape, lattice_coords, lattice_mask, cell, lam, mu,
                 rho, mass_shift, device, dtype):
        pshape = tuple(s + 1 for s in shape)
        h = lattice_coords[1, 1, 1] - lattice_coords[0, 0, 0]
        ii = np.stack(np.meshgrid(*[np.arange(p) for p in pshape],
                                  indexing="ij"), axis=-1)
        want = lattice_coords[0, 0, 0] + ii * h
        tol = 64 * np.finfo(np.float64).eps * max(
            1.0, float(np.abs(lattice_coords).max()))
        self.uniform = bool(np.allclose(lattice_coords, want, rtol=0.0,
                                        atol=tol))
        self.lam, self.mu = lam, mu
        self.free = _to_lattice_np(np.asarray(lattice_mask, np.float64),
                                   device, torch.float64) > 0
        self.K = self.x = None
        if self.uniform:
            diag, rowabs, mlump = self._setup_uniform(
                shape, lattice_coords, cell, lam, mu, device, dtype)
        else:
            diag, rowabs, mlump = self._setup_general(
                shape, lattice_coords, cell, lam, mu, device, dtype)
        mass_coeff = float(rho * mass_shift)
        self.mshift = None  # lumped-mass shift of the dynamic operator
        if mass_coeff:
            diag = diag + mass_coeff * mlump
            rowabs = rowabs + mass_coeff * mlump
            self.mshift = _to_lattice_np(mass_coeff * mlump, device, dtype)
        free = np.asarray(lattice_mask, bool)
        dsafe = np.maximum(diag, 1e-30)
        self.dinv = _to_lattice_np(np.where(free, 1.0 / dsafe, 1.0), device,
                                   dtype)
        self.gersh_lmax = float(np.max(np.where(free, rowabs / dsafe, 0.0)))

    def _setup_uniform(self, shape, lattice_coords, cell, lam, mu, device,
                       dtype):
        """Stencil of the congruent element; diagonal, row sums and lumped
        mass (rho = 1) as (px, py, pz, 3) numpy lattices."""
        E_mod = mu * (3 * lam + 2 * mu) / (lam + mu)
        nue = lam / (2 * (lam + mu))
        mat = LinearElastic(youngs=float(E_mod), nue=float(nue))
        Xe1 = np.stack([lattice_coords[o] for o in HEX8_OFFSETS])[None]
        Ke = sops.element_stiffness(Xe1, cell, mat)[0]  # (24, 24)
        self.K = torch.as_tensor(_lat.collapse_stencil(Ke), dtype=dtype,
                                 device=device).contiguous()
        diag = _lat.assemble_uniform(np.diagonal(Ke).reshape(8, 3), shape)
        rowabs = _lat.assemble_uniform(np.abs(Ke).sum(axis=1).reshape(8, 3),
                                       shape)
        ml = sops.lumped_mass(Xe1, cell, 1.0)[0]  # (8,)
        mlump = _lat.assemble_uniform(np.repeat(ml[:, None], 3, axis=1),
                                      shape)
        return diag, rowabs, mlump

    def _setup_general(self, shape, lattice_coords, cell, lam, mu, device,
                       dtype):
        """Coordinate lattice and hex8 tables for the B5 operator; exact
        diagonal, row sums and lumped mass (rho = 1) from every element's
        geometry, as (px, py, pz, 3) numpy lattices."""
        pshape = tuple(s + 1 for s in shape)
        X = torch.as_tensor(lattice_coords, dtype=torch.float64,
                            device=device)
        self.x = _lat.coord_lattice(lattice_coords.reshape(-1, 3),
                                    _lat.LatticeSpec(pshape, None), dtype,
                                    device)
        self.tables = tuple(
            torch.as_tensor(np.asarray(t), dtype=dtype, device=device)
            for t in (cell.dN, cell.gauss_weights, cell.N))
        Xe = _lat.element_corners(X, shape)
        E = Xe.shape[0]
        dK, rK = sops.element_stiffness_rows(Xe, cell, lam, mu)
        diag, rowabs = (_lat.assemble_elements(t.reshape(E, 8, 3), shape)
                        for t in (dK, rK))
        mlump = sops.lattice_lumped_mass(X, shape, cell, 1.0)
        return tuple(t.cpu().numpy() for t in (diag, rowabs, mlump))

    def matvec(self, v):
        """Level operator; constrained and ghost entries pass through."""
        vm = torch.where(self.free, v, 0.0)
        if self.uniform:
            out = lk.stencil_matvec(self.K, vm)
        else:
            out = lk.neo_tangent_gen(self.x, None, vm, *self.tables, self.lam,
                                     self.mu, "svk")
        if self.mshift is not None:
            out = out + self.mshift * vm
        return torch.where(self.free, out, v)

    def setup_chebyshev(self, degree, generator):
        """Chebyshev degree and [lmax/30, lmax] for D^-1 A.  Uniform level:
        lmax from a power iteration (times 1.05), replaced by the Gershgorin
        bound when the estimate is unusable.  General level: the Gershgorin
        bound times 1.02."""
        self.degree = degree
        ub = 1.02 * self.gersh_lmax
        if not self.uniform:
            self.lmax, self.lmin = ub, ub / 30.0
            return
        x = torch.randn(self.free.shape, generator=generator,
                        dtype=torch.float64).to(self.dinv)
        x = torch.where(self.free, x, 0.0)
        lm = torch.ones((), dtype=x.dtype, device=x.device)
        for _ in range(POWER_ITERS):
            y = torch.where(self.free, self.dinv * self.matvec(x), 0.0)
            ny = torch.linalg.vector_norm(y)
            lm = ny / torch.clamp(torch.linalg.vector_norm(x), min=1e-30)
            x = y / torch.clamp(ny, min=1e-30)
        lm = float(lm) * 1.05
        if not math.isfinite(lm) or not (0.0 < lm <= ub):
            lm = ub
        self.lmax = lm
        self.lmin = lm / 30.0

    def chebyshev0(self, b, return_res=False):
        """Chebyshev(degree) on D^-1 A from x = 0.  With ``return_res`` also
        the true residual b - A x, reusing the smoother's own matvecs."""
        theta = 0.5 * (self.lmax + self.lmin)
        delta = 0.5 * (self.lmax - self.lmin)
        sigma = theta / delta
        rho_old = 1.0 / sigma
        r = self.dinv * b
        d = r / theta
        x = d
        rt = b
        for _ in range(self.degree - 1):
            t = self.matvec(d)
            if return_res:
                rt = rt - t
            rho = 1.0 / (2.0 * sigma - rho_old)
            r = r - self.dinv * t
            d = rho * rho_old * d + (2.0 * rho / delta) * r
            x = x + d
            rho_old = rho
        if return_res:
            return x, rt - self.matvec(d)
        return x


class StructuredGMG:
    """V(1,1) preconditioner r -> z on the padded lattice layout; constrained
    entries pass through unchanged."""

    def __init__(self, disc, ndpn, free_mask, lam, mu, rho=0.0,
                 mass_shift=0.0, device="cuda", dtype=torch.float64):
        device = resolve_device(device)
        spec = _lat.general_lattice(disc.dofmap(ndpn))
        if spec is None or ndpn != 3:
            raise NotImplementedError("GMG needs a one-block hex8 lattice")
        shape = tuple(p - 1 for p in spec.pshape)
        pshape = tuple(s + 1 for s in shape)
        coords = np.asarray(disc.coords).reshape(pshape + (3,))
        mask = np.asarray(free_mask).reshape(pshape + (ndpn,))
        cell = _cells.get_cell("hex8")
        self.levels = []
        while True:
            self.levels.append(_Level(shape, coords, mask, cell, lam, mu, rho,
                                      mass_shift, device, dtype))
            if (any(s % 2 for s in shape) or min(shape) <= 2
                    or int(np.prod(shape)) <= COARSEST):
                break
            shape = tuple(s // 2 for s in shape)
            coords = coords[::2, ::2, ::2]
            # a coarse dof is free only if the matching fine dof is
            mask = mask[::2, ::2, ::2]
        # power-iteration start vectors (uniform levels): one seeded
        # generator, levels in order
        gen = torch.Generator().manual_seed(0)
        for lv in self.levels[:-1]:
            lv.setup_chebyshev(CHEBY_DEGREE, gen)
        self.levels[-1].setup_chebyshev(COARSEST_DEGREE, gen)

    def _interp(self, z_c, lv_f):
        z = _crop(z_c)
        for ax in (1, 2, 3):
            z = _interp_axis(z, ax)
        return torch.where(lv_f.free, _pad(z), 0.0)

    def _restrict(self, r_f, lv_c):
        r = _crop(r_f)
        for ax in (1, 2, 3):
            r = _restrict_axis(r, ax)
        return torch.where(lv_c.free, _pad(r), 0.0)

    def v_cycle(self, r, k=0):
        lv = self.levels[k]
        r = torch.where(lv.free, r, 0.0)
        if k == len(self.levels) - 1:
            return lv.chebyshev0(r)
        z, res = lv.chebyshev0(r, return_res=True)
        z_c = self.v_cycle(self._restrict(res, self.levels[k + 1]), k + 1)
        z = z + self._interp(z_c, lv)
        z = z + lv.chebyshev0(r - lv.matvec(z))
        return z

    def __call__(self, r):
        return torch.where(self.levels[0].free, self.v_cycle(r), r)


def build_for_solid(field, mass_shift=0.0):
    """GMG for a SolidField on a hex8 lattice, on the field's device and in
    its dtype."""
    return StructuredGMG(field.disc, field.ndpn, field.dbc.free_mask,
                         field.lam, field.mu, rho=field.density,
                         mass_shift=mass_shift, device=field.device,
                         dtype=field.dtype)
