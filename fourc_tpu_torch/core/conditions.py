"""Boundary conditions: Dirichlet and Neumann containers, Dirichlet handler.

Counterpart of fourc_tpu/core/conditions.py.  The free/fixed split is a bool
mask over the flat dof vector; prescribed values are evaluated on the host
at each time (numpy) and moved to the device where they are applied.
``DirichletHandler.rates`` gives their exact time derivative, by forward
mode in t through the FUNCTs' torch evaluation on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fourc_tpu_torch.core.functions import FunctionManager


@dataclass
class DirichletBC:
    nodes: np.ndarray
    onoff: list  # per dof component: 1 = constrained
    val: list
    funct: list | None = None  # function id per component (None/0 = 1)

    def __post_init__(self):
        self.nodes = np.asarray(self.nodes, dtype=np.int32)
        if self.funct is None:
            self.funct = [0] * len(self.onoff)


@dataclass
class NeumannBC:
    """Surface traction: per-component VAL * FUNCT on a list of FaceBlocks.
    Only the fixed-direction ``traction`` kind is ported."""

    faces: object
    onoff: list
    val: list
    funct: list | None = None
    kind: str = "traction"

    def __post_init__(self):
        if self.funct is None:
            self.funct = [0] * len(self.onoff)


@dataclass
class BodyForce:
    """Volume load: per component VAL * FUNCT at the Gauss points, scaled
    by the block's density (1 where the density is 0)."""

    val: list
    funct: list | None = None

    def __post_init__(self):
        if self.funct is None:
            self.funct = [0] * len(self.val)


class DirichletHandler:
    """A list of DirichletBCs as (free_mask, u_D(t)).  Later conditions
    override earlier ones on shared nodes."""

    def __init__(self, conds, coords: np.ndarray, ndpn: int,
                 functions: FunctionManager):
        n_nodes = coords.shape[0]
        self.ndpn = ndpn
        fixed = np.zeros((n_nodes, ndpn), dtype=bool)
        amp = np.zeros((n_nodes, ndpn))
        fid = np.zeros((n_nodes, ndpn), dtype=np.int64)
        for c in conds:
            for k in range(min(ndpn, len(c.onoff))):
                if c.onoff[k]:
                    fixed[c.nodes, k] = True
                    amp[c.nodes, k] = c.val[k]
                    fid[c.nodes, k] = c.funct[k] or 0
        self.free_mask = ~fixed.reshape(-1)  # (ndof,) bool, numpy
        self._functions = functions
        self._groups = []
        for f in np.unique(fid[fixed]):
            nodes, comps = np.nonzero(fixed & (fid == f))
            self._groups.append((int(f), nodes * ndpn + comps, coords[nodes],
                                 amp[nodes, comps], comps))

    @property
    def free_w(self):
        """float64 0/1 weight of free_mask (for converters and tests)."""
        return self.free_mask.astype(np.float64)

    def values(self, t) -> np.ndarray:
        """Prescribed-value vector u_D(t), zero on free dofs (host, f64)."""
        out = np.zeros(self.free_mask.shape[0])
        for f, dofs, xyz, amp, comps in self._groups:
            fn = self._functions.get(f)
            if len(fn.components) == 1:
                vals = amp * fn(xyz, t, component=0)
            else:
                vals = amp * np.take_along_axis(fn(xyz, t), comps[:, None],
                                                axis=1)[:, 0]
            out[dofs] = vals
        return out

    def _free_on(self, x: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self.free_mask, device=x.device)

    def apply(self, u: torch.Tensor, t) -> torch.Tensor:
        """Overwrite constrained dofs of a flat dof vector with u_D(t)."""
        vals = torch.as_tensor(self.values(t), dtype=u.dtype, device=u.device)
        return torch.where(self._free_on(u), u, vals)

    def mask(self, r: torch.Tensor) -> torch.Tensor:
        """Zero constrained entries of a flat dof vector."""
        return torch.where(self._free_on(r), r, 0.0)

    def rates(self, t, like: torch.Tensor) -> torch.Tensor:
        """The exact time derivative d/dt u_D(t) of the prescribed values,
        zero on free dofs, as a tensor of ``like``'s dtype and device: each
        FUNCT (the piece of a multifunction that holds at t) evaluated by
        torch at its nodes and differentiated in t by ``torch.func.jvp``,
        as the reference takes ``jax.jvp`` in t (the rate vector that
        4C's scatra and thermo steps fill on Dirichlet rows)."""
        out = torch.zeros(self.free_mask.shape[0], dtype=like.dtype,
                          device=like.device)
        t0 = torch.tensor(float(t), dtype=like.dtype, device=like.device)
        for f, dofs, xyz, amp, comps in self._groups:
            fn = self._functions.get(f).at_time(t)
            x = torch.as_tensor(xyz, dtype=like.dtype, device=like.device)
            comp = np.minimum(comps, len(fn.components) - 1)
            rate = torch.empty(len(dofs), dtype=like.dtype,
                               device=like.device)
            for c in np.unique(comp):
                sel = np.nonzero(comp == c)[0]
                _, dv = torch.func.jvp(
                    lambda tt: fn.on_device(x[sel], tt, component=int(c)),
                    (t0,), (torch.ones_like(t0),))
                rate[torch.as_tensor(sel, device=like.device)] = dv
            amp_t = torch.as_tensor(amp, dtype=like.dtype, device=like.device)
            out[torch.as_tensor(dofs, device=like.device)] = amp_t * rate
        return out

    def apply_rates(self, udot: torch.Tensor, t) -> torch.Tensor:
        """Overwrite constrained dofs of a rate vector with d/dt u_D(t)."""
        return torch.where(self._free_on(udot), udot, self.rates(t, udot))
