"""LES closures of the fluid: the dynamic Smagorinsky coefficient
(Germano-Lilly) and the multifractal subgrid-scale inputs.

Counterpart of fourc_tpu/ops/turbulence.py (``_element_averages``,
``_patch_filter``, ``dynamic_cs2``, ``mfs_fields``).  The test filter is
the reference's box filter: a volume-weighted average over the patch of
elements that share a node, taken back to the element as the mean over its
nodes.

  L_ij = hat(u_i u_j) - hat(u_i) hat(u_j)
  M_ij = 2 Delta^2 [hat(|S| S_ij) - 4 |hat(S)| hat(S)_ij]
  Cs^2 = <L_ij M_ij> / <M_ij M_ij>   (clipped to [0, cs2_max])

The caller's field treats these outputs as Picard inputs, frozen in the
Newton linearization; they are computed here from detached velocities.
Element batches have the element index last (ops/fluid.py); the patch sums
go through the dof map's slot-order assembly and the global sums through
``tree_sum``, so every device rounds alike.  AVM3, the reference's
algebraic multiscale closure, is not ported.
"""

from __future__ import annotations

import torch

from fourc_tpu_torch.core.mesh import DofMap
from fourc_tpu_torch.linalg.solvers import tree_sum
from fourc_tpu_torch.ops import common as gm
from fourc_tpu_torch.ops.fluid import (_double_dot, _sum0, element_volume,
                                       interp_vec)
from fourc_tpu_torch.ops.solid import _grad

_LN2 = 0.6931471805599453
_LOG2E = 1.4426950408889634


def _sqrt0(x):
    """sqrt_rn of x >= 0, 0 at 0."""
    pos = x > 0
    return torch.where(pos, gm.sqrt_rn(torch.where(pos, x, 1.0)), 0.0)


def _element_averages(G, wdet, N, ue):
    """Element means of u, u (x) u, S and |S| S, and the element volume:
    (d, E), (d, d, E), (d, d, E), (d, d, E), (E,)."""
    ue = ue.detach()
    V = element_volume(wdet)
    u = interp_vec(N, ue)  # (d, g, E)
    gradu = _grad(ue, G)
    S = 0.5 * (gradu + gradu.transpose(0, 1))
    snorm = gm.sqrt_rn(2.0 * _double_dot(S, S) + 1e-30)

    def avg(f):  # (..., g, E) -> (..., E)
        return _sum0((wdet * f).movedim(-2, 0)) / V

    return (avg(u), avg(u[:, None] * u[None]), avg(S), avg(snorm * S), V)


class PatchFilter:
    """The node patches of one element block: sums of element values over
    the elements at a node, and means of nodal values over an element's
    nodes."""

    def __init__(self, ba, n_nodes):
        self.ba, self.n_nodes = ba, n_nodes

    def node_sums(self, f_e):
        """sum over the elements at each node of f_e (..., E) ->
        (n_nodes, ...)."""
        extra, E = f_e.shape[:-1], f_e.shape[-1]
        k = f_e[..., 0].numel()
        nen = self.ba.conn.shape[1]
        dm = DofMap(ndpn=k, ndof=self.n_nodes * k, blocks={"b": self.ba})
        rep = f_e.reshape(1, k, E).expand(nen, k, E).reshape(nen * k, E)
        return dm.scatter_add({"b": rep}).reshape((self.n_nodes,) + extra)

    def element_means(self, f_n):
        """The mean over each element's nodes of f_n (n_nodes, ...) ->
        (..., E)."""
        extra = f_n.shape[1:]
        k = f_n[0].numel()
        nen = self.ba.conn.shape[1]
        dm = DofMap(ndpn=k, ndof=self.n_nodes * k, blocks={"b": self.ba})
        fe = dm.gather(f_n.reshape(-1), "b").reshape(nen, k, -1)
        return (_sum0(fe) * (1.0 / nen)).reshape(extra + (-1,))

    def filter(self, f_e, V):
        """Element values -> volume-weighted node-patch averages -> back
        to the elements."""
        num = self.node_sums(V * f_e)
        den = self.node_sums(V)
        return self.element_means(
            num / den.reshape((-1,) + (1,) * (num.dim() - 1)))


def dynamic_cs2(G, wdet, N, ue, patches: PatchFilter, cs2_max=0.09):
    """The dynamic Cs^2 of a block, averaged over it (the reference's
    ``averaging="global"``): (E,), every entry the same."""
    d = G.shape[1]
    u_e, uu_e, S_e, SS_e, V = _element_averages(G, wdet, N, ue)
    delta2 = gm.pow_ieee(V, 2.0 / d)
    hat_u = patches.filter(u_e, V)
    hat_uu = patches.filter(uu_e, V)
    hat_S = patches.filter(S_e, V)
    hat_SS = patches.filter(SS_e, V)
    L = hat_uu - hat_u[:, None] * hat_u[None]
    hat_snorm = gm.sqrt_rn(2.0 * _double_dot(hat_S, hat_S) + 1e-30)
    M = 2.0 * delta2 * (hat_SS - 4.0 * hat_snorm * hat_S)
    LM = _double_dot(L, M)
    MM = _double_dot(M, M)
    cs2 = tree_sum(V * LM) / torch.clamp(tree_sum(V * MM), min=1e-30)
    return torch.clamp(cs2, 0.0, cs2_max).expand(V.shape)


def mfs_fields(G, wdet, N, ue, patches: PatchFilter, nu, csgs=0.25,
               n_max=12.0):
    """Multifractal subgrid-scale inputs of a block: B (E,) and the
    node-patch filtered velocity at the nodes (n_nodes, d).  With
    Re_h = |u_e| V^(1/d) / nu, N = log2(Re_h^(3/4)) clipped to
    [0, n_max] and B = csgs sqrt(2/3) sqrt(2^(4N/3) - 1); the subgrid
    velocity is B (u - hat u)."""
    d = G.shape[1]
    u_e, _, _, _, V = _element_averages(G, wdet, N, ue)
    h = gm.pow_ieee(V, 1.0 / d)
    re_h = (_sqrt0(_sum0(u_e * u_e)) * h) * (1.0 / nu)
    Nc = torch.clamp(0.75 * gm.log_ieee(torch.clamp(re_h, min=1.0))
                     * _LOG2E, 0.0, n_max)
    B = (csgs * (2.0 / 3.0) ** 0.5) * _sqrt0(
        gm.exp_ieee((4.0 / 3.0 * _LN2) * Nc) - 1.0)
    num = patches.node_sums(V * u_e)  # (n_nodes, d)
    den = patches.node_sums(V)
    return B, num / torch.clamp(den, min=1e-300)[:, None]
