"""Element geometry helpers and leading-index 3x3 algebra.

Counterpart of the subset of fourc_tpu/ops/common.py that the lattice slice
uses.  The isoparametric helpers run once at setup on the host in float64
(numpy).  The ``*3l`` helpers act on torch tensors whose two LEADING axes
are the 3x3 matrix axes, broadcasting over the rest.
"""

from __future__ import annotations

import numpy as np
import torch

# -- host geometry (numpy, float64) -----------------------------------------


def iso_gradients(Xe, dN):
    """Xe (E, nen, 3) reference coords, dN (ngp, nen, 3) parametric grads.
    Returns G (E, ngp, nen, 3) cartesian grads and detJ (E, ngp)."""
    J = np.einsum("eai,gaj->egij", Xe, dN)  # J[e,g,i,j] = dx_i / dxi_j
    detJ = np.linalg.det(J)
    G = np.einsum("gaj,egji->egai", dN, np.linalg.inv(J))
    return G, detJ


def interp_field(ue, N):
    """(E, nen, c), (ngp, nen) -> (E, ngp, c)."""
    return np.einsum("eac,ga->egc", ue, N)


def weighted(detJ, weights):
    """detJ (E, ngp) times the Gauss weights (ngp,)."""
    return detJ * np.asarray(weights)[None, :]


def surface_measure(Xf, dNf):
    """Area jacobian and unit normal of 3D faces at Gauss points.
    Xf (F, nen_f, 3), dNf (ngp, nen_f, 2) -> (F, ngp), (F, ngp, 3)."""
    t = np.einsum("eai,gap->egip", Xf, dNf)
    n = np.cross(t[..., 0], t[..., 1])
    dA = np.linalg.norm(n, axis=-1)
    return dA, n / (dA[..., None] + 1e-300)


# -- leading-index 3x3 algebra (torch) --------------------------------------


def tr3l(a):
    """(3, 3, ...) -> (...)."""
    return a[0, 0] + a[1, 1] + a[2, 2]


def det3l(a):
    return (a[0, 0] * (a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1])
            - a[0, 1] * (a[1, 0] * a[2, 2] - a[1, 2] * a[2, 0])
            + a[0, 2] * (a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]))


def cof3l(a):
    """Cofactor matrix (adj^T) of a (3, 3, ...) tensor."""
    rows = [
        [a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1],
         a[1, 2] * a[2, 0] - a[1, 0] * a[2, 2],
         a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]],
        [a[0, 2] * a[2, 1] - a[0, 1] * a[2, 2],
         a[0, 0] * a[2, 2] - a[0, 2] * a[2, 0],
         a[0, 1] * a[2, 0] - a[0, 0] * a[2, 1]],
        [a[0, 1] * a[1, 2] - a[0, 2] * a[1, 1],
         a[0, 2] * a[1, 0] - a[0, 0] * a[1, 2],
         a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]],
    ]
    return torch.stack([torch.stack(r) for r in rows])


def inv3l(a, det=None):
    """Inverse via the adjugate: (3, 3, ...) -> (3, 3, ...)."""
    if det is None:
        det = det3l(a)
    return cof3l(a).transpose(0, 1) / det


def eye3l(like):
    """eye(3) broadcast against a (3, 3, ...) tensor."""
    return torch.eye(3, dtype=like.dtype, device=like.device).reshape(
        (3, 3) + (1,) * (like.dim() - 2))


def matmul3l(a, b):
    """(3, 3, ...) @ (3, 3, ...) over the leading axes, as three broadcast
    products: elementwise kernels (an einsum takes cuBLAS's batched GEMM,
    one 3x3 product per batch entry), summed in the einsum's order."""
    return a[:, 0:1] * b[0:1] + a[:, 1:2] * b[1:2] + a[:, 2:3] * b[2:3]


def tmatmul3l(a, b):
    """a^T b over the leading axes of two (3, 3, ...) tensors."""
    return a[0][:, None] * b[0][None] + a[1][:, None] * b[1][None] \
        + a[2][:, None] * b[2][None]


def sqrt_rn(x):
    """The correctly rounded square root of x > 0, the same bits on every
    device: torch.sqrt's value (a card's may lie one ulp off the CPU's)
    moved by at most one ulp to the neighbour that brackets sqrt(x), decided
    with exact products (Veltkamp's split, x - s^2 without cancellation).
    Its forward derivative, t / (2 s) at the corrected s, is the same bits
    on every device too; its second derivative is torch.sqrt's."""
    s0 = torch.sqrt(x)
    s, xd = s0.detach(), x.detach()
    p = s * s
    c = s * 134217729.0  # 2^27 + 1
    hi = c - (c - s)
    lo = s - hi
    r = (xd - p) - (((hi * hi - p) + 2.0 * hi * lo) + lo * lo)  # x - s^2
    up = torch.nextafter(s, torch.full_like(s, float("inf")))
    dn = torch.nextafter(s, torch.zeros_like(s))
    hu, hd = 0.5 * (up - s), 0.5 * (s - dn)  # half ulps above and below
    sc = torch.where(r > 2.0 * s * hu + hu * hu, up,
                     torch.where(r < hd * hd - 2.0 * s * hd, dn, s))
    # value sc; derivative t / (y + sc) = t / (2 sc), as y's value is sc;
    # second derivative -y' / (2 sc^2), torch.sqrt's
    y = s0 + (sc - s)
    return sc + (x - xd) / (y + sc)
