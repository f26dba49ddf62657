"""Element geometry helpers and leading-index 2x2 and 3x3 algebra.

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
    """Xe (E, nen, d) reference coords, dN (ngp, nen, d) parametric grads
    (d = 2 or 3).  Returns G (E, ngp, nen, d) cartesian grads and detJ
    (E, ngp)."""
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
    """Area (3D faces) or length (2D edges) jacobian and unit normal at
    Gauss points.  Xf (F, nen_f, d), dNf (ngp, nen_f, d-1) -> (F, ngp),
    (F, ngp, d); a 2D edge of tangent t has the normal (t_y, -t_x)."""
    t = np.einsum("eai,gap->egip", Xf, dNf)
    if Xf.shape[-1] == 3:
        n = np.cross(t[..., 0], t[..., 1])
    else:
        n = np.stack([t[..., 1, 0], -t[..., 0, 0]], axis=-1)
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


def det2l(a):
    """(2, 2, ...) -> (...)."""
    return a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]


def inv2l(a, det=None):
    """Inverse of a (2, 2, ...) tensor via the adjugate."""
    if det is None:
        det = det2l(a)
    return torch.stack([torch.stack([a[1, 1], -a[0, 1]]),
                        torch.stack([-a[1, 0], a[0, 0]])]) / det


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


# -- transcendental functions from + and * alone ----------------------------
#
# torch.exp, cosh, sinh, log and pow are not correctly rounded, and the CPU's
# and a card's differ in the last bit; the history laws' Newton loops carry
# such a bit into the answer (tools/device_rounding.py).  These are built
# from IEEE-rounded additions, products and divisions of tensors (and exact
# scalings by powers of two), so that they give the same bits on every
# device, within a few ulps of the true value; their forward derivatives
# come from the same operations.  Arguments of float64 or float32.

_LOG2E = 1.4426950408889634
# ln 2 = hi + lo with hi's low bits zero, so that n * hi is exact
_LN2 = {torch.float64: (6.93147180369123816490e-01, 1.90821492927058770002e-10),
        torch.float32: (0.693145751953125, 1.428606765330187e-06)}
# (exponent bias, mantissa bits, integer type, least and largest argument
# of exp with a normal result)
_FLOAT = {torch.float64: (1023, 52, torch.int64, -708.0, 709.0),
          torch.float32: (127, 23, torch.int32, -87.0, 88.0)}
# Taylor terms: exp's on |r| <= ln(2)/2, sinh's and log's series
_TERMS = {torch.float64: (13, 8, 11), torch.float32: (7, 5, 6)}


def _two_pow(n):
    """2^n for integer-valued n of a float tensor, built from its bits."""
    bias, bits, itype, _, _ = _FLOAT[n.dtype]
    return ((n.to(itype) + bias) << bits).view(n.dtype)


def exp_ieee(x):
    """exp(x), the same bits on every device: x = n ln 2 + r (Cody-Waite),
    exp(r) by its Taylor polynomial, times 2^n; 0 below float's normal
    range, inf above it."""
    hi, lo = _LN2[x.dtype]
    _, _, _, xmin, xmax = _FLOAT[x.dtype]
    n = torch.round(torch.clamp(x.detach(), xmin, xmax) * _LOG2E)
    r = (x - n * hi) - n * lo
    deg = _TERMS[x.dtype][0]
    coef = [1.0]
    for k in range(1, deg + 1):
        coef.append(coef[-1] / k)
    p = r * coef[deg] + coef[deg - 1]
    for k in range(deg - 2, -1, -1):
        p = p * r + coef[k]
    out = p * _two_pow(n)
    return torch.where(x < xmin, 0.0, torch.where(x > xmax, float("inf"),
                                                  out))


def cosh_sinh_ieee(x):
    """(cosh x, sinh x) from ``exp_ieee`` of x and -x (1 / exp(x) would
    overflow its float32 derivative at |x| = 50); sinh by its Taylor series
    where |x| < 1 (the difference of exponentials cancels there)."""
    e = exp_ieee(x)
    ei = exp_ieee(-x)
    z = x * x
    terms = _TERMS[x.dtype][1]
    coef = [1.0]
    for k in range(1, terms + 1):
        coef.append(coef[-1] / ((2 * k) * (2 * k + 1)))
    p = z * coef[terms] + coef[terms - 1]
    for k in range(terms - 2, -1, -1):
        p = p * z + coef[k]
    small = (x > -1.0) & (x < 1.0)
    return 0.5 * (e + ei), torch.where(small, x * p, 0.5 * (e - ei))


def log_ieee(x):
    """log(x) of positive normal x, the same bits on every device:
    x = 2^k m with m in [sqrt(1/2), sqrt(2)), log m = 2 atanh(s),
    s = (m - 1) / (m + 1), by its series."""
    bias, bits, itype, _, _ = _FLOAT[x.dtype]
    hi, lo = _LN2[x.dtype]
    xd = x.detach()
    k = ((xd.view(itype) >> bits) & (2 * bias + 1)) - bias
    k = k.to(x.dtype)
    m = x * _two_pow(-k)
    up = m > 1.4142135623730951
    m = torch.where(up, 0.5 * m, m)
    k = torch.where(up, k + 1.0, k)
    s = (m - 1.0) / (m + 1.0)
    z = s * s
    terms = _TERMS[x.dtype][2]
    p = z * (1.0 / (2 * terms + 1)) + 1.0 / (2 * terms - 1)
    for j in range(terms - 2, -1, -1):
        p = p * z + 1.0 / (2 * j + 1)
    return k * hi + (k * lo + 2.0 * s * p)


def pow_ieee(x, y):
    """x ** y for a number y, the same bits on every device: products by
    repeated squaring for an integer y (x of any sign; 1 for y = 0),
    exp(y log x) otherwise for x >= 0 (0 at x = 0, its forward derivative
    there 0, as ``jnp.power``'s for y > 1)."""
    y = float(y)
    if y == int(y) and abs(y) <= 64:
        k, out, base = abs(int(y)), None, x
        while k:
            if k & 1:
                out = base if out is None else out * base
            k >>= 1
            if k:
                base = base * base
        if out is None:
            return torch.ones_like(x)
        return out if y > 0 else 1.0 / out
    pos = x > 0
    return torch.where(pos, exp_ieee(y * log_ieee(torch.where(pos, x, 1.0))),
                       0.0)
