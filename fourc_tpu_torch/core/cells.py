"""Cell tables for the lattice slice: hex8 volumes and quad4 faces.

Counterpart of fourc_tpu/core/cells.py, restricted to the two cell types the
flagship problem uses.  Tables are built once on the host in float64 with the
same Gauss rules and the same Richardson-extrapolated derivative formula as
the reference, so both packages see bit-identical N, dN and weights.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

_HEX_CORNERS = np.array(
    [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
     [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], dtype=np.float64)
_QUAD_CORNERS = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]],
                         dtype=np.float64)

_HEX_SURFACES = ((0, 3, 2, 1), (0, 1, 5, 4), (1, 2, 6, 5), (2, 3, 7, 6),
                 (3, 0, 4, 7), (4, 5, 6, 7))
_QUAD_EDGES = ((0, 1), (1, 2), (2, 3), (3, 0))


def _n_quad4(xi):
    r, s = xi
    c = _QUAD_CORNERS
    return 0.25 * (1 + c[:, 0] * r) * (1 + c[:, 1] * s)


def _n_hex8(xi):
    r, s, t = xi
    c = _HEX_CORNERS
    return 0.125 * (1 + c[:, 0] * r) * (1 + c[:, 1] * s) * (1 + c[:, 2] * t)


def _tensor_rule(n, dim):
    """Tensor Gauss-Legendre rule, first axis fastest (reference order)."""
    p, w = np.polynomial.legendre.leggauss(n)
    if dim == 2:
        P = np.array([[a, b] for b in p for a in p])
        W = np.array([wa * wb for wb in w for wa in w])
        return P, W
    P = np.array([[a, b, c] for c in p for b in p for a in p])
    W = np.array([wa * wb * wc for wc in w for wb in w for wa in w])
    return P, W


def _num_jac(fn, x, eps):
    cols = []
    for d in range(x.shape[0]):
        dx = np.zeros_like(x)
        dx[d] = eps
        cols.append((fn(x + dx) - fn(x - dx)) / (2 * eps))
    return np.stack(cols, axis=-1)


def _poly_jac(fn, x):
    """Richardson-extrapolated central differences (exact for these
    polynomials up to roundoff; same formula as the reference)."""
    h = 1e-3
    x = np.asarray(x, dtype=np.float64)
    return (4 * _num_jac(fn, x, h / 2) - _num_jac(fn, x, h)) / 3


@dataclass(frozen=True)
class CellType:
    name: str
    dim: int
    nen: int
    gauss_points: np.ndarray  # (ngp, dim)
    gauss_weights: np.ndarray  # (ngp,)
    N: np.ndarray  # (ngp, nen)
    dN: np.ndarray  # (ngp, nen, dim) parametric gradients
    surfaces: tuple = ()
    edges: tuple = ()

    @property
    def ngp(self) -> int:
        return self.gauss_points.shape[0]


def _make(name, dim, fn, rule, surfaces=(), edges=()):
    pts, wts = rule
    N = np.stack([fn(p) for p in pts])
    dN = np.stack([_poly_jac(fn, p) for p in pts])
    return CellType(name=name, dim=dim, nen=N.shape[1], gauss_points=pts,
                    gauss_weights=wts, N=N, dN=dN, surfaces=surfaces,
                    edges=edges)


@functools.cache
def get_cell(name: str) -> CellType:
    name = name.lower()
    if name == "hex8":
        return _make("hex8", 3, _n_hex8, _tensor_rule(2, 3),
                     surfaces=_HEX_SURFACES)
    if name == "quad4":
        return _make("quad4", 2, _n_quad4, _tensor_rule(2, 2),
                     edges=_QUAD_EDGES)
    raise KeyError(f"cell type {name!r} is not ported (hex8, quad4 are)")
