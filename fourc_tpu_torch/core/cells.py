"""Cell tables: hex8, tet4 and wedge6 volumes with quad4 faces, quad4 2D
volumes with line2 edges.

Counterpart of fourc_tpu/core/cells.py, restricted to the cell types the
ported problems use.  Tables are built once on the host in float64 with the
same shape functions, the same Gauss rules and the same
Richardson-extrapolated derivative formula as the reference, so both
packages see bit-identical N, dN and weights.
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
_TET_SURFACES = ((0, 2, 1), (0, 1, 3), (1, 2, 3), (0, 3, 2))
_WEDGE_SURFACES = ((0, 1, 4, 3), (1, 2, 5, 4), (2, 0, 3, 5), (0, 2, 1),
                   (3, 4, 5))
_QUAD_EDGES = ((0, 1), (1, 2), (2, 3), (3, 0))


def _n_line2(xi):
    r = xi[0]
    return np.array([0.5 * (1 - r), 0.5 * (1 + r)])


def _n_quad4(xi):
    r, s = xi
    c = _QUAD_CORNERS
    return 0.25 * (1 + c[:, 0] * r) * (1 + c[:, 1] * s)


def _n_hex8(xi):
    r, s, t = xi
    c = _HEX_CORNERS
    return 0.125 * (1 + c[:, 0] * r) * (1 + c[:, 1] * s) * (1 + c[:, 2] * t)


def _n_tet4(xi):
    r, s, t = xi
    return np.array([1 - r - s - t, r, s, t])


def _n_wedge6(xi):
    r, s, t = xi
    tri = np.array([1 - r - s, r, s])
    return np.concatenate([tri * 0.5 * (1 - t), tri * 0.5 * (1 + t)])


def _tensor_rule(n, dim):
    """Tensor Gauss-Legendre rule, first axis fastest (reference order)."""
    p, w = np.polynomial.legendre.leggauss(n)
    if dim == 1:
        return p[:, None], w
    if dim == 2:
        P = np.array([[a, b] for b in p for a in p])
        W = np.array([wa * wb for wb in w for wa in w])
        return P, W
    P = np.array([[a, b, c] for c in p for b in p for a in p])
    W = np.array([wa * wb * wc for wc in w for wb in w for wa in w])
    return P, W


_TRI3_RULE = (np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]]),
              np.array([1 / 6, 1 / 6, 1 / 6]))
_A_TET4 = 0.58541019662496845446  # (5+3*sqrt(5))/20
_B_TET4 = 0.13819660112501051518  # (5-sqrt(5))/20
_TET4_RULE = (np.array([[_B_TET4, _B_TET4, _B_TET4],
                        [_A_TET4, _B_TET4, _B_TET4],
                        [_B_TET4, _A_TET4, _B_TET4],
                        [_B_TET4, _B_TET4, _A_TET4]]),
              np.array([1 / 24] * 4))


def _wedge_rule(nline):
    """The 3-point triangle rule times an nline-point Gauss-Legendre rule,
    the triangle's points fastest (reference order)."""
    tp, tw = _TRI3_RULE
    lp, lw = np.polynomial.legendre.leggauss(nline)
    P = np.array([[a[0], a[1], b] for b in lp for a in tp])
    W = np.array([wa * wb for wb in lw for wa in tw])
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
    if name == "tet4":
        return _make("tet4", 3, _n_tet4, _TET4_RULE, surfaces=_TET_SURFACES)
    if name == "wedge6":
        return _make("wedge6", 3, _n_wedge6, _wedge_rule(2),
                     surfaces=_WEDGE_SURFACES)
    if name == "quad4":
        return _make("quad4", 2, _n_quad4, _tensor_rule(2, 2),
                     edges=_QUAD_EDGES)
    if name == "line2":
        return _make("line2", 1, _n_line2, _tensor_rule(2, 1))
    raise KeyError(f"cell type {name!r} is not ported ({', '.join(CELLS)} "
                   f"are)")


_SHAPE_FNS = {"hex8": _n_hex8, "tet4": _n_tet4, "wedge6": _n_wedge6,
              "quad4": _n_quad4, "line2": _n_line2}


@functools.cache
def origin_dN(name: str) -> np.ndarray:
    """Parametric gradients (nen, dim) at xi = 0, the element centre that
    F-bar and EAS read, by the reference's formula there: one central
    difference of step 1e-7 (``eval_shape_deriv``), exact to about 1e-9,
    not the Richardson-extrapolated tables."""
    cell = get_cell(name)
    return _num_jac(_SHAPE_FNS[cell.name], np.zeros(cell.dim), 1e-7)


CELLS = ("hex8", "tet4", "wedge6", "quad4", "line2")  # the ported cell types
SOLID_CELLS = ("hex8", "tet4", "wedge6")  # the ported 3D volume cells
VOLUME_CELLS = {3: SOLID_CELLS, 2: ("quad4",)}  # by mesh dimension
FACE_TYPE = {"hex8": "quad4", "quad4": "line2"}  # a volume cell's faces
