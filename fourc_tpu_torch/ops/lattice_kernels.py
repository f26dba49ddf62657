"""CUDA kernels for the hex8 lattice and their ctypes binding.

Counterpart of fourc_tpu/ops/lattice_pallas.py.  Five kernels, written by
hand in CUDA C++ for Hopper (``fourc_tpu_torch/csrc/lattice_kernels.cu``):

- ``stencil_matvec``: y = A v for one uniform (8, 3, 8, 3) node-block stencil
  (GMG level operators, consistent mass); replaces ``_stencil_kernel``.
- ``neo_force``: total-Lagrangian internal force, Neo-Hooke or SVK;
  replaces ``_force_kernel``.
- ``neo_tangent``: the tangent apply K(u) v, optionally plus the consistent
  mass ``mcoef * M v`` in the same pass; replaces ``_jvp_kernel``.
- ``neo_force_gen``: ``neo_force`` on general geometry (Jacobians from a
  coordinate lattice), optionally plus or (``stiff=False``) only the
  consistent mass; replaces ``_force_kernel_gen``.
- ``neo_tangent_gen``: ``neo_tangent`` on general geometry; ``u=None`` is
  the linear operator at u = 0 (exact-geometry GMG levels); replaces
  ``_jvp_kernel_gen``.

Each wrapper takes and returns the padded lattice layout of ops/lattice.py.
A tensor on the CPU goes to the kernel's plain PyTorch twin in
ops/lattice.py; a CUDA tensor launches the kernel on the current stream or
raises.  Nothing falls back.  ``launches`` counts the kernel launches of
each wrapper (CPU twin calls are not counted).

The library is built with ``nvcc`` on first use (ops/cuda_build.py).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fourc_tpu_torch.ops import cuda_build as cb
from fourc_tpu_torch.ops import lattice as _lat
from fourc_tpu_torch.ops.cuda_build import MODELS as _MODELS
from fourc_tpu_torch.ops.cuda_build import SUFFIX as _SUFFIX
from fourc_tpu_torch.ops.cuda_build import check as _check
from fourc_tpu_torch.ops.cuda_build import ptr as _ptr
from fourc_tpu_torch.ops.cuda_build import run as _run

SOURCE = "lattice_kernels.cu"

launches = {"stencil": 0, "force": 0, "tangent": 0, "force_gen": 0,
            "tangent_gen": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


@functools.cache
def _lib():
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    return cb.load(SOURCE, {
        "fourc_stencil": [P, P, P, I, I, I],
        "fourc_force": [P, P, P, D, D, I, P, P, I, I, I],
        "fourc_tangent": [P, P, P, P, P, D, D, I, D, P, P, I, I, I],
        "fourc_force_gen": [P, P, P, P, P, D, D, I, D, I, P, P, I, I, I],
        "fourc_tangent_gen": [P, P, P, P, P, P, D, D, I, D, P, P, I, I, I],
    })


def _dims(x: torch.Tensor):
    if x.dim() != 4 or x.shape[0] != 3 or min(x.shape[1:]) < 4:
        raise ValueError(f"expected a padded lattice (3, X, Y, Z) with "
                         f"X, Y, Z >= 4, got {tuple(x.shape)}")
    if x.dtype not in _SUFFIX:
        raise ValueError(f"lattice kernels take float32 or float64, "
                         f"got {x.dtype}")
    return tuple(int(s) - 3 for s in x.shape[1:])


def stencil_matvec(K: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y = A v, A the uniform node-block stencil K (8, 3, 8, 3)."""
    if not v.is_cuda:
        return _lat.stencil_matvec_ref(K, v)
    nx, ny, nz = _dims(v)
    _check(v, v, v.shape, "v")
    _check(K, v, (8, 3, 8, 3), "K")
    out = torch.empty_like(v)
    _run(getattr(_lib(), f"fourc_stencil_{_SUFFIX[v.dtype]}"),
         _ptr(K), _ptr(v), _ptr(out), nx, ny, nz)
    launches["stencil"] += 1
    return out


def neo_force(u, G, wdet, lam, mu, model="neohooke"):
    """Internal force f = sum_g wdet_g P(F_g) G_g.  G (8, 8, 3) and wdet
    (8,) are tensors on u's device in u's dtype."""
    if not u.is_cuda:
        return _lat.neo_force_ref(u, G, wdet, lam, mu, model)
    nx, ny, nz = _dims(u)
    _check(u, u, u.shape, "u")
    _check(G, u, (8, 8, 3), "G")
    _check(wdet, u, (8,), "wdet")
    scratch = torch.empty((24, nx * ny * nz), dtype=u.dtype, device=u.device)
    out = torch.empty_like(u)
    _run(getattr(_lib(), f"fourc_force_{_SUFFIX[u.dtype]}"),
         _ptr(u), _ptr(G), _ptr(wdet), float(lam), float(mu), _MODELS[model],
         _ptr(scratch), _ptr(out), nx, ny, nz)
    launches["force"] += 1
    return out


def neo_tangent(u, v, G, wdet, N, lam, mu, model="neohooke", mcoef=0.0):
    """K(u) v + mcoef * sum_g wdet_g N N^T v.  N (8, 8) is the hex8 shape
    function table at the Gauss points."""
    if not u.is_cuda:
        return _lat.neo_jvp_ref(u, v, G, wdet, lam, mu, model, N=N,
                                mcoef=mcoef)
    nx, ny, nz = _dims(u)
    _check(u, u, u.shape, "u")
    _check(v, u, u.shape, "v")
    _check(G, u, (8, 8, 3), "G")
    _check(wdet, u, (8,), "wdet")
    _check(N, u, (8, 8), "N")
    scratch = torch.empty((24, nx * ny * nz), dtype=u.dtype, device=u.device)
    out = torch.empty_like(u)
    _run(getattr(_lib(), f"fourc_tangent_{_SUFFIX[u.dtype]}"),
         _ptr(u), _ptr(v), _ptr(G), _ptr(wdet), _ptr(N), float(lam),
         float(mu), _MODELS[model], float(mcoef), _ptr(scratch), _ptr(out),
         nx, ny, nz)
    launches["tangent"] += 1
    return out


def _check_tables(like, dN, w, N):
    _check(dN, like, (8, 8, 3), "dN")
    _check(w, like, (8,), "w")
    _check(N, like, (8, 8), "N")


def neo_force_gen(x, u, dN, w, N, lam, mu, model="neohooke", mcoef=0.0,
                  stiff=True):
    """General-geometry internal force (``stiff``) plus
    ``mcoef * sum_g wdet_g N N^T u`` (consistent mass, when mcoef != 0).
    x is the coordinate lattice; dN (8, 8, 3), w (8,) and N (8, 8) the hex8
    reference gradients, Gauss weights and shape functions, on u's device
    in u's dtype."""
    if not u.is_cuda:
        return _lat.neo_force_gen_ref(x, u, dN, w, N, lam, mu, model, mcoef,
                                      stiff)
    nx, ny, nz = _dims(u)
    _check(u, u, u.shape, "u")
    _check(x, u, u.shape, "x")
    _check_tables(u, dN, w, N)
    scratch = torch.empty((24, nx * ny * nz), dtype=u.dtype, device=u.device)
    out = torch.empty_like(u)
    _run(getattr(_lib(), f"fourc_force_gen_{_SUFFIX[u.dtype]}"),
         _ptr(x), _ptr(u), _ptr(dN), _ptr(w), _ptr(N), float(lam), float(mu),
         _MODELS[model], float(mcoef), int(bool(stiff)), _ptr(scratch),
         _ptr(out), nx, ny, nz)
    launches["force_gen"] += 1
    return out


def neo_tangent_gen(x, u, v, dN, w, N, lam, mu, model="neohooke", mcoef=0.0):
    """General-geometry K(u) v + mcoef * sum_g wdet_g N N^T v; ``u=None``
    means u = 0 (linear elasticity, u is not read)."""
    if not v.is_cuda:
        return _lat.neo_jvp_gen_ref(x, u, v, dN, w, N, lam, mu, model, mcoef)
    nx, ny, nz = _dims(v)
    _check(v, v, v.shape, "v")
    _check(x, v, v.shape, "x")
    if u is not None:
        _check(u, v, v.shape, "u")
    _check_tables(v, dN, w, N)
    scratch = torch.empty((24, nx * ny * nz), dtype=v.dtype, device=v.device)
    out = torch.empty_like(v)
    _run(getattr(_lib(), f"fourc_tangent_gen_{_SUFFIX[v.dtype]}"),
         _ptr(x), None if u is None else _ptr(u), _ptr(v), _ptr(dN), _ptr(w),
         _ptr(N), float(lam), float(mu), _MODELS[model], float(mcoef),
         _ptr(scratch), _ptr(out), nx, ny, nz)
    launches["tangent_gen"] += 1
    return out
