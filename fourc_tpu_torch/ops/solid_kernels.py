"""CUDA kernels for hex8 element batches and their ctypes binding.

Counterpart of fourc_tpu/ops/solid_pallas.py.  Two kernels, written by hand
in CUDA C++ for Hopper (``fourc_tpu_torch/csrc/solid_kernels.cu``), for
meshes of general topology, where the elements come as a batch:

- ``hex8_force``: total-Lagrangian internal force, Neo-Hooke or SVK,
  optionally plus or (``stiff=False``) only the consistent mass
  ``mcoef * M u``; replaces ``_fwd_kernel``.
- ``hex8_tangent``: the tangent apply K(u) v, optionally plus
  ``mcoef * M v`` in the same pass; replaces ``_jvp_kernel``.

Both take and return element-batch arrays (24, E): row a*3+i is component i
of local node a, one column per element (the TPU kernels' layout, without
their padding of E to a tile multiple).  Gathering u[conn] and assembling
the result are the caller's index operations (core/mesh.py).  A tensor on
the CPU goes to the kernel's plain PyTorch twin in ops/solid.py; a CUDA
tensor launches the kernel on the current stream or raises.  Nothing falls
back.  ``launches`` counts the kernel launches of each wrapper (CPU twin
calls are not counted).

The library is built with ``nvcc`` on first use (ops/cuda_build.py).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fourc_tpu_torch.ops import cuda_build as cb
from fourc_tpu_torch.ops import solid as _ops
from fourc_tpu_torch.ops.cuda_build import MODELS, SUFFIX, check, ptr, run

SOURCE = "solid_kernels.cu"

launches = {"force": 0, "tangent": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


@functools.cache
def _lib():
    P, I, D, L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                  ctypes.c_longlong)
    return cb.load(SOURCE, {
        "fourc_solid_force": [P, P, P, P, P, D, D, I, D, I, L, P],
        "fourc_solid_tangent": [P, P, P, P, P, P, D, D, I, D, L, P],
    })


def _batch(X24: torch.Tensor) -> int:
    if X24.dim() != 2 or X24.shape[0] != 24 or X24.shape[1] < 1:
        raise ValueError(f"expected an element batch (24, E), got "
                         f"{tuple(X24.shape)}")
    if X24.dtype not in SUFFIX:
        raise ValueError(f"element kernels take float32 or float64, got "
                         f"{X24.dtype}")
    check(X24, X24, X24.shape, "X24")
    return int(X24.shape[1])


def hex8_force(X24, u24, lam, mu, model="neohooke", mcoef=0.0, stiff=True):
    """Internal force f = sum_g wdet_g P(F_g) G_g of every element (when
    ``stiff``) plus ``mcoef * sum_g wdet_g N N^T u`` (consistent mass, when
    mcoef != 0).  X24 holds the elements' corner coordinates, u24 their
    displacements."""
    if not X24.is_cuda:
        return _ops.hex8_force_ref(X24, u24, lam, mu, model, mcoef, stiff)
    E = _batch(X24)
    check(u24, X24, X24.shape, "u24")
    out = torch.empty_like(X24)
    run(getattr(_lib(), f"fourc_solid_force_{SUFFIX[X24.dtype]}"),
        ptr(X24), ptr(u24),
        *map(ptr, _ops.cell_tables("hex8", X24.device, X24.dtype)),
        float(lam), float(mu), MODELS[model], float(mcoef), int(bool(stiff)),
        E, ptr(out))
    launches["force"] += 1
    return out


def hex8_tangent(X24, u24, v24, lam, mu, model="neohooke", mcoef=0.0):
    """K(u) v + mcoef * sum_g wdet_g N N^T v of every element."""
    if not X24.is_cuda:
        return _ops.hex8_tangent_ref(X24, u24, v24, lam, mu, model, mcoef)
    E = _batch(X24)
    check(u24, X24, X24.shape, "u24")
    check(v24, X24, X24.shape, "v24")
    out = torch.empty_like(X24)
    run(getattr(_lib(), f"fourc_solid_tangent_{SUFFIX[X24.dtype]}"),
        ptr(X24), ptr(u24), ptr(v24),
        *map(ptr, _ops.cell_tables("hex8", X24.device, X24.dtype)),
        float(lam), float(mu), MODELS[model], float(mcoef), E, ptr(out))
    launches["tangent"] += 1
    return out
