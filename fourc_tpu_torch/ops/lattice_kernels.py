"""CUDA kernels for the uniform hex8 lattice and their ctypes binding.

Counterpart of fourc_tpu/ops/lattice_pallas.py.  Three kernels, written by
hand in CUDA C++ for Hopper (``fourc_tpu_torch/csrc/lattice_kernels.cu``):

- ``stencil_matvec``: y = A v for one uniform (8, 3, 8, 3) node-block stencil
  (GMG level operators, consistent mass); replaces ``_stencil_kernel``.
- ``neo_force``: total-Lagrangian internal force, Neo-Hooke or SVK;
  replaces ``_force_kernel``.
- ``neo_tangent``: the tangent apply K(u) v, optionally plus the consistent
  mass ``mcoef * M v`` in the same pass; replaces ``_jvp_kernel``.

Each wrapper takes and returns the padded lattice layout of ops/lattice.py.
A tensor on the CPU goes to the kernel's plain PyTorch twin in
ops/lattice.py; a CUDA tensor launches the kernel on the current stream or
raises.  Nothing falls back.  ``launches`` counts the kernel launches of
each wrapper (CPU twin calls are not counted).

The library is built with ``nvcc`` on first use into ``build/fourc_tpu_torch``
under the repository root (one shared object with a plain C interface; no
PyTorch headers, so the build takes seconds).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from fourc_tpu_torch.ops import lattice as _lat

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("lattice_kernels.cu", "lattice_common.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fourc_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_MODELS = {"neohooke": 0, "svk": 1}

launches = {"stencil": 0, "force": 0, "tangent": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(cuda_home) / "bin" / "nvcc"
        nvcc = str(cand) if cand.exists() else None
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or "
                           "/usr/local/cuda/bin): cannot build the lattice "
                           "kernels")
    return nvcc


def library_path() -> Path:
    """Build output path, keyed by a hash of the sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"liblattice_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the kernels (if this source version is not built yet) and
    return the shared object's path.  The compiler's register and spill
    report goes to ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / "lattice_kernels.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def _lib():
    lib = ctypes.CDLL(str(build()))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for t in ("f32", "f64"):
        f = getattr(lib, f"fourc_stencil_{t}")
        f.argtypes = [P, P, P, I, I, I, P]
        f.restype = I
        f = getattr(lib, f"fourc_force_{t}")
        f.argtypes = [P, P, P, D, D, I, P, P, I, I, I, P]
        f.restype = I
        f = getattr(lib, f"fourc_tangent_{t}")
        f.argtypes = [P, P, P, P, P, D, D, I, D, P, P, I, I, I, P]
        f.restype = I
    return lib


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(x: torch.Tensor, like: torch.Tensor, shape, name):
    if x.device != like.device or x.dtype != like.dtype:
        raise ValueError(f"{name}: expected {like.dtype} on {like.device}, "
                         f"got {x.dtype} on {x.device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _dims(x: torch.Tensor):
    if x.dim() != 4 or x.shape[0] != 3 or min(x.shape[1:]) < 4:
        raise ValueError(f"expected a padded lattice (3, X, Y, Z) with "
                         f"X, Y, Z >= 4, got {tuple(x.shape)}")
    if x.dtype not in _SUFFIX:
        raise ValueError(f"lattice kernels take float32 or float64, "
                         f"got {x.dtype}")
    return tuple(int(s) - 3 for s in x.shape[1:])


def _run(fn, *args):
    err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"lattice kernel launch failed: CUDA error {err}")


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


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
