"""Build and ctypes plumbing shared by the CUDA kernel wrappers.

Each source of ``fourc_tpu_torch/csrc`` becomes one shared object with a
plain C interface (no PyTorch headers, so a build takes seconds), compiled
with ``nvcc`` for sm_90a on first use into ``build/fourc_tpu_torch`` under
the repository root and named by a hash of the source, the shared header and
the flags.  ``build_all`` starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
HEADER = "lattice_common.cuh"
SOURCES = ("lattice_kernels.cu", "solid_kernels.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fourc_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MODELS = {"neohooke": 0, "svk": 1}
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(cuda_home) / "bin" / "nvcc"
        nvcc = str(cand) if cand.exists() else None
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or "
                           "/usr/local/cuda/bin): cannot build the CUDA "
                           "kernels")
    return nvcc


def library_path(source: str) -> Path:
    """Build output path, keyed by a hash of the sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source, HEADER):
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}_{h.hexdigest()[:12]}.so"


def _start(source: str):
    """Start nvcc on one source: (process, temporary output, final path)."""
    out = library_path(source)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, out


def _finish(proc, tmp, out) -> Path:
    stdout, stderr = proc.communicate()
    out.with_suffix(".log").write_text(stdout + stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{stderr}")
    os.replace(tmp, out)
    return out


def build(source: str) -> Path:
    """Compile one source (if this version is not built yet) and return the
    shared object's path.  The compiler's register and spill report goes to
    ``<library>.log``."""
    out = library_path(source)
    if out.exists():
        return out
    return _finish(*_start(source))


def build_all() -> dict:
    """Compile every source that is not built yet, all at once; returns
    {source: shared object path}."""
    jobs = {s: _start(s) for s in SOURCES if not library_path(s).exists()}
    done = {s: _finish(*job) for s, job in jobs.items()}
    return {s: done.get(s, library_path(s)) for s in SOURCES}


def load(source: str, signatures: dict):
    """The built library of ``source`` with argtypes set: ``signatures``
    maps a function stem to its argument types, without the trailing stream;
    every function exists as ``<stem>_f32`` and ``<stem>_f64`` and returns
    the CUDA error code of its launch."""
    lib = ctypes.CDLL(str(build(source)))
    for stem, argtypes in signatures.items():
        for t in SUFFIX.values():
            f = getattr(lib, f"{stem}_{t}")
            f.argtypes = [*argtypes, ctypes.c_void_p]
            f.restype = ctypes.c_int
    return lib


def check(x: torch.Tensor, like: torch.Tensor, shape, name):
    if x.device != like.device or x.dtype != like.dtype:
        raise ValueError(f"{name}: expected {like.dtype} on {like.device}, "
                         f"got {x.dtype} on {x.device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def run(fn, *args):
    """Launch on the current stream; raise on a refused launch."""
    err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"kernel launch failed: CUDA error {err}")


def ptr(x):
    return ctypes.c_void_p(x.data_ptr())
