#!/usr/bin/env python3
"""Time the variants of B1 (the uniform lattice's force) and B6 (the
element-batch force) on one CUDA GPU.

Usage, from the repository root on a machine with a CUDA device and nvcc:

    python tools/b1_b6_variants.py [rounds]

Builds ``tools/b1_b6_variants.cu`` (the shipped kernels "shipped", the dense
passes they replaced "old", and the edge kernels at the compiler's register
count "a", at most 168 registers "a_lb3", at most 128 "a_lb" and at most
102 "a_lb5") with nvcc into ``build/tools`` and prints ptxas's registers and
spills of each B1 and B6 kernel. Checks every variant against its twin (``neo_force_ref``,
``hex8_force_ref``) in float64 (max relative error <= 1e-10) and float32
(<= 1e-4) in every mode: B1 on the boxes of tests/port/test_torch_gpu.py
and on chip_smoke.py's uniform box at n = 72, B6 on the element batches of
the GPU tests (E = 1, 130, 1000) and of chip_smoke.py's permuted box at
n = 56. For float32 it prints each variant's error, and the float32 twin's,
against the float64 twin on the same (float32) inputs. Then times each
variant in float32 as a CUDA graph of 50 calls (``rounds`` times, default
2, the variants in turn): B1 at n = 72 in its two modes (whole B1 with the
gather, and its element pass alone), B6 at n = 56 in its four modes, beside
chip_smoke.py's bound and the bound on the dense pass's flop count
(``OLD_FLOPS``).
"""

import ctypes
import functools
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from fourc_tpu_torch.core import cells  # noqa: E402
from fourc_tpu_torch.materials.elastic import lame  # noqa: E402
from fourc_tpu_torch.ops import cuda_build as cb  # noqa: E402
from fourc_tpu_torch.ops import lattice as lat  # noqa: E402
from fourc_tpu_torch.ops import solid as sops  # noqa: E402

sys.path.insert(0, str(ROOT / "tools"))
import b7_b4_variants as b7b4  # noqa: E402

VARIANTS = ["old", "a", "a_lb3", "a_lb", "a_lb5", "shipped"]
# every variant against its twin (tools/b7_b4_variants.py's check)
_check_case = functools.partial(b7b4._check_case, variants=VARIANTS)
N_B1, N_B6 = cs.FULL_N["flagship"], cs.FULL_N["permuted"]
B1_MODES = ("neohooke", "svk")
# mode -> (model, mcoef, stiff) of B6, as chip_smoke.py's cases: B4's
B6_MODES = b7b4.B4_MODES
# Flops per element of the dense first passes, as chip_smoke.py counted
# them before the edge forms.  B1 per Gauss point: grad 144, strain_A 63,
# the stress 139 (Neo-Hooke) or 16 (SVK), F 3, F S 45, the dense
# accumulation 168, and the gather's 24 per element.  B6: B4's dense count
# (tools/b7_b4_variants.py OLD_B4_FLOPS) without the gather.
OLD_FLOPS = {("force", "neohooke"): 4520, ("force", "svk"): 3536,
             ("solid_force", "neohooke"): 6784,
             ("solid_force", "svk"): 5800,
             ("solid_force", "mass-only"): 2120,
             ("solid_force", "neohooke+mass"): 7632}


def build():
    """Compile tools/b1_b6_variants.cu unless the library is newer than its
    sources; print the ptxas registers and spills of each B1 and B6
    kernel."""
    out = ROOT / "build" / "tools" / "libb1_b6_variants.so"
    log = out.with_suffix(".log")
    srcs = [ROOT / "tools" / "b1_b6_variants.cu",
            ROOT / "tools" / "dense_passes.cuh",
            *(cb.CSRC / s for s in (*cb.SOURCES, cb.HEADER))]
    if not (out.exists() and log.exists() and out.stat().st_mtime
            > max(s.stat().st_mtime for s in srcs)):
        out.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [cb.find_nvcc(), *cb.NVCC_FLAGS, "-I", str(cb.CSRC), "-o",
             str(out), str(srcs[0])], capture_output=True, text=True)
        if proc.returncode:
            sys.exit(f"nvcc failed:\n{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    name = spills = None
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and name and re.search(
                r"force_elem|solid_force", name):
            regs = re.search(r"Used (\d+) registers", line).group(1)
            print(f"ptxas {b7b4._label(name)}: {regs} registers, {spills}",
                  flush=True)
    lib = ctypes.CDLL(str(out))
    P, I, D, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, \
        ctypes.c_longlong
    for name in VARIANTS:
        for sfx in cb.SUFFIX.values():
            f = getattr(lib, f"b6v_{name}_{sfx}")
            f.argtypes = [P, P, P, P, P, D, D, I, D, I, L, P, P]
            f.restype = I
            for part in ("full", "elem"):
                f = getattr(lib, f"b1v_{name}_{part}_{sfx}")
                f.argtypes = [P, P, P, D, D, I, P, P, I, I, I, P]
                f.restype = I
    return lib


def _bounds(key, mode, n, tensors):
    """(chip_smoke.py's bound ms, its limit, the dense count's bound ms)."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    old = 1e3 * max(nbytes / cs.PEAK_BYTES,
                    OLD_FLOPS[(key, mode)] * n ** 3 / cs.PEAK_F32_FLOPS)
    return (*cs._bound(key, mode, n, tensors), old)


class B1Case:
    """B1's inputs on the card: the displacement lattice u and the uniform
    box's G and wdet."""

    def __init__(self, shape, h, scale, dtype, seed):
        self.shape = shape
        spec = lat.LatticeSpec(pshape=tuple(s + 1 for s in shape), h=h)
        rng = np.random.default_rng(seed)
        self.u = lat.to_lattice(torch.as_tensor(
            rng.normal(size=spec.ndof) * scale, dtype=dtype,
            device="cuda"), spec)
        G, wdet = lat.uniform_geometry(cells.get_cell("hex8"), spec)
        self.G, self.wdet = (torch.as_tensor(np.asarray(a), dtype=dtype,
                                             device="cuda").contiguous()
                             for a in (G, wdet))
        self.lam, self.mu = lame(1.0e4, 0.3)

    @classmethod
    def flagship(cls, n, dtype):
        """chip_smoke.py's uniform n^3 box, gradients of order 5e-2."""
        return cls((n,) * 3, (1.0 / n,) * 3, 5e-2 / n, dtype, 5)

    @classmethod
    def gpu_test_box(cls, shape, dtype):
        """tests/port/test_torch_gpu.py's box: spacing (0.3, 0.2, 0.4),
        u of 1e-2."""
        return cls(shape, (0.3, 0.2, 0.4), 1e-2, dtype, 3)

    def call(self, lib, name, part, mode):
        out = torch.empty_like(self.u)
        scratch = torch.empty((24, int(np.prod(self.shape))),
                              dtype=self.u.dtype, device="cuda")
        f = getattr(lib, f"b1v_{name}_{part}_{cb.SUFFIX[self.u.dtype]}")
        args = (cb.ptr(self.u), cb.ptr(self.G), cb.ptr(self.wdet),
                float(self.lam), float(self.mu), cb.MODELS[mode],
                cb.ptr(scratch), cb.ptr(out), *self.shape)

        def run():
            cb.run(f, *args)
            return out
        run.scratch = scratch  # alive as long as the call
        return run

    def twin(self, mode, dtype=None):
        u, G, w = self.u, self.G, self.wdet
        if dtype is not None:
            u, G, w = (a.to(dtype) for a in (u, G, w))
        return lat.neo_force_ref(u, G, w, self.lam, self.mu, mode)

    def bounds(self, mode, out):
        return _bounds("force", mode, self.shape[0], (self.u, out))


class B6Case:
    """B6's inputs on the card: element batches X, u (24, E)."""

    def __init__(self, nodal, dtype):
        self.X, self.u = (
            torch.as_tensor(a, dtype=dtype, device="cuda").contiguous()
            for a in nodal)
        self.E = self.X.shape[1]
        self.tab = sops.cell_tables("hex8", self.X.device, dtype)
        self.lam, self.mu = lame(1.0e4, 0.3)

    @classmethod
    def permuted(cls, n, dtype, seed=5):
        """chip_smoke.py's permuted n^3 box."""
        disc = cs.make_mesh(n, "permuted")
        conn = disc.blocks["hex8"].conn
        rng = np.random.default_rng(seed)
        return cls(tuple(a[conn].reshape(-1, 24).T for a in (
            np.asarray(disc.coords),
            rng.normal(size=disc.coords.shape) * 5e-2 / n)), dtype)

    @classmethod
    def batches(cls, E, dtype, seed=10):
        """tests/port/test_torch_gpu.py's batches of jittered boxes."""
        rng = np.random.default_rng(seed)
        base = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                         [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], float)
        Xe = (base[None] * rng.uniform(0.2, 0.5, size=(E, 1, 3))
              + rng.uniform(-0.02, 0.02, size=(E, 8, 3))
              + rng.uniform(0, 3, size=(E, 1, 3)))
        return cls(tuple(a.reshape(E, 24).T for a in (
            Xe, rng.normal(size=(E, 8, 3)) * 5e-3)), dtype)

    def call(self, lib, name, mode):
        model, mcoef, stiff = B6_MODES[mode]
        out = torch.empty_like(self.X)
        f = getattr(lib, f"b6v_{name}_{cb.SUFFIX[self.X.dtype]}")
        args = (cb.ptr(self.X), cb.ptr(self.u), *map(cb.ptr, self.tab),
                float(self.lam), float(self.mu), cb.MODELS[model],
                float(mcoef), int(stiff), self.E, cb.ptr(out))

        def run():
            cb.run(f, *args)
            return out
        return run

    def twin(self, mode, dtype=None):
        model, mcoef, stiff = B6_MODES[mode]
        X, u = (a if dtype is None else a.to(dtype) for a in (self.X, self.u))
        return sops.hex8_force_ref(X, u, self.lam, self.mu, model, mcoef,
                                   stiff)

    def bounds(self, mode, out):
        n = round(self.E ** (1 / 3))
        return _bounds("solid_force", mode, n, (self.X, self.u, out))


def check(lib):
    for dtype, tol in ((torch.float64, cs.F64_TOL),
                       (torch.float32, cs.F32_TOL)):
        for shape in ((4, 3, 5), (9, 7, 12)):
            c = B1Case.gpu_test_box(shape, dtype)
            _check_case("B1", f"{shape}", c, B1_MODES,
                        lambda name, mode, c=c: c.call(lib, name, "full",
                                                       mode), dtype, tol)
        c = B1Case.flagship(N_B1, dtype)
        _check_case("B1", f"flagship n={N_B1}", c, B1_MODES,
                    lambda name, mode, c=c: c.call(lib, name, "full", mode),
                    dtype, tol)
        for E in (1, 130, 1000):
            c = B6Case.batches(E, dtype)
            _check_case("B6", f"E={E}", c, B6_MODES,
                        lambda name, mode, c=c: c.call(lib, name, mode),
                        dtype, tol)
        c = B6Case.permuted(N_B6, dtype)
        _check_case("B6", f"permuted n={N_B6}", c, B6_MODES,
                    lambda name, mode, c=c: c.call(lib, name, mode),
                    dtype, tol)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    lib = build()
    check(lib)
    b1 = B1Case.flagship(N_B1, torch.float32)
    b6 = B6Case.permuted(N_B6, torch.float32)
    for rnd in range(1, rounds + 1):
        for mode in B1_MODES:
            for name in VARIANTS:
                run = b1.call(lib, name, "full", mode)
                full = cs._time_graph(run, reps=50)
                bound, by, old = b1.bounds(mode, run())
                elem = "" if name == "shipped" else (
                    "element pass " + format(1e3 * cs._time_graph(
                        b1.call(lib, name, "elem", mode), reps=50), "7.2f")
                    + " us, ")
                print(f"round {rnd} B1 n={N_B1} {mode:13s} {name:7s} "
                      f"{1e3 * full:7.2f} us, {elem}bound {1e3 * bound:.3f} "
                      f"us ({by}), share {bound / full:.1%}; dense count's "
                      f"bound {1e3 * old:.3f} us, share {old / full:.1%}",
                      flush=True)
        for mode in B6_MODES:
            for name in VARIANTS:
                run = b6.call(lib, name, mode)
                ms = cs._time_graph(run, reps=50)
                bound, by, old = b6.bounds(mode, run())
                print(f"round {rnd} B6 n={N_B6} {mode:13s} {name:7s} "
                      f"{1e3 * ms:7.2f} us, bound {1e3 * bound:.3f} us "
                      f"({by}), share {bound / ms:.1%}; dense count's bound "
                      f"{1e3 * old:.3f} us", flush=True)


if __name__ == "__main__":
    main()
