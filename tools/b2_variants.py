#!/usr/bin/env python3
"""Time the variants of the B2 tangent kernel on one CUDA GPU.

Usage, from the repository root on a machine with a CUDA device and nvcc:

    python tools/b2_variants.py [rounds]

Builds ``tools/b2_variants.cu`` (the shipped element pass "a_lb4", which
holds the edge differences at most 128 registers, the element pass it
replaced "old", "a" at the compiler's register count, and "b" and "b_lb4"
that hold the corners instead of the edge differences) with nvcc into
``build/tools`` and prints ptxas's registers and spills of each.  Checks
every variant (element pass and gather) against the twin ``neo_jvp_ref`` in
float64 (max relative error <= 1e-10) and float32 (<= 1e-4) on the GPU
test boxes and at n = 72, then times each at n = 72 in float32 with and
without the mass as a CUDA graph of 50 calls (``rounds`` times, default 2):
the whole B2, its element pass alone and ``gather_kernel`` alone, beside
the bound of chip_smoke.py.  Last, the other yardstick: a plain loop of 20
calls (chip_smoke._time) of the old and the shipped B2, and of the wrapper
``neo_tangent`` by graph and by loop, as chip_smoke.py reads it.
"""

import ctypes
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
from fourc_tpu_torch.ops import lattice_kernels as lk  # noqa: E402

VARIANTS = ["old", "a", "a_lb4", "b", "b_lb4"]
N_FULL = 72
MCOEF = 9930.0  # chip_smoke.py's mcoef
# (shape, spacing, u scale): the boxes of tests/port/test_torch_gpu.py, then
# chip_smoke.py's n = 72 box
CHECKS = [((1, 1, 1), (0.3, 0.2, 0.4), 1e-2), ((4, 3, 5), (0.3, 0.2, 0.4), 1e-2),
          ((9, 7, 12), (0.3, 0.2, 0.4), 1e-2),
          ((9, 7, 12), (0.3, 0.2, 0.4), 4e-2),
          ((N_FULL,) * 3, (1.0 / N_FULL,) * 3, 5e-2 / N_FULL)]


def build():
    out = ROOT / "build" / "tools" / "libb2_variants.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [cb.find_nvcc(), *cb.NVCC_FLAGS, "-I", str(cb.CSRC), "-o", str(out),
         str(ROOT / "tools" / "b2_variants.cu")],
        capture_output=True, text=True)
    if proc.returncode:
        sys.exit(f"nvcc failed:\n{proc.stderr}")
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    name = spills = None
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and name and re.search(
                r"variant|tangent_elem|gather_kernel", name):
            regs = re.search(r"Used (\d+) registers", line).group(1)
            print(f"ptxas {name}: {regs} registers, {spills}", flush=True)
    lib = ctypes.CDLL(str(out))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in VARIANTS:
        for part in ("full", "elem"):
            for sfx in cb.SUFFIX.values():
                f = getattr(lib, f"b2v_{name}_{part}_{sfx}")
                f.argtypes = [P, P, P, P, P, D, D, I, D, P, P, I, I, I, P]
                f.restype = I
    for sfx in cb.SUFFIX.values():
        f = getattr(lib, f"b2v_gather_{sfx}")
        f.argtypes = [P, P, I, I, I, P]
        f.restype = I
    return lib


class Case:
    """Inputs of one B2 call on the card: u, v, the tables, the output and
    the (24, E) scratch."""

    def __init__(self, shape, h, scale, dtype, seed=4):
        spec = lat.LatticeSpec(pshape=tuple(s + 1 for s in shape), h=h)
        rng = np.random.default_rng(seed)

        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype,
                                   device="cuda").contiguous()

        def field(s):
            return lat.to_lattice(t(rng.normal(size=spec.ndof) * s), spec)

        cell = cells.get_cell("hex8")
        G, wdet = lat.uniform_geometry(cell, spec)
        self.G, self.wdet, self.N = t(G), t(wdet), t(cell.N)
        self.u, self.v = field(scale), field(1.0)
        self.shape = shape
        self.out = torch.empty_like(self.u)
        self.scratch = torch.empty((24, int(np.prod(shape))), dtype=dtype,
                                   device="cuda")
        self.lam, self.mu = lame(1.0e4, 0.3)

    def call(self, lib, name, part, model, mcoef):
        f = getattr(lib, f"b2v_{name}_{part}_{cb.SUFFIX[self.u.dtype]}")
        args = (cb.ptr(self.u), cb.ptr(self.v), cb.ptr(self.G),
                cb.ptr(self.wdet), cb.ptr(self.N), self.lam, self.mu,
                cb.MODELS[model], mcoef, cb.ptr(self.scratch),
                cb.ptr(self.out), *self.shape)

        def run():
            cb.run(f, *args)
            return self.out
        return run

    def gather(self, lib):
        f = getattr(lib, f"b2v_gather_{cb.SUFFIX[self.u.dtype]}")
        args = (cb.ptr(self.scratch), cb.ptr(self.out), *self.shape)

        def run():
            cb.run(f, *args)
            return self.out
        return run

    def twin(self, model, mcoef):
        return lat.neo_jvp_ref(self.u, self.v, self.G, self.wdet, self.lam,
                               self.mu, model, N=self.N, mcoef=mcoef)


def check(lib):
    for shape, h, scale in CHECKS:
        for dtype, tol in ((torch.float64, cs.F64_TOL),
                           (torch.float32, cs.F32_TOL)):
            c = Case(shape, h, scale, dtype)
            worst = 0.0
            for model, mcoef in (("neohooke", 0.0), ("neohooke", MCOEF),
                                 ("svk", MCOEF)):
                want = c.twin(model, mcoef)
                for name in VARIANTS:
                    c.out.fill_(float("nan"))
                    got = c.call(lib, name, "full", model, mcoef)()
                    torch.cuda.synchronize()
                    rel = float((got - want).abs().max() / want.abs().max())
                    if not (torch.isfinite(got).all() and rel <= tol):
                        sys.exit(f"FAIL {name} {shape} u scale {scale} "
                                 f"{model} mcoef {mcoef} {dtype}: rel err "
                                 f"{rel}")
                    worst = max(worst, rel)
            print(f"check {shape} u scale {scale:g} {str(dtype)[6:]}: "
                  f"{len(VARIANTS)} variants x 3 cases agree with the twin, "
                  f"worst rel err {worst:.2e}", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    lib = build()
    check(lib)
    c = Case((N_FULL,) * 3, (1.0 / N_FULL,) * 3, 5e-2 / N_FULL, torch.float32)
    for rnd in range(1, rounds + 1):
        us = 1e3 * cs._time_graph(c.gather(lib), reps=50)
        print(f"round {rnd} n={N_FULL} gather_kernel alone {us:7.2f} us",
              flush=True)
        for case, mcoef in (("neohooke", 0.0), ("neohooke+mass", MCOEF)):
            bound, by = cs._bound("tangent", case, N_FULL, (c.u, c.v, c.out))
            for name in VARIANTS:
                full = 1e3 * cs._time_graph(
                    c.call(lib, name, "full", "neohooke", mcoef), reps=50)
                elem = 1e3 * cs._time_graph(
                    c.call(lib, name, "elem", "neohooke", mcoef), reps=50)
                print(f"round {rnd} n={N_FULL} {case:13s} {name:6s} B2 "
                      f"{full:7.2f} us, element pass {elem:7.2f} us; bound "
                      f"{bound * 1e3:.2f} us ({by}), share {bound * 1e3 / full:.1%}",
                      flush=True)
    for case, mcoef in (("neohooke", 0.0), ("neohooke+mass", MCOEF)):
        loops = {name: 1e3 * cs._time(c.call(lib, name, "full", "neohooke",
                                             mcoef))
                 for name in ("old", "a_lb4")}

        def wrapper(m=mcoef):
            return lk.neo_tangent(c.u, c.v, c.G, c.wdet, c.N, c.lam, c.mu,
                                  "neohooke", m)
        graph, loop = 1e3 * cs._time_graph(wrapper), 1e3 * cs._time(wrapper)
        print(f"loop n={N_FULL} {case:13s} old {loops['old']:7.2f} us, "
              f"a_lb4 {loops['a_lb4']:7.2f} us; wrapper neo_tangent graph "
              f"{graph:7.2f} us, loop {loop:7.2f} us", flush=True)


if __name__ == "__main__":
    main()
