#!/usr/bin/env python3
"""Time the variants of the B5 general-geometry tangent kernel on one CUDA GPU.

Usage, from the repository root on a machine with a CUDA device and nvcc:

    python tools/b5_variants.py [rounds]

Builds ``tools/b5_variants.cu`` (the shipped B5 "shipped"; the element pass
it replaced "old"; the edge-difference pass at the compiler's register count
"a", at most 168 registers "a_lb3" and at most 128 "a_lb"; the same with x
held as its corners "b", "b_lb3" and "b_lb"; the Gauss-point mapping of the
linear mode "c") with nvcc into ``build/tools`` and prints ptxas's registers
and spills of each kernel. Checks every variant (element pass and gather)
against the twin ``neo_jvp_gen_ref`` in float64 (max relative error <=
1e-10) and float32 (<= 1e-4) on the GPU test boxes and at n = 72, in the
linear mode, Neo-Hooke with and without the mass and SVK with the mass, and
prints each float32 variant's error, and the float32 twin's, against the
float64 twin on the same (float32) inputs. Then times each, in float32 as a
CUDA graph of 50 calls (``rounds`` times, default 2): the linear mode at n =
72, 36, 18 and 9 on the jittered lattices of the GMG levels of
chip_smoke.py's jittered path (every second node of the level above,
coordinates included), and the Neo-Hooke mode with and without the mass at
n = 72: the whole B5, its element pass alone and ``gather_kernel`` alone,
beside the bound of chip_smoke.py on the recounted flops and on the count
of the dense first pass (``OLD_ELEM_FLOPS``). Last, where the launcher
switches between its two mappings of the linear mode: the element pass by
edges ("a_lb"), by Gauss points ("c") and the shipped B5 on the jittered
boxes of ``SWITCH_SIZES`` elements per axis, with the elements per SM.
"""

import collections
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
from fourc_tpu_torch.core import cells, gridgen  # noqa: E402
from fourc_tpu_torch.materials.elastic import lame  # noqa: E402
from fourc_tpu_torch.ops import cuda_build as cb  # noqa: E402
from fourc_tpu_torch.ops import lattice as lat  # noqa: E402

VARIANTS = ["old", "a", "a_lb3", "a_lb", "b", "b_lb3", "b_lb", "c", "shipped"]
N_FULL = 72
LEVELS = (72, 36, 18, 9)
# between the levels n = 18 (44 elements per SM of an H100's 132) and n = 36
# (353): 61, 70, 81, 92, 105, 149 and 205 elements per SM
SWITCH_SIZES = (20, 21, 22, 23, 24, 27, 30)
MCOEF = 9930.0  # chip_smoke.py's mcoef
# case -> (u given, model, mcoef); "c" runs the linear mode only
CASES = {"linear (u=0)": (False, "svk", 0.0),
         "neohooke": (True, "neohooke", 0.0),
         "neohooke+mass": (True, "neohooke", MCOEF),
         "svk+mass": (True, "svk", MCOEF)}
# (shape, u scale): the boxes of tests/port/test_torch_gpu.py (spacing
# (0.3, 0.2, 0.4), every node jittered by up to +-0.15 h), then
# chip_smoke.py's jittered n = 72 box
CHECKS = [((1, 1, 1), 1e-2), ((4, 3, 5), 1e-2), ((9, 7, 12), 1e-2),
          ((N_FULL,) * 3, 5e-2 / N_FULL)]
# Flops per element of B5's dense first pass, as chip_smoke.py counted
# them before the edge form: per Gauss point the Jacobian 196, the
# gradients of v (and u) 144 + 45 each, the material-form tangent 63 + 117
# + 139 + 300 + 3 + 9 + 90 (Neo-Hooke) or 9 + 16 (linear), P Jinv^T 45, the
# dense accumulation 168, the mass 106; the gather 24 per element.
OLD_ELEM_FLOPS = {"neohooke": 12088, "neohooke+mass": 12936,
                  "linear (u=0)": 5008}


def build(report=True):
    """Compile tools/b5_variants.cu unless the library is newer than its
    sources; print (``report``) the ptxas registers and spills of each B5
    kernel."""
    out = ROOT / "build" / "tools" / "libb5_variants.so"
    log = out.with_suffix(".log")
    srcs = [ROOT / "tools" / "b5_variants.cu",
            ROOT / "tools" / "dense_passes.cuh",
            *(cb.CSRC / s for s in ("lattice_kernels.cu", cb.HEADER))]
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
        elif report and "Used" in line and name and re.search(
                r"tangent_gen|corner_kernel", name):
            regs = re.search(r"Used (\d+) registers", line).group(1)
            print(f"ptxas {name}: {regs} registers, {spills}", flush=True)
    lib = ctypes.CDLL(str(out))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in VARIANTS:
        for part in ("full", "elem"):
            for sfx in cb.SUFFIX.values():
                f = getattr(lib, f"b5v_{name}_{part}_{sfx}")
                f.argtypes = [P, P, P, P, P, P, D, D, I, D, P, P, I, I, I, P]
                f.restype = I
    for sfx in cb.SUFFIX.values():
        f = getattr(lib, f"b5v_gather_{sfx}")
        f.argtypes = [P, P, I, I, I, P]
        f.restype = I
    return lib


def gpu_test_coords(spec, rng):
    """tests/port/test_torch_gpu.py's jitter: every node moved by up to
    +-0.15 h per axis."""
    idx = np.stack(np.meshgrid(*[np.arange(p) for p in spec.pshape],
                               indexing="ij"), axis=-1)
    h = np.asarray(spec.h)
    return idx * h + (rng.random(idx.shape) - 0.5) * 0.3 * h


def bench_coords(n):
    """The jittered n^3 box of chip_smoke.py as a (n+1, n+1, n+1, 3) array."""
    disc = cs.jitter(gridgen.box(n, n, n), n)
    return np.asarray(disc.coords).reshape((n + 1,) * 3 + (3,))


def launcher(lib, name, part, x, u, v, tab, lam, mu, model, mcoef):
    """A call of variant ``name`` (``part`` "full": element pass and gather,
    "elem": the element pass alone) on B5's inputs, with its own output and
    (24, E) scratch; u None is the linear mode."""
    shape = tuple(int(s) - 3 for s in v.shape[1:])
    out = torch.empty_like(v)
    scratch = torch.empty((24, int(np.prod(shape))), dtype=v.dtype,
                          device=v.device)
    f = getattr(lib, f"b5v_{name}_{part}_{cb.SUFFIX[v.dtype]}")
    args = (cb.ptr(x), None if u is None else cb.ptr(u), cb.ptr(v),
            *map(cb.ptr, tab), float(lam), float(mu), cb.MODELS[model],
            float(mcoef), cb.ptr(scratch), cb.ptr(out), *shape)

    def run():
        cb.run(f, *args)
        return out
    run.scratch = scratch  # alive as long as the call
    return run


def old_bound(case, n, tensors):
    """The dense count's bound (ms) of one call on n^3 elements:
    OLD_ELEM_FLOPS over the float32 peak or the bytes over the memory rate,
    the larger."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return 1e3 * max(nbytes / cs.PEAK_BYTES,
                     OLD_ELEM_FLOPS[case] * n ** 3 / cs.PEAK_F32_FLOPS)


class Case:
    """Inputs of one B5 call on the card: the coordinate lattice x, u, v and
    the hex8 tables."""

    def __init__(self, coords, scale, dtype, seed=5):
        self.shape = tuple(s - 1 for s in coords.shape[:3])
        spec = lat.LatticeSpec(pshape=coords.shape[:3], h=None)
        rng = np.random.default_rng(seed)

        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype,
                                   device="cuda").contiguous()

        ndof = 3 * int(np.prod(spec.pshape))
        self.x = lat.coord_lattice(coords.reshape(-1, 3), spec, dtype, "cuda")
        self.u = lat.to_lattice(t(rng.normal(size=ndof) * scale), spec)
        self.v = lat.to_lattice(t(rng.normal(size=ndof)), spec)
        cell = cells.get_cell("hex8")
        self.tab = tuple(t(a) for a in (cell.dN, cell.gauss_weights, cell.N))
        self.lam, self.mu = lame(1.0e4, 0.3)

    def inputs(self, case):
        with_u, model, mcoef = CASES[case]
        return (self.x, self.u if with_u else None, self.v, self.tab,
                self.lam, self.mu, model, mcoef)

    def call(self, lib, name, part, case):
        return launcher(lib, name, part, *self.inputs(case))

    def gather(self, lib):
        scratch = torch.empty((24, int(np.prod(self.shape))),
                              dtype=self.v.dtype, device="cuda")
        out = torch.empty_like(self.v)
        f = getattr(lib, f"b5v_gather_{cb.SUFFIX[self.v.dtype]}")
        args = (cb.ptr(scratch), cb.ptr(out), *self.shape)

        def run():
            cb.run(f, *args)
            return out
        run.scratch = scratch  # alive as long as the call
        return run

    def twin(self, case, dtype=None):
        """The twin on this case's inputs, cast to ``dtype`` if given."""
        x, u, v, tab, lam, mu, model, mcoef = self.inputs(case)
        if dtype is not None:
            x, v, *tab = (a.to(dtype) for a in (x, v, *tab))
            u = None if u is None else u.to(dtype)
        return lat.neo_jvp_gen_ref(x, u, v, *tab, lam, mu, model, mcoef)

    def bounds(self, case):
        """(recounted bound ms, its limit, the dense count's bound ms) of one
        call."""
        n = self.shape[0]
        ins = (self.x, self.v) if case == "linear (u=0)" else \
            (self.x, self.u, self.v)
        bound, by = cs._bound("tangent_gen", case, n, ins + (self.v,))
        return bound, by, old_bound(case, n, ins + (self.v,))


def variants_of(case):
    return [v for v in VARIANTS if v != "c" or case == "linear (u=0)"]


def check(lib):
    for shape, scale in CHECKS:
        for dtype, tol in ((torch.float64, cs.F64_TOL),
                           (torch.float32, cs.F32_TOL)):
            if shape[0] == N_FULL:
                coords = bench_coords(N_FULL)
            else:
                rng = np.random.default_rng(7)
                spec = lat.LatticeSpec(tuple(s + 1 for s in shape),
                                       (0.3, 0.2, 0.4))
                coords = gpu_test_coords(spec, rng)
            c = Case(coords, scale, dtype)
            worst = 0.0
            # float32 only: (max abs err, worst rel err) over the cases
            # against the float64 twin, per variant and for the twin
            to64 = collections.defaultdict(lambda: [0.0, 0.0])
            for case in CASES:
                want = c.twin(case)
                want64 = (c.twin(case, torch.float64)
                          if dtype == torch.float32 else None)
                for name in variants_of(case) + ["twin"]:
                    got = want if name == "twin" else \
                        c.call(lib, name, "full", case)()
                    torch.cuda.synchronize()
                    if want64 is not None:
                        err = float((got.double() - want64).abs().max())
                        acc = to64[name]
                        acc[0] = max(acc[0], err)
                        acc[1] = max(acc[1], err / float(want64.abs().max()))
                    if name == "twin":
                        continue
                    rel = float((got - want).abs().max() / want.abs().max())
                    if not (torch.isfinite(got).all() and rel <= tol):
                        sys.exit(f"FAIL {name} {shape} {case} {dtype}: rel "
                                 f"err {rel}")
                    worst = max(worst, rel)
            print(f"check {shape} u scale {scale:g} {str(dtype)[6:]}: every "
                  f"variant x case agrees with the twin, worst rel err "
                  f"{worst:.2e}", flush=True)
            if to64:
                print(f"check {shape} float32 against the float64 twin on "
                      f"the same inputs, max abs err / worst rel err: "
                      + "; ".join(f"{k} {a:.2e} / {r:.2e}"
                                  for k, (a, r) in to64.items()), flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    lib = build()
    check(lib)
    fine = bench_coords(N_FULL)
    cases = [(n, "linear (u=0)") for n in LEVELS] + \
        [(N_FULL, "neohooke"), (N_FULL, "neohooke+mass")]
    inputs = {n: Case(fine[::N_FULL // n, ::N_FULL // n, ::N_FULL // n],
                      5e-2 / N_FULL, torch.float32) for n in LEVELS}
    for rnd in range(1, rounds + 1):
        for n in LEVELS:
            us = 1e3 * cs._time_graph(inputs[n].gather(lib), reps=50)
            print(f"round {rnd} n={n:2d} gather_kernel alone {us:7.2f} us",
                  flush=True)
        for n, case in cases:
            c = inputs[n]
            bound, by, old = c.bounds(case)
            for name in variants_of(case):
                full = 1e3 * cs._time_graph(c.call(lib, name, "full", case),
                                            reps=50)
                elem = "" if name == "shipped" else (
                    "element pass " + format(1e3 * cs._time_graph(
                        c.call(lib, name, "elem", case), reps=50), "7.2f")
                    + " us, ")
                print(f"round {rnd} n={n:2d} {case:13s} {name:7s} B5 "
                      f"{full:7.2f} us, {elem}bound {bound * 1e3:.3f} us "
                      f"({by}), share {bound * 1e3 / full:.1%}; dense count's "
                      f"bound {old * 1e3:.3f} us, share "
                      f"{old * 1e3 / full:.1%}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    between = {n: Case(bench_coords(n), 5e-2 / n, torch.float32)
               for n in SWITCH_SIZES}
    for rnd in range(1, rounds + 1):
        for n in SWITCH_SIZES:
            times = {name: 1e3 * cs._time_graph(
                between[n].call(lib, name, "full", "linear (u=0)"), reps=50)
                for name in ("a_lb", "c", "shipped")}
            print(f"round {rnd} switch n={n:2d} ({n ** 3 / sms:.0f} elements "
                  f"per SM) linear B5 by edges (a_lb) {times['a_lb']:7.2f} "
                  f"us, by Gauss points (c) {times['c']:7.2f} us, shipped "
                  f"{times['shipped']:7.2f} us", flush=True)


if __name__ == "__main__":
    main()
