#!/usr/bin/env python3
"""Time the variants of the B3 stencil kernel on one CUDA GPU.

Usage, from the repository root on a machine with a CUDA device and nvcc:

    python tools/b3_variants.py [rounds]

Builds ``tools/b3_variants.cu`` (the shipped kernel, the element walk it
replaced, other rows per thread and threads per block, earlier prologues and
mappings, and three cut-down versions) with nvcc into ``build/tools`` and
prints ptxas's registers and spills of each.  Checks every full variant
against the twin ``stencil_matvec_ref`` in float64 (max relative error
<= 1e-10) and float32 (<= 1e-4) on small boxes and on the flagship's GMG
levels, then times each variant at n = 72, 36, 18 and 9 in float32 as a
CUDA graph of 50 calls (``rounds`` times, default 2), beside the bound of
chip_smoke.py.
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
from fourc_tpu_torch.ops import cuda_build as cb  # noqa: E402
from fourc_tpu_torch.ops import lattice as lat  # noqa: E402

FULL = ["walk", "shipped", "r1_t128", "r2_t128", "r8_t128", "r1_t256",
        "r2_t256", "r4_t256", "two_barriers", "two_barriers_skip",
        "mixed_block"]
CUT_DOWN = ["shell_only", "interior_only", "prologue_only"]
CHECK_SHAPES = [(1, 1, 1), (2, 3, 1), (5, 9, 3), (5, 10, 3), (9, 7, 12),
                (16, 16, 16), (36, 36, 36), (72, 72, 72)]
LEVELS = (72, 36, 18, 9)


def build():
    out = ROOT / "build" / "tools" / "libb3_variants.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [cb.find_nvcc(), *cb.NVCC_FLAGS, "-I", str(cb.CSRC), "-o", str(out),
         str(ROOT / "tools" / "b3_variants.cu")],
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
        elif "Used" in line and name and re.search(r"variant|walk|stencil",
                                                   name):
            regs = re.search(r"Used (\d+) registers", line).group(1)
            print(f"ptxas {name}: {regs} registers, {spills}", flush=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    for name in FULL + CUT_DOWN:
        for sfx in cb.SUFFIX.values():
            f = getattr(lib, f"b3v_{name}_{sfx}")
            f.argtypes = [P, P, P, I, I, I, P]
            f.restype = I
    return lib


def launcher(lib, name, K, v, out):
    f = getattr(lib, f"b3v_{name}_{cb.SUFFIX[v.dtype]}")
    args = (cb.ptr(K), cb.ptr(v), cb.ptr(out), *(s - 3 for s in v.shape[1:]))

    def call():
        cb.run(f, *args)
        return out
    return call


def inputs(shape, dtype, seed=1):
    spec = lat.LatticeSpec(pshape=tuple(s + 1 for s in shape), h=(1.0,) * 3)
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(24, 24))
    K = torch.as_tensor(lat.collapse_stencil(B + B.T), dtype=dtype,
                        device="cuda").contiguous()
    v = lat.to_lattice(torch.as_tensor(rng.normal(size=spec.ndof),
                                       dtype=dtype, device="cuda"), spec)
    return K, v.contiguous()


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    lib = build()
    for shape in CHECK_SHAPES:
        for dtype, tol in ((torch.float64, cs.F64_TOL),
                           (torch.float32, cs.F32_TOL)):
            K, v = inputs(shape, dtype)
            want = lat.stencil_matvec_ref(K, v)
            worst = 0.0
            for name in FULL:
                got = launcher(lib, name, K, v,
                               torch.full_like(v, float("nan")))()
                torch.cuda.synchronize()
                rel = float((got - want).abs().max() / want.abs().max())
                if not (torch.isfinite(got).all() and rel <= tol):
                    sys.exit(f"FAIL {name} {shape} {dtype}: rel err {rel}")
                worst = max(worst, rel)
            print(f"check {shape} {str(dtype)[6:]}: {len(FULL)} variants "
                  f"agree with the twin, worst rel err {worst:.2e}",
                  flush=True)
    for rnd in range(1, rounds + 1):
        for n in LEVELS:
            K, v = inputs((n, n, n), torch.float32)
            out = torch.empty_like(v)
            bound, by = cs._bound("stencil", "random K", n, (K, v, out))
            for name in FULL + CUT_DOWN:
                us = 1e3 * cs._time_graph(launcher(lib, name, K, v, out),
                                          reps=50)
                print(f"round {rnd} n={n:2d} {name:18s} {us:7.2f} us, "
                      f"bound {bound * 1e3:.2f} us ({by}), share "
                      f"{bound * 1e3 / us:.1%}", flush=True)


if __name__ == "__main__":
    main()
