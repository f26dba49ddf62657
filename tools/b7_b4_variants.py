#!/usr/bin/env python3
"""Time the variants of B7 (element-batch tangent) and B4 (general-geometry
force) on one CUDA GPU.

Usage, from the repository root on a machine with a CUDA device and nvcc:

    python tools/b7_b4_variants.py [rounds]

Builds ``tools/b7_b4_variants.cu`` (the shipped kernels "shipped", the dense
passes they replaced "old", and the edge kernels at the compiler's register
count "a", at most 168 registers "a_lb3" and at most 128 "a_lb") with nvcc
into ``build/tools`` and prints ptxas's registers and spills of each B7 and
B4 kernel. Checks every variant against its twin (``hex8_tangent_ref``,
``neo_force_gen_ref``) in float64 (max relative error <= 1e-10) and float32
(<= 1e-4) in every mode: B7 on the element batches of
tests/port/test_torch_gpu.py (E = 1, 130, 1000) and of chip_smoke.py's
permuted box at n = 56, B4 on the jittered boxes of the GPU tests and
chip_smoke.py's jittered box at n = 72. For float32 it prints each variant's
error, and the float32 twin's, against the float64 twin on the same
(float32) inputs. Then times each variant in float32 as a CUDA graph of 50
calls (``rounds`` times, default 2, the variants in turn): B7 at n = 56 in
its four modes, B4 at n = 72 in its four modes (whole B4 with the gather,
and its element pass alone), beside chip_smoke.py's bound and, for B4, the
bound on the dense pass's flop count (``OLD_B4_FLOPS``).
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
from fourc_tpu_torch.core import cells  # noqa: E402
from fourc_tpu_torch.materials.elastic import lame  # noqa: E402
from fourc_tpu_torch.ops import cuda_build as cb  # noqa: E402
from fourc_tpu_torch.ops import lattice as lat  # noqa: E402
from fourc_tpu_torch.ops import solid as sops  # noqa: E402

VARIANTS = ["old", "a", "a_lb3", "a_lb", "shipped"]
N_B7, N_B4 = cs.FULL_N["permuted"], cs.FULL_N["jittered"]
MCOEF = 9930.0  # chip_smoke.py's mcoef
# mode -> (model, mcoef) of B7; (model, mcoef, stiff) of B4, as
# chip_smoke.py's cases
B7_MODES = {"neohooke": ("neohooke", 0.0),
            "neohooke+mass": ("neohooke", MCOEF),
            "svk": ("svk", 0.0), "svk+mass": ("svk", MCOEF)}
B4_MODES = {"neohooke": ("neohooke", 0.0, True), "svk": ("svk", 0.0, True),
            "mass-only": ("svk", 1.0, False),
            "neohooke+mass": ("neohooke", MCOEF, True)}
# Flops per element of B4's dense first pass, as chip_smoke.py counted them
# before the edge form: per Gauss point grad 144, strain_A 63, the stress
# 139 (Neo-Hooke) or 16 (SVK), F 3, F S 45, the dense accumulation 168, the
# Jacobian 196, H = Hhat Jinv 45, P Jinv^T 45, the mass 106; the mass-only
# mode grad, det3 14, wdet 1 and the mass; the gather 24 per element.
OLD_B4_FLOPS = {"neohooke": 6808, "svk": 5824, "mass-only": 2144,
                "neohooke+mass": 7656}


def _label(mangled):
    """'solid_tangent_kernel<f, 0, 1, 3>' from a mangled kernel name
    _ZN<namespace><name>I<type><template ints>E..."""
    m = re.match(r"_ZN(\d+)", mangled)
    if m is None:
        return mangled
    i = m.end() + int(m.group(1))
    m = re.match(r"(\d+)", mangled[i:])
    i += m.end()
    name = mangled[i:i + int(m.group(1))]
    m = re.match(r"I([fd])((?:L[bi]\d+E)*)", mangled[i + len(name):])
    if m is None:
        return name
    args = re.findall(r"L[bi](\d+)E", m.group(2))
    return f"{name}<{', '.join([m.group(1), *args])}>"


def build():
    """Compile tools/b7_b4_variants.cu unless the library is newer than its
    sources; print the ptxas registers and spills of each B7 and B4
    kernel."""
    out = ROOT / "build" / "tools" / "libb7_b4_variants.so"
    log = out.with_suffix(".log")
    srcs = [ROOT / "tools" / "b7_b4_variants.cu",
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
                r"solid_tangent|force_gen", name):
            regs = re.search(r"Used (\d+) registers", line).group(1)
            print(f"ptxas {_label(name)}: {regs} registers, {spills}",
                  flush=True)
    lib = ctypes.CDLL(str(out))
    P, I, D, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, \
        ctypes.c_longlong
    for name in VARIANTS:
        for sfx in cb.SUFFIX.values():
            f = getattr(lib, f"b7v_{name}_{sfx}")
            f.argtypes = [P, P, P, P, P, P, D, D, I, D, L, P, P]
            f.restype = I
            for part in ("full", "elem"):
                f = getattr(lib, f"b4v_{name}_{part}_{sfx}")
                f.argtypes = [P, P, P, P, P, D, D, I, D, I, P, P, I, I, I, P]
                f.restype = I
    return lib


def _tables(dtype):
    cell = cells.get_cell("hex8")
    return tuple(torch.as_tensor(np.asarray(a), dtype=dtype,
                                 device="cuda").contiguous()
                 for a in (cell.dN, cell.gauss_weights, cell.N))


class B7Case:
    """B7's inputs on the card: element batches X, u, v (24, E)."""

    def __init__(self, nodal, dtype):
        X, u, v = nodal
        self.X, self.u, self.v = (
            torch.as_tensor(a, dtype=dtype, device="cuda").contiguous()
            for a in (X, u, v))
        self.E = self.X.shape[1]
        self.tab = _tables(dtype)
        self.lam, self.mu = lame(1.0e4, 0.3)

    @classmethod
    def permuted(cls, n, dtype, seed=5):
        """chip_smoke.py's permuted n^3 box and its draws."""
        disc = cs.make_mesh(n, "permuted")
        conn = disc.blocks["hex8"].conn
        rng = np.random.default_rng(seed)
        shape = disc.coords.shape
        return cls(tuple(a[conn].reshape(-1, 24).T for a in (
            np.asarray(disc.coords), rng.normal(size=shape) * 5e-2 / n,
            rng.normal(size=shape) / n)), dtype)

    @classmethod
    def batches(cls, E, dtype, seed=11):
        """tests/port/test_torch_gpu.py's batches of jittered boxes."""
        rng = np.random.default_rng(seed)
        base = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                         [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], float)
        Xe = (base[None] * rng.uniform(0.2, 0.5, size=(E, 1, 3))
              + rng.uniform(-0.02, 0.02, size=(E, 8, 3))
              + rng.uniform(0, 3, size=(E, 1, 3)))
        return cls(tuple(a.reshape(E, 24).T for a in (
            Xe, rng.normal(size=(E, 8, 3)) * 5e-3,
            rng.normal(size=(E, 8, 3)))), dtype)

    def call(self, lib, name, mode):
        model, mcoef = B7_MODES[mode]
        out = torch.empty_like(self.X)
        f = getattr(lib, f"b7v_{name}_{cb.SUFFIX[self.X.dtype]}")
        args = (cb.ptr(self.X), cb.ptr(self.u), cb.ptr(self.v),
                *map(cb.ptr, self.tab), float(self.lam), float(self.mu),
                cb.MODELS[model], float(mcoef), self.E, cb.ptr(out))

        def run():
            cb.run(f, *args)
            return out
        return run

    def twin(self, mode, dtype=None):
        model, mcoef = B7_MODES[mode]
        X, u, v = (a if dtype is None else a.to(dtype)
                   for a in (self.X, self.u, self.v))
        return sops.hex8_tangent_ref(X, u, v, self.lam, self.mu, model, mcoef)

    def bound(self, mode, out):
        n = round(self.E ** (1 / 3))
        return cs._bound("solid_tangent", mode, n, (self.X, self.u, self.v,
                                                    out))


class B4Case:
    """B4's inputs on the card: the coordinate lattice x and u."""

    def __init__(self, coords, scale, dtype, seed=5):
        self.shape = tuple(s - 1 for s in coords.shape[:3])
        spec = lat.LatticeSpec(pshape=coords.shape[:3], h=None)
        rng = np.random.default_rng(seed)
        self.x = lat.coord_lattice(coords.reshape(-1, 3), spec, dtype, "cuda")
        self.u = lat.to_lattice(torch.as_tensor(
            rng.normal(size=spec.ndof) * scale, dtype=dtype,
            device="cuda"), spec)
        self.tab = _tables(dtype)
        self.lam, self.mu = lame(1.0e4, 0.3)

    @classmethod
    def jittered(cls, n, dtype):
        """chip_smoke.py's jittered n^3 box."""
        disc = cs.make_mesh(n, "jittered")
        return cls(np.asarray(disc.coords).reshape((n + 1,) * 3 + (3,)),
                   5e-2 / n, dtype)

    @classmethod
    def gpu_test_box(cls, shape, dtype):
        """tests/port/test_torch_gpu.py's jitter: spacing (0.3, 0.2, 0.4),
        every node moved by up to +-0.15 h per axis."""
        pshape = tuple(s + 1 for s in shape)
        idx = np.stack(np.meshgrid(*[np.arange(p) for p in pshape],
                                   indexing="ij"), axis=-1)
        h = np.array([0.3, 0.2, 0.4])
        rng = np.random.default_rng(7)
        return cls(idx * h + (rng.random(idx.shape) - 0.5) * 0.3 * h, 1e-2,
                   dtype)

    def call(self, lib, name, part, mode):
        model, mcoef, stiff = B4_MODES[mode]
        out = torch.empty_like(self.u)
        scratch = torch.empty((24, int(np.prod(self.shape))),
                              dtype=self.u.dtype, device="cuda")
        f = getattr(lib, f"b4v_{name}_{part}_{cb.SUFFIX[self.u.dtype]}")
        args = (cb.ptr(self.x), cb.ptr(self.u), *map(cb.ptr, self.tab),
                float(self.lam), float(self.mu), cb.MODELS[model],
                float(mcoef), int(stiff), cb.ptr(scratch), cb.ptr(out),
                *self.shape)

        def run():
            cb.run(f, *args)
            return out
        run.scratch = scratch  # alive as long as the call
        return run

    def twin(self, mode, dtype=None):
        model, mcoef, stiff = B4_MODES[mode]
        x, u, tab = self.x, self.u, self.tab
        if dtype is not None:
            x, u, *tab = (a.to(dtype) for a in (x, u, *tab))
        return lat.neo_force_gen_ref(x, u, *tab, self.lam, self.mu, model,
                                     mcoef, stiff)

    def bounds(self, mode, out):
        """(recounted bound ms, its limit, the dense count's bound ms)."""
        n = self.shape[0]
        ins = (self.x, self.u, out)
        nbytes = sum(t.numel() * t.element_size() for t in ins)
        old = 1e3 * max(nbytes / cs.PEAK_BYTES,
                        OLD_B4_FLOPS[mode] * n ** 3 / cs.PEAK_F32_FLOPS)
        return (*cs._bound("force_gen", mode, n, ins), old)


def _check_case(kernel, label, case, modes, call, dtype, tol,
                variants=VARIANTS):
    """Every variant against the twin in every mode; float32 also against
    the float64 twin on the same inputs."""
    worst = 0.0
    to64 = collections.defaultdict(lambda: [0.0, 0.0])
    for mode in modes:
        want = case.twin(mode)
        want64 = case.twin(mode, torch.float64) \
            if dtype == torch.float32 else None
        for name in variants + ["twin"]:
            got = want if name == "twin" else call(name, mode)()
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
                sys.exit(f"FAIL {kernel} {name} {label} {mode} {dtype}: rel "
                         f"err {rel}")
            worst = max(worst, rel)
    print(f"check {kernel} {label} {str(dtype)[6:]}: every variant x mode "
          f"agrees with the twin, worst rel err {worst:.2e}", flush=True)
    if to64:
        print(f"check {kernel} {label} float32 against the float64 twin on "
              f"the same inputs, max abs err / worst rel err: "
              + "; ".join(f"{k} {a:.2e} / {r:.2e}"
                          for k, (a, r) in to64.items()), flush=True)


def check(lib):
    for dtype, tol in ((torch.float64, cs.F64_TOL),
                       (torch.float32, cs.F32_TOL)):
        for E in (1, 130, 1000):
            c = B7Case.batches(E, dtype)
            _check_case("B7", f"E={E}", c, B7_MODES,
                        lambda name, mode, c=c: c.call(lib, name, mode),
                        dtype, tol)
        c = B7Case.permuted(N_B7, dtype)
        _check_case("B7", f"permuted n={N_B7}", c, B7_MODES,
                    lambda name, mode, c=c: c.call(lib, name, mode),
                    dtype, tol)
        for shape in ((4, 3, 5), (9, 7, 12)):
            c = B4Case.gpu_test_box(shape, dtype)
            _check_case("B4", f"{shape}", c, B4_MODES,
                        lambda name, mode, c=c: c.call(lib, name, "full",
                                                       mode), dtype, tol)
        c = B4Case.jittered(N_B4, dtype)
        _check_case("B4", f"jittered n={N_B4}", c, B4_MODES,
                    lambda name, mode, c=c: c.call(lib, name, "full", mode),
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
    b7 = B7Case.permuted(N_B7, torch.float32)
    b4 = B4Case.jittered(N_B4, torch.float32)
    for rnd in range(1, rounds + 1):
        for mode in B7_MODES:
            for name in VARIANTS:
                run = b7.call(lib, name, mode)
                ms = cs._time_graph(run, reps=50)
                bound, by = b7.bound(mode, run())
                print(f"round {rnd} B7 n={N_B7} {mode:13s} {name:7s} "
                      f"{1e3 * ms:7.2f} us, bound {1e3 * bound:.3f} us "
                      f"({by}), share {bound / ms:.1%}", flush=True)
        for mode in B4_MODES:
            for name in VARIANTS:
                run = b4.call(lib, name, "full", mode)
                full = cs._time_graph(run, reps=50)
                bound, by, old = b4.bounds(mode, run())
                elem = "" if name == "shipped" else (
                    "element pass " + format(1e3 * cs._time_graph(
                        b4.call(lib, name, "elem", mode), reps=50), "7.2f")
                    + " us, ")
                print(f"round {rnd} B4 n={N_B4} {mode:13s} {name:7s} "
                      f"{1e3 * full:7.2f} us, {elem}bound {1e3 * bound:.3f} "
                      f"us ({by}), share {bound / full:.1%}; dense count's "
                      f"bound {1e3 * old:.3f} us, share {old / full:.1%}",
                      flush=True)


if __name__ == "__main__":
    main()
