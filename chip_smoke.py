#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fourc_tpu_torch) on one NVIDIA GPU.

Usage, from the repository root on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and the exit code is 1):

1. environment: GPU name and power limit, torch/CUDA versions, nvcc, triton;
2. build: compiles fourc_tpu_torch/csrc with nvcc for sm_90a;
3. kernels: each CUDA kernel against its plain PyTorch twin on the card, at
   n=16 and n=72, in float64 (max relative error <= 1e-10) and float32
   (<= 1e-4), plus kernel and twin times at n=72 in float32;
4. correctness: two gen-alpha steps at n=6 in float64 on the GPU (kernels)
   against the same steps on the CPU (twins, which tests/port holds to the
   JAX package), max relative error <= 1e-9;
5. main path: the flagship problem of bench.py at n=72 (1,167,051 dofs) in
   float32 through SolidField / make_step: 1 warm-up and 5 timed steps,
   every step converged, every kernel launched.

The last three lines are a JSON object with per-kernel results, the
``nvidia-smi`` name/power-limit line and ``{"ok": true, "device": ...}``.
"""

import json
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from fourc_tpu_torch import materials
from fourc_tpu_torch.core import cells, conditions, functions, gridgen
from fourc_tpu_torch.materials.elastic import lame
from fourc_tpu_torch.ops import lattice as lat
from fourc_tpu_torch.ops import lattice_kernels as lk
from fourc_tpu_torch.physics import solid as ps

F64_TOL, F32_TOL, STEP_TOL = 1e-10, 1e-4, 1e-9
SOURCE = "fourc_tpu_torch/csrc/lattice_kernels.cu"
REPLACES = {"stencil": "fourc_tpu/ops/lattice_pallas.py:90",
            "force": "fourc_tpu/ops/lattice_pallas.py:164",
            "tangent": "fourc_tpu/ops/lattice_pallas.py:189"}


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def phase_environment():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke "
                           "run needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    log("env", f"nvidia-smi: {smi_line}")
    log("env", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
               f"device {torch.cuda.get_device_name(0)}, "
               f"count {torch.cuda.device_count()}")
    log("env", f"nvcc: {shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'}")
    try:
        import triton  # noqa: F401

        log("env", f"triton {triton.__version__} imports")
    except ImportError as e:
        log("env", f"triton does not import ({e})")
    # Krylov sees every operator: keep TF32 off everywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi_line


def phase_build():
    t0 = time.perf_counter()
    path = lk.build()
    log("build", f"{path.name} in {time.perf_counter() - t0:.1f} s")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log("build", line.strip())


def _time(fn, reps=20):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernels():
    """Each kernel against its twin; returns per-kernel n=72 f32 results."""
    results = {k: {"max_abs_err": 0.0} for k in REPLACES}
    cell = cells.get_cell("hex8")
    lam, mu = lame(1.0e4, 0.3)
    mcoef = 9930.0  # rho (1-am) / ((1-af) beta dt^2) at dt=0.02, rho_inf 0.9
    for n in (16, 72):
        spec = lat.LatticeSpec(pshape=(n + 1,) * 3, h=(1.0 / n,) * 3)
        G, wdet = lat.uniform_geometry(cell, spec)
        rng = np.random.default_rng(n)
        B = rng.normal(size=(24, 24))
        K = lat.collapse_stencil(B + B.T)
        # displacements with gradients of order 5e-2
        u = rng.normal(size=spec.ndof) * 5e-2 / n
        v = rng.normal(size=spec.ndof) / n
        for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, F32_TOL)):
            def t(x):
                return torch.as_tensor(np.asarray(x), dtype=dtype,
                                       device="cuda").contiguous()

            ul, vl = lat.to_lattice(t(u), spec), lat.to_lattice(t(v), spec)
            Kt, Gt, wt, Nt = t(K), t(G), t(wdet), t(cell.N)
            cases = [
                ("stencil", "B3 random symmetric K",
                 lambda: lk.stencil_matvec(Kt, vl),
                 lambda: lat.stencil_matvec_ref(Kt, vl)),
            ]
            for model in ("neohooke", "svk"):
                cases.append((
                    "force", f"B1 {model}",
                    lambda m=model: lk.neo_force(ul, Gt, wt, lam, mu, m),
                    lambda m=model: lat.neo_force_ref(ul, Gt, wt, lam, mu, m)))
            for mc in (0.0, mcoef):
                cases.append((
                    "tangent", f"B2 neohooke mcoef={mc:g}",
                    lambda c=mc: lk.neo_tangent(ul, vl, Gt, wt, Nt, lam, mu,
                                                "neohooke", c),
                    lambda c=mc: lat.neo_jvp_ref(ul, vl, Gt, wt, lam, mu,
                                                 "neohooke", N=Nt, mcoef=c)))
            for key, label, kern, twin in cases:
                got, want = kern(), twin()
                torch.cuda.synchronize()
                if not (torch.isfinite(got).all()
                        and torch.isfinite(want).all()):
                    raise RuntimeError(f"{label} n={n}: non-finite output")
                abs_err = float((got - want).abs().max())
                rel = abs_err / float(want.abs().max())
                log("kernels", f"{label:28s} n={n:2d} {str(dtype)[6:]}: "
                               f"max rel err {rel:.3e} (tol {tol:g})")
                if not rel <= tol:
                    raise RuntimeError(f"{label} n={n} {dtype}: rel err "
                                       f"{rel:.3e} > {tol:g}")
                if n == 72 and dtype == torch.float32:
                    r = results[key]
                    r["max_abs_err"] = max(r["max_abs_err"], abs_err)
                    if "ms" not in r:  # time the first case of each kernel
                        r["ms"] = _time(kern)
                        r["plain_ms"] = _time(twin)
                        log("kernels", f"{label:28s} n=72 float32: kernel "
                                       f"{r['ms']:.3f} ms, twin "
                                       f"{r['plain_ms']:.3f} ms")
    return results


def build_flagship(n, device, dtype):
    """bench.py's flagship problem (f32 Newton settings for float32)."""
    disc = gridgen.box(n, n, n)
    ndof = disc.n_nodes * 3
    mat = materials.make_material({"type": "neohooke", "youngs": 1.0e4,
                                   "nue": 0.3, "density": 1.0})
    params = ps.SolidParams(kinem="nonlinear", dyntype="genalpha",
                            genalpha=ps.GenAlphaParams(rho_inf=0.9),
                            precond="gmg", predictor="constdis")
    nw = params.newton
    if dtype == torch.float64:
        nw.tol_res, nw.tol_res_rel, nw.tol_disp, nw.combine = \
            1e-8, 0.0, 1e30, "and"
    else:
        nw.tol_res = 1.5e-4 * ndof ** 0.5
        nw.tol_res_rel = 1e-4
        nw.tol_disp = 1e-7 * ndof ** 0.5
        nw.combine = "or"
    nw.max_iter, nw.stag_tol = 12, 0.0
    nw.lin_maxiter, nw.lin_rtol = 1000, 1e-4
    fm = functions.FunctionManager()
    fm.add(1, "sin(50.0*t)*(1-exp(-t/0.06))")
    dbc = [conditions.DirichletBC(disc.node_sets["zmin"], [1, 1, 1],
                                  [0, 0, 0])]
    neu = [conditions.NeumannBC(disc.face_sets["zmax"], [1, 0, 0],
                                [400.0, 0, 0], funct=[1, 0, 0])]
    return ps.SolidField(disc, {1: mat}, params, dirichlet=dbc, neumann=neu,
                         functions=fm, device=device, dtype=dtype)


def phase_correctness():
    out = {}
    for device in ("cuda", "cpu"):
        f = build_flagship(6, device, torch.float64)
        state = ps.compute_initial_state(f, ps.init_state(f))
        step = ps.make_step(f, dt=0.02)
        for _ in range(2):
            state, stats = step(state)
            if not stats["converged"]:
                raise RuntimeError(f"n=6 {device} step did not converge")
        out[device] = (state, stats)
    for k in ("d", "v", "a"):
        got, want = out["cuda"][0][k].cpu(), out["cpu"][0][k]
        rel = float((got - want).abs().max() / want.abs().max())
        log("check", f"n=6 float64 two steps, GPU kernels vs CPU twins: "
                     f"{k} max rel err {rel:.3e} (tol {STEP_TOL:g})")
        if not rel <= STEP_TOL:
            raise RuntimeError(f"GPU step disagrees with the CPU step on {k}")


def phase_main_path(n=72, n_steps=5):
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    f = build_flagship(n, "cuda", torch.float32)
    log("main", f"n={n}: {f.ndof} dofs, field built in "
                f"{time.perf_counter() - t0:.1f} s")
    lk.reset_launches()
    t0 = time.perf_counter()
    state = ps.compute_initial_state(f, ps.init_state(f))
    step = ps.make_step(f, dt=0.02)
    torch.cuda.synchronize()
    log("main", f"initial state + GMG setup {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    state, stats = step(state)
    torch.cuda.synchronize()
    log("main", f"warm-up step {1e3 * (time.perf_counter() - t0):.1f} ms: "
                f"{stats}")
    all_stats = [stats]
    t0 = time.perf_counter()
    timed = []
    for _ in range(n_steps):
        state, stats = step(state)
        timed.append(stats)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / n_steps
    all_stats += timed
    launches = dict(lk.launches)
    for i, st in enumerate(all_stats):
        log("main", f"step {i}: newton {st['iters']}, cg "
                    f"{st['lin_iters']}, resnorm {st['resnorm']:.4e}, "
                    f"converged {st['converged']}")
        if not (st["converged"] and np.isfinite(st["resnorm"])):
            raise RuntimeError(f"main-path step {i} did not converge")
    d = state["d"]
    if tuple(d.shape) != f.lattice.lshape or not torch.isfinite(d).all():
        raise RuntimeError("main-path displacement has a wrong shape or "
                           "non-finite values")
    newton = sum(st["iters"] for st in timed)
    cg = sum(st["lin_iters"] for st in timed)
    log("main", f"{ms:.1f} ms/step over {n_steps} timed steps "
                f"({newton} Newton, {cg} CG iterations in total), "
                f"max|d| {float(d.abs().max()):.4e}, peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("main", f"launches {launches}")
    for k, c in launches.items():
        if c <= 0:
            raise RuntimeError(f"kernel {k} was not launched on the main path")
    return launches


def main():
    smi_line = phase_environment()
    phase_build()
    results = phase_kernels()
    phase_correctness()
    launches = phase_main_path()
    kernels = [{"name": f"lattice_{k}", "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[k], "launches": launches[k],
                "max_abs_err": results[k]["max_abs_err"],
                "ms": results[k]["ms"], "plain_ms": results[k]["plain_ms"]}
               for k in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
