#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fourc_tpu_torch) on one NVIDIA GPU.

Usage, from the repository root on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and the exit code is 1):

1. environment: GPU name and power limit, torch/CUDA versions, nvcc, triton;
2. build: compiles fourc_tpu_torch/csrc with nvcc for sm_90a;
3. kernels: each CUDA kernel against its plain PyTorch twin on the card, at
   n=16 and n=72, in float64 (max relative error <= 1e-10) and float32
   (<= 1e-4), plus kernel and twin times at n=72 in float32.  B1-B3 run on
   the uniform box, B4-B5 on the jittered box;
4. correctness: two gen-alpha steps at n=6 in float64 on the GPU (kernels)
   against the same steps on the CPU (twins, which tests/port holds to the
   JAX package), max relative error <= 1e-9, for the flagship and for the
   jittered box;
5. flagship path: the flagship problem of bench.py at n=72 (1,167,051
   dofs) in float32 through SolidField / make_step: 1 warm-up and 5 timed
   steps, every step converged, B1-B3 launched;
6. jittered path: bench.py's ``unstructured_1M`` problem (the same box,
   interior nodes jittered by up to +-0.175 h, no generator provenance) the
   same way, B4-B5 launched.

Each path's launch counts are set to 0 just before it and read just after.
The last three lines are a JSON object with per-kernel results (launches on
its path, errors, times, the bound and what sets it), the ``nvidia-smi``
name/power-limit line and ``{"ok": true, "device": ...}``.
"""

import json
import re
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
            "tangent": "fourc_tpu/ops/lattice_pallas.py:189",
            "force_gen": "fourc_tpu/ops/lattice_pallas.py:285",
            "tangent_gen": "fourc_tpu/ops/lattice_pallas.py:331"}
PATH_OF = {"stencil": "flagship", "force": "flagship", "tangent": "flagship",
           "force_gen": "jittered", "tangent_gen": "jittered"}
# H100 SXM peaks (NVIDIA data sheet, at the full 700 W): float32 outside
# the tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# Flops of one element of the element kernels, counted from the kernel
# code with an FMA as 2 and log1p or a division as 1.  Per Gauss point:
# grad 144, strain_A 63, Neo-Hooke stress 139, SVK stress 16, F = I + H 3,
# mm 45, accum 168, strain_A_dual 117, Neo-Hooke dual stress 300, SVK dual
# 16, the Pd sum 9, consistent mass 106; general geometry adds the Jacobian
# (grad 144, cof3 27, det3 14, inverse 10, wdet 1: 196), H = Hhat Jinv (mm
# 45 per gradient) and P Jinv^T (mm 45); the mass-only mode needs only
# grad, det3 and wdet.  The gather pass adds 24 adds per element.
_GP = {"force neohooke": 144 + 63 + 139 + 3 + 45 + 168,
       "force svk": 144 + 63 + 16 + 3 + 45 + 168,
       "tangent neohooke": 2 * 144 + 63 + 117 + 139 + 300 + 3 + 2 * 45 + 9
       + 168}
_GEN = 196 + 45 + 45  # Jacobian, H = Hhat Jinv, P Jinv^T
ELEM_FLOPS = {
    ("force", "neohooke"): 8 * _GP["force neohooke"] + 24,
    ("force", "svk"): 8 * _GP["force svk"] + 24,
    ("tangent", "neohooke"): 8 * _GP["tangent neohooke"] + 24,
    ("tangent", "neohooke+mass"): 8 * (_GP["tangent neohooke"] + 106) + 24,
    ("force_gen", "neohooke"): 8 * (_GP["force neohooke"] + _GEN) + 24,
    ("force_gen", "svk"): 8 * (_GP["force svk"] + _GEN) + 24,
    ("force_gen", "mass-only"): 8 * (144 + 14 + 1 + 106) + 24,
    ("force_gen", "neohooke+mass"): 8 * (_GP["force neohooke"] + _GEN + 106)
    + 24,
    ("tangent_gen", "neohooke"): 8 * (_GP["tangent neohooke"] + _GEN + 45)
    + 24,
    ("tangent_gen", "neohooke+mass"): 8 * (_GP["tangent neohooke"] + _GEN
                                           + 45 + 106) + 24,
    ("tangent_gen", "linear (u=0)"): 8 * (196 + 144 + 45 + 9 + 16 + 45 + 168)
    + 24,
}
NUM = {"force": "B1", "tangent": "B2", "stencil": "B3", "force_gen": "B4",
       "tangent_gen": "B5"}


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
    """Build the kernels; print each kernel's ptxas registers and spills."""
    t0 = time.perf_counter()
    path = lk.build()
    log("build", f"{path.name} in {time.perf_counter() - t0:.1f} s")
    name = "?"
    for line in path.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '_ZN5fourc\d+(\w+?_kernel)"
                      r"I([fd])(Lb([01])E)?", line)
        if m:
            name = (f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}"
                    f"{', linear' if m.group(4) == '1' else ''}>")
        elif "spill stores" in line:
            spills = line.strip()
        elif "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            log("build", f"{name}: {regs} registers, {spills}")


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


def _flops(key, case, n):
    """Flops of one call on a box of n^3 elements.  The stencil: what
    y = A v needs, one 3x3 block (9 FMAs) for each pair of nodes that share
    an element, 3n + 1 such pairs per axis (27 blocks per interior node,
    fewer at the boundary); the element kernels: ELEM_FLOPS per element."""
    if key == "stencil":
        return 18 * (3 * n + 1) ** 3
    return ELEM_FLOPS[(key, case)] * n ** 3


def _bound(key, case, n, tensors):
    """Least time (ms) the card could take: the larger of the bytes that
    must move (each input read once, the output written once) over HBM
    bandwidth and the flops over the float32 peak."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    flops = _flops(key, case, n)
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def jitter(disc, n):
    """bench.py's unstructured mesh: interior nodes moved by up to
    +-0.175 h (np.random.RandomState(0)), no generator provenance."""
    X = np.array(disc.coords)
    rng = np.random.RandomState(0)
    interior = np.all((X > 1e-12) & (X < 1.0 - 1e-12), axis=1)
    X[interior] += (rng.rand(int(interior.sum()), 3) - 0.5) * (0.35 / n)
    disc.coords = X
    disc.structured_shape = None
    return disc


def _kernel_cases(n, dtype, rng, cell, lam, mu, mcoef):
    """(key, case, kernel, twin, inputs) for every kernel at size n: B1-B3
    on the uniform box, B4-B5 on the jittered box; the first case of each
    kernel is the one its JSON entry reports."""
    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device="cuda").contiguous()

    spec = lat.LatticeSpec(pshape=(n + 1,) * 3, h=(1.0 / n,) * 3)
    G, wdet = lat.uniform_geometry(cell, spec)
    B = rng.normal(size=(24, 24))
    K = lat.collapse_stencil(B + B.T)
    # displacements with gradients of order 5e-2
    u = rng.normal(size=spec.ndof) * 5e-2 / n
    v = rng.normal(size=spec.ndof) / n
    ul, vl = lat.to_lattice(t(u), spec), lat.to_lattice(t(v), spec)
    Kt, Gt, wt, Nt = t(K), t(G), t(wdet), t(cell.N)
    cases = [("stencil", "random K", lambda: lk.stencil_matvec(Kt, vl),
              lambda: lat.stencil_matvec_ref(Kt, vl), (Kt, vl))]
    for model in ("neohooke", "svk"):
        cases.append((
            "force", model,
            lambda m=model: lk.neo_force(ul, Gt, wt, lam, mu, m),
            lambda m=model: lat.neo_force_ref(ul, Gt, wt, lam, mu, m),
            (ul,)))
    for case, mc in (("neohooke", 0.0), ("neohooke+mass", mcoef)):
        cases.append((
            "tangent", case,
            lambda c=mc: lk.neo_tangent(ul, vl, Gt, wt, Nt, lam, mu,
                                        "neohooke", c),
            lambda c=mc: lat.neo_jvp_ref(ul, vl, Gt, wt, lam, mu, "neohooke",
                                         N=Nt, mcoef=c),
            (ul, vl)))
    disc = jitter(gridgen.box(n, n, n), n)
    x = lat.coord_lattice(disc.coords, spec, dtype, "cuda")
    tab = (t(cell.dN), t(cell.gauss_weights), Nt)
    for case, model, mc, stiff in (("neohooke", "neohooke", 0.0, True),
                                   ("svk", "svk", 0.0, True),
                                   ("mass-only", "svk", 1.0, False),
                                   ("neohooke+mass", "neohooke", mcoef,
                                    True)):
        cases.append((
            "force_gen", case,
            lambda m=model, c=mc, s=stiff: lk.neo_force_gen(
                x, ul, *tab, lam, mu, m, mcoef=c, stiff=s),
            lambda m=model, c=mc, s=stiff: lat.neo_force_gen_ref(
                x, ul, *tab, lam, mu, m, mcoef=c, stiff=s),
            (x, ul)))
    for case, uu, model, mc in (("neohooke", ul, "neohooke", 0.0),
                                ("neohooke+mass", ul, "neohooke", mcoef),
                                ("linear (u=0)", None, "svk", 0.0)):
        cases.append((
            "tangent_gen", case,
            lambda a=uu, m=model, c=mc: lk.neo_tangent_gen(
                x, a, vl, *tab, lam, mu, m, mcoef=c),
            lambda a=uu, m=model, c=mc: lat.neo_jvp_gen_ref(
                x, a, vl, *tab, lam, mu, m, mcoef=c),
            (x, vl) if uu is None else (x, ul, vl)))
    return cases


def phase_kernels():
    """Each kernel against its twin; returns per-kernel n=72 f32 results
    (times and bound of the first case of each kernel, the largest error
    over its cases)."""
    results = {k: {"max_abs_err": 0.0} for k in REPLACES}
    cell = cells.get_cell("hex8")
    lam, mu = lame(1.0e4, 0.3)
    mcoef = 9930.0  # rho (1-am) / ((1-af) beta dt^2) at dt=0.02, rho_inf 0.9
    for n in (16, 72):
        rng = np.random.default_rng(n)
        for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, F32_TOL)):
            for key, case, kern, twin, ins in _kernel_cases(
                    n, dtype, rng, cell, lam, mu, mcoef):
                label = f"{NUM[key]} {case}"
                got, want = kern(), twin()
                torch.cuda.synchronize()
                if not (torch.isfinite(got).all()
                        and torch.isfinite(want).all()):
                    raise RuntimeError(f"{label} n={n}: non-finite output")
                abs_err = float((got - want).abs().max())
                rel = abs_err / float(want.abs().max())
                log("kernels", f"{label:22s} n={n:2d} {str(dtype)[6:]}: "
                               f"max rel err {rel:.3e} (tol {tol:g})")
                if not rel <= tol:
                    raise RuntimeError(f"{label} n={n} {dtype}: rel err "
                                       f"{rel:.3e} > {tol:g}")
                if n != 72 or dtype != torch.float32:
                    continue
                r = results[key]
                r["max_abs_err"] = max(r["max_abs_err"], abs_err)
                ms = _time(kern)
                bound, by = _bound(key, case, n, ins + (got,))
                msg = (f"{label:22s} n=72 float32: kernel {ms:.4f} ms, bound "
                       f"{bound:.4f} ms ({by}), roofline share "
                       f"{bound / ms:.1%}")
                if "ms" not in r:
                    r.update(ms=ms, plain_ms=_time(twin, reps=5),
                             bound_ms=bound, bound_by=by,
                             library_ms=None)  # no PyTorch call is exact
                    msg += f", twin {r['plain_ms']:.3f} ms"
                log("kernels", msg)
    return results


def build_problem(n, device, dtype, jittered=False):
    """bench.py's flagship problem (f32 Newton settings for float32); with
    ``jittered``, its ``unstructured_1M`` variant on the jittered box."""
    disc = gridgen.box(n, n, n)
    if jittered:
        jitter(disc, n)
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
    for jittered in (False, True):
        name = "jittered" if jittered else "flagship"
        out = {}
        for device in ("cuda", "cpu"):
            f = build_problem(6, device, torch.float64, jittered)
            state = ps.compute_initial_state(f, ps.init_state(f))
            step = ps.make_step(f, dt=0.02)
            for _ in range(2):
                state, stats = step(state)
                if not stats["converged"]:
                    raise RuntimeError(f"{name} n=6 {device} step did not "
                                       f"converge")
            out[device] = state
        for k in ("d", "v", "a"):
            got, want = out["cuda"][k].cpu(), out["cpu"][k]
            rel = float((got - want).abs().max() / want.abs().max())
            log("check", f"{name} n=6 float64 two steps, GPU kernels vs CPU "
                         f"twins: {k} max rel err {rel:.3e} "
                         f"(tol {STEP_TOL:g})")
            if not rel <= STEP_TOL:
                raise RuntimeError(f"{name}: GPU step disagrees with the CPU "
                                   f"step on {k}")


def phase_main_path(name, n=72, n_steps=5):
    """One path at full size; returns the launches of its run."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    f = build_problem(n, "cuda", torch.float32, jittered=name == "jittered")
    torch.cuda.synchronize()
    log(name, f"n={n}: {f.ndof} dofs, "
              f"{'general' if f.x is not None else 'uniform'} geometry, "
              f"field built in {time.perf_counter() - t0:.1f} s")
    lk.reset_launches()
    t0 = time.perf_counter()
    state = ps.compute_initial_state(f, ps.init_state(f))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    step = ps.make_step(f, dt=0.02)
    torch.cuda.synchronize()
    log(name, f"initial state {t1 - t0:.2f} s, GMG setup "
              f"{time.perf_counter() - t1:.2f} s")
    t0 = time.perf_counter()
    state, stats = step(state)
    torch.cuda.synchronize()
    log(name, f"warm-up step {1e3 * (time.perf_counter() - t0):.1f} ms: "
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
        log(name, f"step {i}: newton {st['iters']}, cg "
                  f"{st['lin_iters']}, resnorm {st['resnorm']:.4e}, "
                  f"converged {st['converged']}")
        if not (st["converged"] and np.isfinite(st["resnorm"])):
            raise RuntimeError(f"{name} step {i} did not converge")
    d = state["d"]
    if tuple(d.shape) != f.lattice.lshape or not torch.isfinite(d).all():
        raise RuntimeError(f"{name} displacement has a wrong shape or "
                           f"non-finite values")
    newton = sum(st["iters"] for st in timed)
    cg = sum(st["lin_iters"] for st in timed)
    log(name, f"{ms:.1f} ms/step over {n_steps} timed steps "
              f"({newton} Newton, {cg} CG iterations in total), "
              f"max|d| {float(d.abs().max()):.4e}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(name, f"launches {launches}")
    for k, path in PATH_OF.items():
        if path == name and launches[k] <= 0:
            raise RuntimeError(f"kernel {k} was not launched on the {name} "
                               f"path")
    return launches


def main():
    smi_line = phase_environment()
    phase_build()
    results = phase_kernels()
    phase_correctness()
    launches = {name: phase_main_path(name)
                for name in ("flagship", "jittered")}
    kernels = [{"name": f"lattice_{k}", "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[k],
                "launches": launches[PATH_OF[k]][k],
                **{f: results[k][f] for f in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}}
               for k in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
