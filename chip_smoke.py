#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fourc_tpu_torch) on one NVIDIA GPU.

Usage, from the repository root on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and the exit code is 1):

1. environment: GPU name and power limit, torch/CUDA versions, nvcc, triton;
2. build: compiles both sources of fourc_tpu_torch/csrc with nvcc for
   sm_90a, one nvcc process each, started together;
3. kernels: each CUDA kernel against its plain PyTorch twin on the card, at
   n=16 and at its path's full size (B5's linear mode also on the coarse
   GMG levels of the jittered path, n=36, 18 and 9), in float64 (max
   relative error <= 1e-10) and float32 (<= 1e-4), plus kernel and twin
   times at full size in float32.  A kernel's ``ms`` is its device time
   per call from a CUDA graph of 20 calls; ``loop_ms`` is a plain loop of
   20 wrapper calls, which reads the host's time per call where that is
   longer (twins: a plain loop).  B1-B3 run on the uniform box and B4-B5 on the jittered box
   (n=72), B6-B7 on element batches of the permuted box (n=56);
4. correctness: two gen-alpha steps at n=6 in float64 on the GPU (kernels)
   against the same steps on the CPU (twins, which tests/port holds to the
   JAX package), max relative error <= 1e-9, for the flagship, the jittered
   box and the permuted box;
5. flagship path: the flagship problem of bench.py at n=72 (1,167,051
   dofs) in float32 through SolidField / make_step: 1 warm-up and 5 timed
   steps, every step converged, B1-B3 launched;
6. jittered path: bench.py's ``unstructured_1M`` problem (the same box,
   interior nodes jittered by up to +-0.175 h, no generator provenance) the
   same way, B4-B5 launched;
7. permuted path: bench.py's ``permuted_500k`` problem (the jittered box at
   n=56, 555,579 dofs, with its nodes renumbered at random: general
   topology, flat dof vectors, gather and incidence assembly, SA-AMG with
   its setup timed stage by stage) the same way, B6-B7 launched and none of
   B1-B5.

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
import warnings

import numpy as np
import torch

from fourc_tpu_torch import materials
from fourc_tpu_torch.core import cells, conditions, functions, gridgen
from fourc_tpu_torch.materials.elastic import lame
from fourc_tpu_torch.ops import cuda_build
from fourc_tpu_torch.ops import lattice as lat
from fourc_tpu_torch.ops import lattice_kernels as lk
from fourc_tpu_torch.ops import solid as sops
from fourc_tpu_torch.ops import solid_kernels as sk
from fourc_tpu_torch.physics import solid as ps

F64_TOL, F32_TOL, STEP_TOL = 1e-10, 1e-4, 1e-9
# kernel -> (number, JSON name, source, TPU kernel it replaces, its path)
KERNELS = {
    "stencil": ("B3", "lattice_stencil", lk.SOURCE,
                "fourc_tpu/ops/lattice_pallas.py:90", "flagship"),
    "force": ("B1", "lattice_force", lk.SOURCE,
              "fourc_tpu/ops/lattice_pallas.py:164", "flagship"),
    "tangent": ("B2", "lattice_tangent", lk.SOURCE,
                "fourc_tpu/ops/lattice_pallas.py:189", "flagship"),
    "force_gen": ("B4", "lattice_force_gen", lk.SOURCE,
                  "fourc_tpu/ops/lattice_pallas.py:285", "jittered"),
    "tangent_gen": ("B5", "lattice_tangent_gen", lk.SOURCE,
                    "fourc_tpu/ops/lattice_pallas.py:331", "jittered"),
    "solid_force": ("B6", "solid_force", sk.SOURCE,
                    "fourc_tpu/ops/solid_pallas.py:173", "permuted"),
    "solid_tangent": ("B7", "solid_tangent", sk.SOURCE,
                      "fourc_tpu/ops/solid_pallas.py:184", "permuted"),
}
FULL_N = {"flagship": 72, "jittered": 72, "permuted": 56}  # elements per axis
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
# grad, det3 and wdet.  The lattice kernels' gather pass adds 24 adds per
# element; the element-batch kernels B6/B7 have no such pass.
_GP = {"force neohooke": 144 + 63 + 139 + 3 + 45 + 168,
       "force svk": 144 + 63 + 16 + 3 + 45 + 168,
       "tangent neohooke": 2 * 144 + 63 + 117 + 139 + 300 + 3 + 2 * 45 + 9
       + 168}
_GEN = 196 + 45 + 45  # Jacobian, H = Hhat Jinv, P Jinv^T
# B2 works by the 12 edges of an element (tangent_elem_kernel): per Gauss
# point grad_edges 2 x 72 (4 FMAs per entry), the Neo-Hooke tangent in
# deformation-gradient form 234 (tr H 2, tr H^2 18, det3 14, delta 5, lnJ
# 4, F 3, cof3 27, 1 / det F 2, K : Hd 18, two mm 90, coefficients 6, Pd
# 45) and accum_edges 81 (the weight 9, 36 FMAs); per element the edge
# differences 2 x 36, edges_to_nodes 72, the gather's 24 and, with the
# mass, 192 FMAs against the element mass.  No code in the repo computes
# this operator with less, so it bounds B2's first element pass too.
_B2_GP = 144 + 234 + 81
# B5 works by the 12 edges of an element too (tangent_gen_edge_kernel): per
# Gauss point the Jacobian J by grad_edges 72, K = cof(J) 27, det J from K's
# first row 5, 1 / det J 1, Hhat(v) by grad_edges 72, Hd' = Hhat K^T 45,
# Q = Pd K 45, its weight w / det J 10 and accum_edges 72 (349 in all); then
# the tangent: linear 16 (lam tr, 2 mu, 3 diagonal FMAs, 3 symmetric pairs),
# or Neo-Hooke Hhat(u) 72, H = Hhat K^T / det J 54 and tangent_neohooke_F
# 234 (360).  Per element the edge differences 36 per field (x, v and u),
# edges_to_nodes 72, the gather's 24 and, with the mass, 106 per Gauss point
# after the loop (mcoef w det J 2, N . v 48, c N 8, 24 FMAs 48).  No code in
# the repo computes this operator with less, so it bounds B5's first element
# pass too (counted as the dense form: 12,936 flops with the mass, 5,008
# linear).
_B5_GP = 72 + 27 + 5 + 1 + 72 + 45 + 45 + 10 + 72
_B5_LIN, _B5_NEO = _B5_GP + 16, _B5_GP + 72 + 54 + 234
ELEM_FLOPS = {
    ("force", "neohooke"): 8 * _GP["force neohooke"] + 24,
    ("force", "svk"): 8 * _GP["force svk"] + 24,
    ("tangent", "neohooke"): 8 * _B2_GP + 72 + 72 + 24,
    ("tangent", "neohooke+mass"): 8 * _B2_GP + 72 + 72 + 384 + 24,
    ("force_gen", "neohooke"): 8 * (_GP["force neohooke"] + _GEN) + 24,
    ("force_gen", "svk"): 8 * (_GP["force svk"] + _GEN) + 24,
    ("force_gen", "mass-only"): 8 * (144 + 14 + 1 + 106) + 24,
    ("force_gen", "neohooke+mass"): 8 * (_GP["force neohooke"] + _GEN + 106)
    + 24,
    ("tangent_gen", "neohooke"): 8 * _B5_NEO + 3 * 36 + 72 + 24,
    ("tangent_gen", "neohooke+mass"): 8 * (_B5_NEO + 106) + 3 * 36 + 72 + 24,
    ("tangent_gen", "linear (u=0)"): 8 * _B5_LIN + 2 * 36 + 72 + 24,
}
# B6/B7: B4/B5 on an element batch, without the gather pass
for _kind in ("neohooke", "svk", "mass-only", "neohooke+mass"):
    ELEM_FLOPS[("solid_force", _kind)] = ELEM_FLOPS[("force_gen", _kind)] - 24
for _kind in ("neohooke", "neohooke+mass"):
    ELEM_FLOPS[("solid_tangent", _kind)] = \
        ELEM_FLOPS[("tangent_gen", _kind)] - 24


def launches():
    return {**lk.launches, "solid_force": sk.launches["force"],
            "solid_tangent": sk.launches["tangent"]}


def reset_launches():
    lk.reset_launches()
    sk.reset_launches()


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
    paths = cuda_build.build_all()
    log("build", f"{', '.join(p.name for p in paths.values())} in "
                 f"{time.perf_counter() - t0:.1f} s")
    for path in paths.values():
        name = "?"
        for line in path.with_suffix(".log").read_text().splitlines():
            m = re.search(r"Compiling entry function '_ZN5fourc\d+"
                          r"(\w+?_kernel)I([fd])((?:L[bi]\d+E)*)", line)
            if m:
                args = re.findall(r"L[bi](\d+)E", m.group(3))
                flag = ""
                if "tangent" in m.group(1) and args:  # model[, mass]
                    flag = ", " + ("Neo-Hooke", "SVK", "linear")[int(args[0])]
                    if len(args) > 1:
                        flag += ", mass" if args[1] == "1" else ""
                name = (f"{m.group(1)}<"
                        f"{'float' if m.group(2) == 'f' else 'double'}{flag}>")
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


def _time_graph(fn, reps=20, replays=5):
    """Device time (ms) per call: ``reps`` calls captured in one CUDA graph,
    replayed.  A plain loop of wrapper calls reads the host's rate instead
    when the kernel takes less than the wrapper's host time (about 40 us
    per call on the H100 machine)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


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


def permute(disc):
    """bench.py's permuted mesh: the nodes renumbered at random
    (np.random.RandomState(1)) in coordinates, connectivity, node sets and
    face sets, so that no lattice survives in the connectivity."""
    rng = np.random.RandomState(1)
    perm = rng.permutation(disc.n_nodes).astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(disc.n_nodes, dtype=np.int32)
    disc.coords = np.array(disc.coords)[perm]
    for blk in disc.blocks.values():
        blk.conn = inv[blk.conn]
    for nm in disc.node_sets:
        disc.node_sets[nm] = inv[disc.node_sets[nm]]
    for fbs in disc.face_sets.values():
        for fb in fbs:
            fb.conn = inv[fb.conn]
    return disc


def make_mesh(n, mesh):
    """The n^3 box of a path: flagship, jittered or permuted (jittered,
    then renumbered)."""
    disc = gridgen.box(n, n, n)
    if mesh in ("jittered", "permuted"):
        jitter(disc, n)
    if mesh == "permuted":
        permute(disc)
    return disc


def _solid_cases(n, dtype, rng, lam, mu, mcoef):
    """(key, case, kernel, twin, inputs) for B6 and B7 on the element batch
    of the permuted n^3 box."""
    disc = make_mesh(n, "permuted")
    conn = disc.blocks["hex8"].conn

    def batch(nodal):  # (n_nodes, 3) -> (24, E) on the card
        return torch.as_tensor(nodal[conn].reshape(-1, 24).T, dtype=dtype,
                               device="cuda").contiguous()

    X = batch(disc.coords)
    u = batch(rng.normal(size=disc.coords.shape) * 5e-2 / n)
    v = batch(rng.normal(size=disc.coords.shape) / n)
    cases = []
    for case, model, mc, stiff in (("neohooke", "neohooke", 0.0, True),
                                   ("svk", "svk", 0.0, True),
                                   ("mass-only", "svk", 1.0, False),
                                   ("neohooke+mass", "neohooke", mcoef,
                                    True)):
        cases.append((
            "solid_force", case,
            lambda m=model, c=mc, s=stiff: sk.hex8_force(X, u, lam, mu, m,
                                                         c, s),
            lambda m=model, c=mc, s=stiff: sops.hex8_force_ref(X, u, lam, mu,
                                                               m, c, s),
            (X, u)))
    for case, mc in (("neohooke", 0.0), ("neohooke+mass", mcoef)):
        cases.append((
            "solid_tangent", case,
            lambda c=mc: sk.hex8_tangent(X, u, v, lam, mu, "neohooke", c),
            lambda c=mc: sops.hex8_tangent_ref(X, u, v, lam, mu, "neohooke",
                                               c),
            (X, u, v)))
    return cases


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
    disc = make_mesh(n, "jittered")
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


def _level_cases(dtype, rng, cell, lam, mu):
    """(n, kernel, twin, inputs) for B5's linear mode on the coarse GMG
    levels of the jittered path, n = 36, 18 and 9: every second node of the
    level above, coordinates included, as linalg/gmg.py coarsens them.  The
    launcher picks its mapping from the element count, so these are the
    shapes at which each mapping runs on that path."""
    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device="cuda").contiguous()

    full = FULL_N["jittered"]
    coords = np.asarray(make_mesh(full, "jittered").coords).reshape(
        (full + 1,) * 3 + (3,))
    tab = (t(cell.dN), t(cell.gauss_weights), t(cell.N))
    cases = []
    for step in (2, 4, 8):
        n = full // step
        spec = lat.LatticeSpec(pshape=(n + 1,) * 3, h=None)
        x = lat.coord_lattice(coords[::step, ::step, ::step].reshape(-1, 3),
                              spec, dtype, "cuda")
        vl = lat.to_lattice(t(rng.normal(size=spec.ndof) / n), spec)
        cases.append((
            n,
            lambda x=x, vl=vl: lk.neo_tangent_gen(x, None, vl, *tab, lam, mu,
                                                  "svk", mcoef=0.0),
            lambda x=x, vl=vl: lat.neo_jvp_gen_ref(x, None, vl, *tab, lam, mu,
                                                   "svk", mcoef=0.0),
            (x, vl)))
    return cases


def _check(label, n, dtype, tol, kern, twin):
    """Runs a kernel and its twin; raises unless both are finite and agree
    to ``tol`` (max relative error); returns (kernel output, max abs
    error)."""
    got, want = kern(), twin()
    torch.cuda.synchronize()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise RuntimeError(f"{label} n={n}: non-finite output")
    abs_err = float((got - want).abs().max())
    rel = abs_err / float(want.abs().max())
    log("kernels", f"{label:22s} n={n:2d} {str(dtype)[6:]}: "
                   f"max rel err {rel:.3e} (tol {tol:g})")
    if not rel <= tol:
        raise RuntimeError(f"{label} n={n} {dtype}: rel err "
                           f"{rel:.3e} > {tol:g}")
    return got, abs_err


def phase_kernels():
    """Each kernel against its twin; returns per-kernel float32 results at
    the full size of the kernel's path (times and bound of the first case of
    each kernel, the largest error over its cases)."""
    results = {k: {"max_abs_err": 0.0} for k in KERNELS}
    cell = cells.get_cell("hex8")
    lam, mu = lame(1.0e4, 0.3)
    mcoef = 9930.0  # rho (1-am) / ((1-af) beta dt^2) at dt=0.02, rho_inf 0.9
    sizes = ((16, "lattice"), (16, "solid"), (FULL_N["flagship"], "lattice"),
             (FULL_N["permuted"], "solid"))
    for n, group in sizes:
        rng = np.random.default_rng(n)
        for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, F32_TOL)):
            cases = (_kernel_cases(n, dtype, rng, cell, lam, mu, mcoef)
                     if group == "lattice"
                     else _solid_cases(n, dtype, rng, lam, mu, mcoef))
            for key, case, kern, twin, ins in cases:
                label = f"{KERNELS[key][0]} {case}"
                got, abs_err = _check(label, n, dtype, tol, kern, twin)
                if n == 16 or dtype != torch.float32:
                    continue
                r = results[key]
                r["max_abs_err"] = max(r["max_abs_err"], abs_err)
                ms, loop_ms = _time_graph(kern), _time(kern)
                bound, by = _bound(key, case, n, ins + (got,))
                msg = (f"{label:22s} n={n} float32: kernel {ms:.4f} ms "
                       f"(loop {loop_ms:.4f} ms), bound {bound:.4f} ms "
                       f"({by}), roofline share {bound / ms:.1%}")
                if "ms" not in r:
                    r.update(ms=ms, loop_ms=loop_ms,
                             plain_ms=_time(twin, reps=5),
                             bound_ms=bound, bound_by=by,
                             library_ms=None)  # no PyTorch call is exact
                    msg += f", twin {r['plain_ms']:.3f} ms"
                log("kernels", msg)
    rng = np.random.default_rng(FULL_N["jittered"] + 1)
    for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, F32_TOL)):
        for n, kern, twin, ins in _level_cases(dtype, rng, cell, lam, mu):
            label = "B5 linear (u=0), GMG"
            got, abs_err = _check(label, n, dtype, tol, kern, twin)
            if dtype != torch.float32:
                continue
            r = results["tangent_gen"]
            r["max_abs_err"] = max(r["max_abs_err"], abs_err)
            bound, by = _bound("tangent_gen", "linear (u=0)", n, ins + (got,))
            log("kernels", f"{label:22s} n={n} float32: kernel "
                           f"{_time_graph(kern):.4f} ms, bound {bound:.5f} ms "
                           f"({by})")
    return results


def build_problem(n, device, dtype, mesh="flagship"):
    """bench.py's problem (f32 Newton settings for float32) on one of its
    meshes: ``flagship`` (the uniform box), ``jittered`` (its
    ``unstructured_1M`` variant) or ``permuted`` (``permuted_500k``, whose
    ``gmg`` falls back to SA-AMG)."""
    disc = make_mesh(n, mesh)
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


def make_step(f, name):
    """ps.make_step; on the permuted box the ``gmg`` request must warn that
    it falls back to SA-AMG, on the others nothing may warn."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step = ps.make_step(f, dt=0.02)
    msgs = [str(w.message) for w in caught]
    if (name == "permuted") != any("SA-AMG" in m for m in msgs):
        raise RuntimeError(f"{name}: unexpected warnings {msgs}")
    return step


def phase_correctness():
    for name in FULL_N:
        out = {}
        for device in ("cuda", "cpu"):
            f = build_problem(6, device, torch.float64, name)
            state = ps.compute_initial_state(f, ps.init_state(f))
            step = make_step(f, name)
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


def _log_amg(name, M):
    """SA-AMG setup by stage, the levels and the dense coarse factor."""
    log(name, "AMG setup seconds by stage: " + ", ".join(
        f"{k} {v:.2f}" for k, v in M.timings.items()))
    info = M.describe()
    for i, lev in enumerate(info["levels"]):
        log(name, f"AMG level {i}: {lev['nodes']} nodes, ELL widths "
                  + ", ".join(f"{k} {v}" for k, v in lev.items()
                              if k != "nodes"))
    log(name, f"AMG dense coarse factor: {info['coarse_dofs']} dofs, "
              f"{info['coarse_bytes'] / 2**30:.3f} GiB")


def phase_main_path(name, n_steps=5):
    """One path at full size; returns the launches of its run."""
    n = FULL_N[name]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    f = build_problem(n, "cuda", torch.float32, name)
    torch.cuda.synchronize()
    kind = ("general topology" if f.lattice is None else
            "general geometry" if f.x is not None else "uniform geometry")
    log(name, f"n={n}: {f.ndof} dofs, {kind}, field built in "
              f"{time.perf_counter() - t0:.1f} s")
    reset_launches()
    t0 = time.perf_counter()
    state = ps.compute_initial_state(f, ps.init_state(f))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    step = make_step(f, name)
    torch.cuda.synchronize()
    log(name, f"initial state {t1 - t0:.2f} s, "
              f"{'SA-AMG' if f.lattice is None else 'GMG'} setup "
              f"{time.perf_counter() - t1:.2f} s")
    if f.lattice is None:
        _log_amg(name, step.precond)
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
    counts = launches()
    for i, st in enumerate(all_stats):
        log(name, f"step {i}: newton {st['iters']}, cg "
                  f"{st['lin_iters']}, resnorm {st['resnorm']:.4e}, "
                  f"converged {st['converged']}")
        if not (st["converged"] and np.isfinite(st["resnorm"])):
            raise RuntimeError(f"{name} step {i} did not converge")
    d = state["d"]
    shape = (f.ndof,) if f.lattice is None else f.lattice.lshape
    if tuple(d.shape) != shape or not torch.isfinite(d).all():
        raise RuntimeError(f"{name} displacement has a wrong shape or "
                           f"non-finite values")
    newton = sum(st["iters"] for st in timed)
    cg = sum(st["lin_iters"] for st in timed)
    log(name, f"{ms:.1f} ms/step over {n_steps} timed steps "
              f"({newton} Newton, {cg} CG iterations in total), "
              f"max|d| {float(d.abs().max()):.4e}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(name, f"launches {counts}")
    for k, (num, *_, path) in KERNELS.items():
        if (path == name) != (counts[k] > 0):
            raise RuntimeError(
                f"kernel {num} {k} was launched {counts[k]} times on the "
                f"{name} path")
    return counts


def main():
    smi_line = phase_environment()
    phase_build()
    results = phase_kernels()
    phase_correctness()
    counts = {name: phase_main_path(name) for name in FULL_N}
    kernels = [{"name": name, "route": "cuda",
                "source": f"fourc_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": counts[path][k],
                **{f: results[k][f] for f in (
                    "max_abs_err", "ms", "loop_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")}}
               for k, (_, name, source, replaces, path) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
