#!/usr/bin/env python3
"""Count a lattice kernel's calls on a chip_smoke.py path by level and mode,
and time each kind of call on one CUDA GPU.

Usage, from the repository root on a machine with a CUDA device and nvcc:

    python tools/kernel_calls_by_level.py [flagship|jittered] [--old]

Runs the path as chip_smoke.py does (n=72, float32: the initial state, one
warm-up and 5 steps) with the wrappers of its most-called kernels wrapped in
counters: B3 ``stencil_matvec`` (GMG levels and the mass) and B2
``neo_tangent`` (the tangent, with the mass in the Krylov operator) on the
flagship, B5 ``neo_tangent_gen`` on the jittered box (the Neo-Hooke tangent
with the mass, and the linear mode of the GMG levels).  Then times one call
of each kind (mode, lattice size) as a CUDA graph of 20 calls on the inputs
it was first called with, and prints launches, time, the bound of
chip_smoke.py and launches x (time - bound).  With ``--old`` on the
jittered box it also builds tools/b5_variants.cu, times B5's element pass
before the edge form ("old" of tools/b5_variants.py) on the same inputs,
and prints its launches x (time - bound) on the dense pass's flop count
beside the shipped B5's on both counts.
"""

import collections
import inspect
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from fourc_tpu_torch.ops import lattice_kernels as lk  # noqa: E402
from fourc_tpu_torch.physics import solid as ps  # noqa: E402


def _stencil_kind(K, v):
    return "y = A v", v.shape[1] - 3


def _tangent_kind(u, v, G, wdet, N, lam, mu, model="neohooke", mcoef=0.0):
    return ("neohooke+mass" if mcoef else "neohooke"), v.shape[1] - 3


def _tangent_gen_kind(x, u, v, dN, w, N, lam, mu, model="neohooke",
                      mcoef=0.0):
    mode = ("linear (u=0)" if u is None
            else "neohooke+mass" if mcoef else "neohooke")
    return mode, v.shape[1] - 3


# per path and wrapper: its chip_smoke.py kernel key, the kind of a call,
# (mode as chip_smoke.py names its cases, elements per axis), and how many
# leading arguments its bound reads
WRAPPED = {
    "flagship": {"stencil_matvec": ("stencil", _stencil_kind, 2),
                 "neo_tangent": ("tangent", _tangent_kind, 2)},
    "jittered": {"neo_tangent_gen": ("tangent_gen", _tangent_gen_kind, 3)},
}


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [a for a in sys.argv[1:] if a != "--old"]
    path = args[0] if args else "flagship"
    if "--old" in sys.argv[1:] and path != "jittered":
        sys.exit("--old compares B5 on the jittered path only")
    wrapped = WRAPPED[path]
    orig = {attr: getattr(lk, attr) for attr in wrapped}
    tally, first = collections.Counter(), {}

    def counter(attr):
        kind_of = wrapped[attr][1]

        def counted(*args, **kwargs):
            kind = (attr, *kind_of(*args, **kwargs))
            tally[kind] += 1
            if kind not in first:
                first[kind] = (tuple(a.clone() if torch.is_tensor(a) else a
                                     for a in args), dict(kwargs))
            return orig[attr](*args, **kwargs)
        return counted

    for attr in wrapped:
        setattr(lk, attr, counter(attr))
    f = cs.build_problem(cs.FULL_N[path], "cuda", torch.float32, path)
    cs.reset_launches()
    state = ps.compute_initial_state(f, ps.init_state(f))
    step = cs.make_step(f, path)
    for _ in range(6):
        state, _ = step(state)
    torch.cuda.synchronize()
    for attr, fn in orig.items():
        setattr(lk, attr, fn)
    print(f"{path} n={cs.FULL_N[path]} launches {cs.launches()}")
    lib = None
    if "--old" in sys.argv[1:]:
        sys.path.insert(0, str(ROOT / "tools"))
        import b5_variants as b5
        lib = b5.build(report=False)
    total = collections.Counter()
    for kind in sorted(tally, key=lambda c: (c[0], c[1], -c[2])):
        attr, mode, n = kind
        key, _, n_args = wrapped[attr]
        args, kwargs = first[kind]
        fn = orig[attr]
        out = fn(*args, **kwargs)
        ms = cs._time_graph(lambda a=args, k=kwargs: fn(*a, **k))
        tensors = tuple(a for a in args[:n_args] if torch.is_tensor(a))
        bound, by = cs._bound(key, mode, n, tensors + (out,))
        excess = tally[kind] * (ms - bound)
        total["new"] += excess
        msg = (f"{attr} {mode:14s} n={n:2d}: {tally[kind]:5d} "
               f"launches, {ms:.4f} ms per call (graph), bound {bound:.5f} ms "
               f"({by}), launches x (time - bound) {excess:.1f} ms")
        if lib is not None:
            a = inspect.signature(fn).bind(*args, **kwargs)
            a.apply_defaults()
            a = a.arguments
            old = cs._time_graph(b5.launcher(
                lib, "old", "full", a["x"], a["u"], a["v"],
                (a["dN"], a["w"], a["N"]), a["lam"], a["mu"], a["model"],
                a["mcoef"]))
            old_bound = b5.old_bound(mode, n, tensors + (out,))
            total["on the dense count's bound"] += \
                tally[kind] * (ms - old_bound)
            total["old on the dense count's bound"] += \
                tally[kind] * (old - old_bound)
            msg += (f"; on the dense count's bound {old_bound:.5f} ms: "
                    f"{tally[kind] * (ms - old_bound):.1f} ms; the old "
                    f"element pass {old:.4f} ms, "
                    f"{tally[kind] * (old - old_bound):.1f} ms")
        print(msg, flush=True)
    print("launches x (time - bound), all: " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in total.items()))


if __name__ == "__main__":
    main()
