#!/usr/bin/env python3
"""Count a kernel's calls on a chip_smoke.py path by level and mode, and
time each kind of call on one CUDA GPU.

Usage, from the repository root on a machine with a CUDA device and nvcc:

    python tools/kernel_calls_by_level.py [flagship|jittered|permuted] [--old]

Runs the path as chip_smoke.py does (n=72, or n=56 on the permuted box,
float32: the initial state, one warm-up and 5 steps) with the wrappers of
its kernels wrapped in counters: B3 ``stencil_matvec`` (GMG levels and the
mass), B2 ``neo_tangent`` (the tangent, with the mass in the Krylov
operator) and B1 ``neo_force`` on the flagship; B5 ``neo_tangent_gen`` (the
Neo-Hooke tangent with the mass, and the linear mode of the GMG levels) and
B4 ``neo_force_gen`` (the force, and the mass alone) on the jittered box;
B7 ``hex8_tangent`` and B6 ``hex8_force`` (the force, and the mass alone)
on the permuted box.  Then times one call of each kind (mode, size) as a CUDA
graph of 20 calls on the inputs it was first called with, and prints
launches, time, the bound of chip_smoke.py and launches x (time - bound).
With ``--old`` on the jittered box it also builds tools/b5_variants.cu,
times B5's element pass before the edge form ("old" of
tools/b5_variants.py) on the same inputs, and prints its launches x (time -
bound) on the dense pass's flop count beside the shipped B5's on both
counts.
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
from fourc_tpu_torch.ops import solid_kernels as sk  # noqa: E402
from fourc_tpu_torch.physics import solid as ps  # noqa: E402


def _stencil_kind(K, v):
    return "y = A v", v.shape[1] - 3


def _force_kind(u, G, wdet, lam, mu, model="neohooke"):
    return model, u.shape[1] - 3


def _tangent_kind(u, v, G, wdet, N, lam, mu, model="neohooke", mcoef=0.0):
    return ("neohooke+mass" if mcoef else "neohooke"), v.shape[1] - 3


def _tangent_gen_kind(x, u, v, dN, w, N, lam, mu, model="neohooke",
                      mcoef=0.0):
    mode = ("linear (u=0)" if u is None
            else "neohooke+mass" if mcoef else "neohooke")
    return mode, v.shape[1] - 3


def _force_mode(model, mcoef, stiff):
    return ("mass-only" if not stiff else
            model + "+mass" if mcoef else model)


def _force_gen_kind(x, u, dN, w, N, lam, mu, model="neohooke", mcoef=0.0,
                    stiff=True):
    return _force_mode(model, mcoef, stiff), u.shape[1] - 3


def _elements_per_axis(X24):
    return round(X24.shape[1] ** (1 / 3))


def _solid_force_kind(X24, u24, lam, mu, model="neohooke", mcoef=0.0,
                      stiff=True):
    return _force_mode(model, mcoef, stiff), _elements_per_axis(X24)


def _solid_tangent_kind(X24, u24, v24, lam, mu, model="neohooke", mcoef=0.0):
    return (model + "+mass" if mcoef else model), _elements_per_axis(X24)


# per path and wrapper: its module, its chip_smoke.py kernel key, the kind
# of a call, (mode as chip_smoke.py names its cases, elements per axis), and
# how many leading arguments its bound reads
WRAPPED = {
    "flagship": {"stencil_matvec": (lk, "stencil", _stencil_kind, 2),
                 "neo_tangent": (lk, "tangent", _tangent_kind, 2),
                 "neo_force": (lk, "force", _force_kind, 1)},
    "jittered": {"neo_tangent_gen": (lk, "tangent_gen", _tangent_gen_kind,
                                     3),
                 "neo_force_gen": (lk, "force_gen", _force_gen_kind, 2)},
    "permuted": {"hex8_tangent": (sk, "solid_tangent", _solid_tangent_kind,
                                  3),
                 "hex8_force": (sk, "solid_force", _solid_force_kind, 2)},
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
    orig = {attr: getattr(mod, attr) for attr, (mod, *_) in wrapped.items()}
    tally, first = collections.Counter(), {}

    def counter(attr):
        kind_of = wrapped[attr][2]

        def counted(*args, **kwargs):
            kind = (attr, *kind_of(*args, **kwargs))
            tally[kind] += 1
            if kind not in first:
                first[kind] = (tuple(a.clone() if torch.is_tensor(a) else a
                                     for a in args), dict(kwargs))
            return orig[attr](*args, **kwargs)
        return counted

    for attr, (mod, *_) in wrapped.items():
        setattr(mod, attr, counter(attr))
    f = cs.build_problem(cs.FULL_N[path], "cuda", torch.float32, path)
    cs.reset_launches()
    state = ps.compute_initial_state(f, ps.init_state(f))
    step = cs.make_step(f, path)
    for _ in range(6):
        state, _ = step(state)
    torch.cuda.synchronize()
    for attr, fn in orig.items():
        setattr(wrapped[attr][0], attr, fn)
    print(f"{path} n={cs.FULL_N[path]} launches {cs.launches()}")
    lib = None
    if "--old" in sys.argv[1:]:
        sys.path.insert(0, str(ROOT / "tools"))
        import b5_variants as b5
        lib = b5.build(report=False)
    total = collections.Counter()
    for kind in sorted(tally, key=lambda c: (c[0], c[1], -c[2])):
        attr, mode, n = kind
        _, key, _, n_args = wrapped[attr]
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
        if lib is not None and attr == "neo_tangent_gen":
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
