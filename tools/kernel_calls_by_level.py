#!/usr/bin/env python3
"""Count a lattice kernel's calls on a chip_smoke.py path by level and mode,
and time each kind of call on one CUDA GPU.

Usage, from the repository root on a machine with a CUDA device and nvcc:

    python tools/kernel_calls_by_level.py [flagship|jittered]

Runs the path as chip_smoke.py does (n=72, float32: the initial state, one
warm-up and 5 steps) with the wrappers of its most-called kernels wrapped in
counters: B3 ``stencil_matvec`` (GMG levels and the mass) and B2
``neo_tangent`` (the tangent, with the mass in the Krylov operator) on the
flagship, B5 ``neo_tangent_gen`` on the jittered box (the Neo-Hooke tangent
with the mass, and the linear mode of the GMG levels).  Then times one call
of each kind (mode, lattice size) as a CUDA graph of 20 calls on the inputs
it was first called with, and prints launches, time, the bound of
chip_smoke.py and launches x (time - bound).
"""

import collections
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
    path = sys.argv[1] if len(sys.argv) > 1 else "flagship"
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
    total = 0.0
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
        total += excess
        print(f"{attr} {mode:14s} n={n:2d}: {tally[kind]:5d} "
              f"launches, {ms:.4f} ms per call (graph), bound {bound:.5f} ms "
              f"({by}), launches x (time - bound) {excess:.1f} ms",
              flush=True)
    print(f"launches x (time - bound), all: {total:.1f} ms")


if __name__ == "__main__":
    main()
