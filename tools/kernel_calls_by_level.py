#!/usr/bin/env python3
"""Count a lattice kernel's calls on a chip_smoke.py path by level and mode,
and time each kind of call on one CUDA GPU.

Usage, from the repository root on a machine with a CUDA device and nvcc:

    python tools/kernel_calls_by_level.py [flagship|jittered]

Runs the path as chip_smoke.py does (n=72, float32: the initial state, one
warm-up and 5 steps) with the wrapper of its most-called kernel wrapped in
a counter: B3 ``stencil_matvec`` on the flagship (GMG levels and the mass),
B5 ``neo_tangent_gen`` on the jittered box (the Neo-Hooke tangent with the
mass, and the linear mode of the GMG levels).  Then times one call of each
kind (mode, lattice size) as a CUDA graph of 20 calls on the inputs it was
first called with, and prints launches, time, the bound of chip_smoke.py and
launches x (time - bound).
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


def _tangent_gen_kind(x, u, v, dN, w, N, lam, mu, model="neohooke",
                      mcoef=0.0):
    mode = ("linear (u=0)" if u is None
            else "neohooke+mass" if mcoef else "neohooke")
    return mode, v.shape[1] - 3


# per path: the wrapper, its chip_smoke.py kernel key, and the kind of a
# call, (mode as chip_smoke.py names its cases, elements per axis)
WRAPPED = {
    "flagship": ("stencil_matvec", "stencil", _stencil_kind),
    "jittered": ("neo_tangent_gen", "tangent_gen", _tangent_gen_kind),
}


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    path = sys.argv[1] if len(sys.argv) > 1 else "flagship"
    attr, key, kind_of = WRAPPED[path]
    orig = getattr(lk, attr)
    tally, first = collections.Counter(), {}

    def counted(*args, **kwargs):
        kind = kind_of(*args, **kwargs)
        tally[kind] += 1
        if kind not in first:
            first[kind] = (tuple(a.clone() if torch.is_tensor(a) else a
                                 for a in args), dict(kwargs))
        return orig(*args, **kwargs)

    setattr(lk, attr, counted)
    f = cs.build_problem(cs.FULL_N[path], "cuda", torch.float32, path)
    cs.reset_launches()
    state = ps.compute_initial_state(f, ps.init_state(f))
    step = cs.make_step(f, path)
    for _ in range(6):
        state, _ = step(state)
    torch.cuda.synchronize()
    setattr(lk, attr, orig)
    print(f"{path} n={cs.FULL_N[path]} launches {cs.launches()}")
    total = 0.0
    for kind in sorted(tally, key=lambda c: (c[0], -c[1])):
        args, kwargs = first[kind]
        out = orig(*args, **kwargs)
        ms = cs._time_graph(lambda a=args, k=kwargs: orig(*a, **k))
        tensors = tuple(a for a in args[:3] if torch.is_tensor(a))
        bound, by = cs._bound(key, kind[0], kind[1], tensors + (out,))
        excess = tally[kind] * (ms - bound)
        total += excess
        print(f"{attr} {kind[0]:14s} n={kind[1]:2d}: {tally[kind]:5d} "
              f"launches, {ms:.4f} ms per call (graph), bound {bound:.5f} ms "
              f"({by}), launches x (time - bound) {excess:.1f} ms",
              flush=True)
    print(f"launches x (time - bound), all: {total:.1f} ms")


if __name__ == "__main__":
    main()
