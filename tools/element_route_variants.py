"""Time the element route's 3x3 products on the tet4 cell, on one CUDA GPU.

Usage, from the repository root on a machine with a CUDA device:

    python tools/element_route_variants.py [n]

The element route (fourc_tpu_torch/ops/solid.py ``element_force`` /
``element_tangent``, plain PyTorch) forms its 3x3 products at every Gauss
point with ``ops/common.py`` ``matmul3l`` and ``tmatmul3l``.  Two variants
of those two functions, on the same inputs, in one process:

- ``einsum``: ``torch.einsum`` over the leading axes (the route's first form),
  which PyTorch runs as cuBLAS batched GEMMs of one 3x3 product each;
- ``elementwise``: three broadcast products summed (the shipped form),
  elementwise kernels only.

On chip_smoke.py's tet4 path at size n (default 56: 1,053,696 tet4, the
permuted box split 6 tets per hex, float32), each variant is checked
against the other, then timed in turns (einsum, elementwise, elementwise,
einsum): the force and the tangent with the mass per call (CUDA events, 10
calls each), and two gen-alpha steps of the path from the same state (host
clock around the steps, synchronised), with their Newton and CG counts.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _einsum_mm(a, b):
    return torch.einsum("ik...,kj...->ij...", a, b)


def _einsum_tmm(a, b):
    return torch.einsum("ki...,kj...->ij...", a, b)


def main():
    import chip_smoke as cs
    from fourc_tpu_torch.ops import common as gm
    from fourc_tpu_torch.physics import solid as ps

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    cs.phase_environment()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 56
    variants = {"einsum": (_einsum_mm, _einsum_tmm),
                "elementwise": (gm.matmul3l, gm.tmatmul3l)}

    def use(name):
        gm.matmul3l, gm.tmatmul3l = variants[name]

    f = cs.build_problem(n, "cuda", torch.float32, "permuted", "tet4")
    state0 = ps.compute_initial_state(f, ps.init_state(f))
    step = cs.make_step(f, "tet4")
    state0, _ = step(state0)  # the first step's displacement as input
    torch.cuda.synchronize()
    blk = f.blocks[0]
    u = f.dofmap.gather(state0["d"], blk.key)
    v = f.dofmap.gather(torch.randn_like(state0["d"]), blk.key)
    calls = {"force": lambda: blk.force(u),
             "tangent with the mass": lambda: blk.tangent(u, v, 9930.0)}
    print(f"tet4 n={n}: {blk.X.shape[1]} elements, {f.ndof} dofs, float32")
    outs = {}
    for name in variants:
        use(name)
        outs[name] = [fn() for fn in calls.values()]
    for label, a, b in zip(calls, *outs.values()):
        rel = float((a - b).abs().max() / b.abs().max())
        print(f"{label}: einsum vs elementwise max rel err {rel:.3e}")
        if not rel <= 1e-5:
            raise RuntimeError(f"{label}: the variants disagree")
    for name in ("einsum", "elementwise", "elementwise", "einsum"):
        use(name)
        times = {label: cs._time(fn, reps=10) for label, fn in calls.items()}
        state, counts = state0, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            state, st = step(state)
            counts.append((st["iters"], st["lin_iters"]))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / 2
        print(f"{name:11s}: " + ", ".join(f"{k} {t:.3f} ms"
                                        for k, t in times.items())
              + f"; 2 steps {ms:.1f} ms/step, (Newton, CG) {counts}, "
              f"max|d| {float(state['d'].abs().max()):.6e}")
    use("elementwise")
    print(f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


if __name__ == "__main__":
    main()
