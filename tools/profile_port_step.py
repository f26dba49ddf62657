"""Profile the port's gen-alpha step on one CUDA GPU.

Usage, from the repository root on a machine with a CUDA device:

    python tools/profile_port_step.py [n] [steps] [flagship|jittered]

Builds the flagship problem of chip_smoke.py, or its jittered-box variant
(default n=72, float32, flagship), runs two warm-up steps, then traces ``steps`` steps (default 2) with
torch.profiler.  Prints the device-time table by kernel, the device busy
share (summed kernel time over the host wall time of the traced steps) and
the host time per CG iteration.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from fourc_tpu_torch.physics import solid as ps

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 72
    n_steps = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    mesh = sys.argv[3] if len(sys.argv) > 3 else "flagship"
    if mesh not in ("flagship", "jittered"):
        raise ValueError(f"mesh must be flagship or jittered, not {mesh!r}")
    f = cs.build_problem(n, "cuda", torch.float32,
                         jittered=mesh == "jittered")
    state = ps.compute_initial_state(f, ps.init_state(f))
    step = ps.make_step(f, dt=0.02)
    for _ in range(2):
        state, _ = step(state)
    torch.cuda.synchronize()
    stats = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, st = step(state)
            stats.append(st)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cg = sum(s["lin_iters"] for s in stats)
    newton = sum(s["iters"] for s in stats)
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=25))
    launches = sum(e.count for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"{mesh} n={n}: {n_steps} steps, {newton} Newton, {cg} CG iterations, "
          f"wall {1e3 * wall:.1f} ms (profiler on), device kernel time "
          f"{device_us / 1e3:.1f} ms, busy share "
          f"{device_us / 1e6 / wall:.3f}, {launches} device kernels, "
          f"{1e3 * wall / max(cg, 1):.2f} ms wall per CG iteration")


if __name__ == "__main__":
    main()
