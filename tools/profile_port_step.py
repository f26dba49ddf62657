"""Profile the port's gen-alpha step on one CUDA GPU.

Usage, from the repository root on a machine with a CUDA device:

    python tools/profile_port_step.py [n] [steps] [mesh]

Builds the flagship problem of chip_smoke.py on one of its meshes,
flagship, jittered, permuted or tet4 (default n=72, float32, flagship; the
permuted box's full size is n=56; ``tet4`` is the permuted box split into
6 tet4 per hex, chip_smoke.py phase 9 (c); ``explicit`` is the flagship
box under explicit central differences, chip_smoke.py phase 10 (d);
``fbar`` and ``eas`` the permuted box under F-bar with GMRES(50) and
under EAS with CG, chip_smoke.py phase 11 (b), (c); ``visco``, ``j2`` and
``lognh`` the permuted box under the history laws of chip_smoke.py phase
12 (b)-(d), ``gtn`` and ``crystal`` under those of phase 13 (b), (c), the
plastic ones after its elastic step that sets the yield stress or the
slip resistance, ``growthremodel``, ``mixture`` and ``blemker`` under
those of phase 14 (b)-(d); ``tsi`` the monolithic TSI box of
chip_smoke.py phase 15 (b), its step from ``tsi_driver.make_step``;
``cavity`` the 3D lid-driven cavity ``cavity3d_ost`` of chip_smoke.py
phase 16 (b), full size n=64, its step from ``fluid.make_step``), runs
two warm-up steps, then traces ``steps`` steps (default 2) with
torch.profiler.  Prints the device-time table by kernel, the device busy
share (summed kernel time over the host wall time of the traced steps) and
the host time per CG iteration; then runs ``steps`` more steps under
cProfile and prints the host functions that took the most time.
"""

import cProfile
import pstats

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
    meshes = {**{m: (m, "hex8") for m in cs.FULL_N},
              "tet4": ("permuted", "tet4"),
              **{name.split("_")[0]: ("permuted", "hex8", changes, newton)
                 for name, changes, newton, _ in cs.TECH_PATHS
                 if name.endswith("_permuted")},
              **{name.split("_")[0]: ("permuted", "hex8", changes, newton, {
                  k: (1e30 if v is None else v) for k, v in law.items()})
                 for name, law, changes, newton, _ in (
                     cs.HISTORY_PATHS + cs.PLASTICITY_PATHS
                     + cs.BIOLOGY_PATHS)}}
    laws = {name.split("_")[0]: law for name, law, *_ in (
        cs.HISTORY_PATHS + cs.PLASTICITY_PATHS + cs.BIOLOGY_PATHS)}
    if mesh == "explicit":
        f, step, _, dt = cs.explicit_problem(n)
        print(f"explicit n={n}: dt {dt:.4e}")
    elif mesh == "tsi":
        from fourc_tpu_torch.physics import tsi_driver as td

        f = cs.tsi_problem(n, "cuda", torch.float32, n_steps=2 * n_steps + 2)
        step = td.make_step(f, cs.TSI_DT)
    elif mesh == "cavity":
        from fourc_tpu_torch.physics import fluid as pf

        f = cs.cavity3d_problem(n, "cuda", torch.float32)
        step = pf.make_step(f, cs.CAVITY_DT)
    elif mesh in meshes:
        f = cs.build_problem(n, "cuda", torch.float32, *meshes[mesh])
        prepare = cs.prepare_for(mesh, laws[mesh]) if mesh in laws else None
        if prepare is not None:
            prepare(f)
        step = cs.make_step(f, mesh)
    else:
        raise ValueError(f"mesh must be one of "
                         f"{list(meshes) + ['explicit', 'tsi', 'cavity']}, not "
                         f"{mesh!r}")
    if mesh == "tsi":
        state = td.init_state(f)
    elif mesh == "cavity":
        state = pf.init_state(f)
    else:
        state = ps.compute_initial_state(f, ps.init_state(f))
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
                                    row_limit=25, max_name_column_width=90))
    launches = sum(e.count for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"{mesh} n={n}: {n_steps} steps, {newton} Newton, {cg} CG "
          f"iterations, "
          f"wall {1e3 * wall:.1f} ms (profiler on), device kernel time "
          f"{device_us / 1e3:.1f} ms, busy share "
          f"{device_us / 1e6 / wall:.3f}, {launches} device kernels, "
          f"{1e3 * wall / max(cg, 1):.2f} ms wall per CG iteration")
    host = cProfile.Profile()
    host.enable()
    for _ in range(n_steps):
        state, _ = step(state)
    torch.cuda.synchronize()
    host.disable()
    pstats.Stats(host).sort_stats("tottime").print_stats(15)


if __name__ == "__main__":
    main()
