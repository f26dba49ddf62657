"""A deck's Newton and Krylov iterations step by step, the port against the
reference package, on the CPU in float64.

    python tools/newton_steps_vs_reference.py <deck.yaml>

(from the repository root, on a host with the reference's JAX installed).
Runs the deck through the reference's ``driver.run`` and the port's, and
prints per step: the Newton iterations, the Krylov iterations and the last
residual norm of each package, marking the steps whose Newton counts
differ (ROADMAP C8: the steps whose last residual lands next to the deck's
``tolres``).
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _recorder(rows):
    last = [0, 0]

    def callback(_name, _state, agg):
        rows.append((agg["newton_iters"] - last[0],
                     agg["lin_iters"] - last[1], float(agg["resnorm"])))
        last[0], last[1] = agg["newton_iters"], agg["lin_iters"]

    return callback


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from fourc_tpu.physics import driver as reference
    from fourc_tpu_torch.physics import driver as port

    torch.set_num_threads(1)
    deck = sys.argv[1]
    ref, got = [], []
    reference.run(deck, callbacks=[_recorder(ref)])
    port.run(deck, callbacks=[_recorder(got)], device="cpu")
    print("step: reference (Newton, Krylov, last residual) | port")
    for k, (a, b) in enumerate(zip(ref, got)):
        print(f"{k + 1}: {a[0]}, {a[1]}, {a[2]:.6e} | {b[0]}, {b[1]}, "
              f"{b[2]:.6e}{'  <<' if a[0] != b[0] else ''}")
    print(f"total: reference {sum(r[0] for r in ref)} Newton, "
          f"{sum(r[1] for r in ref)} Krylov | port {sum(r[0] for r in got)}"
          f", {sum(r[1] for r in got)}")


if __name__ == "__main__":
    main()
