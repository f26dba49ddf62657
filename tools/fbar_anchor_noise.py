"""The float64 noise floor of the 4C-converted F-bar deck's stress anchors.

Runs decks/ref_converted/solid_ele_hex8_standard_fbar.yaml through
``driver.run`` on the CPU, unperturbed and then ``N`` times with every
internal force multiplied entry by entry by 1 + k 2^-53, k drawn from
{-1, 0, 1} with a seeded generator (half an ulp of noise, the size of the
rounding differences between two devices), and prints each run's nodal
stress_xx at node 4 minus 4C's verbatim value against the deck's 1e-12
tolerance, with one more Newton iteration from the unperturbed converged
state for comparison.

    python tools/fbar_anchor_noise.py [N]
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fourc_tpu_torch.linalg import solvers  # noqa: E402
from fourc_tpu_torch.physics import driver, solid as ps  # noqa: E402

DECK = "decks/ref_converted/solid_ele_hex8_standard_fbar.yaml"
WANT = 24.66368771114965  # node 4 stress_xx, 4C, tolerance 1e-12


def run():
    res = driver.run(DECK, device="cpu")
    state = res.states["structure"]
    return res.fields["structure"].f, state["d"], float(state["t"])


def main(n):
    torch.set_num_threads(1)
    f, d, t = run()
    base = float(f.nodal_stresses(d)[4, 0, 0]) - WANT
    r = torch.where(f.free, f.internal_force(d) - f.external_force(t), 0.0)

    def op(v):
        vm = torch.where(f.free, v, 0.0)
        return torch.where(f.free, f.tangent(d, vm), v)

    du = solvers.direct(op, -r, batched=True).x
    extra = float(f.nodal_stresses(d + torch.where(f.free, du, 0.0))[4, 0, 0])
    print(f"unperturbed: {base:+.3e}; one more Newton iteration (|du| "
          f"{float(du.norm()):.1e}): {extra - WANT:+.3e}")
    plain = ps.SolidField.internal_force
    out = []
    for seed in range(n):
        rng = np.random.default_rng(seed)

        def noisy(self, u, rng=rng):
            fi = plain(self, u)
            k = torch.as_tensor(rng.integers(-1, 2, size=fi.shape),
                                dtype=fi.dtype)
            return fi * (1 + 2.0 ** -53 * k)

        ps.SolidField.internal_force = noisy
        try:
            fn, dn, _ = run()
        finally:
            ps.SolidField.internal_force = plain
        out.append(float(fn.nodal_stresses(dn)[4, 0, 0]) - WANT)
    out = np.array(out)
    print(f"{n} runs with half-ulp noise in f_int: "
          + ", ".join(f"{x:+.3e}" for x in out))
    print(f"mean {out.mean():+.3e}, std {out.std():.3e}; within the 1e-12 "
          f"tolerance: {(np.abs(out) <= 1e-12).sum()} of {n}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 12)
