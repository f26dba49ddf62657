"""GMRES's fixed-order sums on the card against one reduction launch each.

Usage, from the repository root on a machine with one CUDA card:

    python tools/gmres_sums.py

Builds the kernels, runs phase 7 of chip_smoke.py once (bench.py's
permuted box at n=56, whose SA-AMG hierarchy the two paths share), then
runs chip_smoke.py's ``fbar_permuted`` (phase 11) and ``gtn_permuted``
(phase 13) paths four times each, 1 warm-up and 2 timed steps, in the
order tree, one, one, tree: ``tree`` is the port's GMRES, whose products
and norms are ``linalg/solvers.py`` ``tree_sum`` and ``norm_rn`` (log2 n
launches over a copy padded to a power of two, the same bits on every
device); ``one`` swaps those two for ``torch.sum`` and
``torch.linalg.vector_norm`` (one reduction launch each, the card's own
order), Newton's norm with them.  Prints each run's ms/step, Newton and
GMRES iterations, and the step time per GMRES iteration, with the card's
name and power limit.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as c  # noqa: E402
from fourc_tpu_torch.linalg import solvers  # noqa: E402

ORDER = ("tree", "one", "one", "tree")
SUMS = {"tree": (solvers.tree_sum, solvers.norm_rn),
        "one": (lambda x, dim=-1: x.sum(dim), torch.linalg.vector_norm)}


def fbar_run():
    name, changes, newton, _ = next(p for p in c.TECH_PATHS
                                    if p[0] == "fbar_permuted")
    return c.phase_main_path(name, n_steps=2, mesh="permuted",
                             n=c.FULL_N["permuted"], changes=changes,
                             newton=newton, kernels={"solid_force"})


def gtn_run():
    name, law, changes, newton, _ = next(p for p in c.PLASTICITY_PATHS
                                         if p[0] == "gtn_permuted")
    return c.phase_main_path(name, n_steps=2, mesh="permuted",
                             n=c.FULL_N["permuted"], changes=changes,
                             newton=newton,
                             material={k: (1e30 if v is None else v)
                                       for k, v in law.items()},
                             kernels={"solid_force"},
                             prepare=c.prepare_for(name, law))


def main():
    smi = c.phase_environment()
    c.phase_build()
    c.phase_main_path("permuted", n_steps=0)
    rows = []
    for label, run in (("fbar_permuted", fbar_run), ("gtn_permuted",
                                                      gtn_run)):
        for sums in ORDER:
            solvers.tree_sum, solvers.norm_rn = SUMS[sums]
            _, out = run()
            timed = out["steps"][1:]
            newton = sum(s[0] for s in timed)
            krylov = sum(s[1] for s in timed)
            per_it = out["ms"] * len(timed) / max(krylov, 1)
            rows.append(f"{label} {sums}: {out['ms']:.1f} ms/step, {newton} "
                        f"Newton, {krylov} GMRES iterations over "
                        f"{len(timed)} steps, {per_it:.2f} ms of step time "
                        f"per GMRES iteration")
    solvers.tree_sum, solvers.norm_rn = SUMS["tree"]
    print(f"[gmres_sums] card: {smi}")
    for row in rows:
        print(f"[gmres_sums] {row}")


if __name__ == "__main__":
    main()
