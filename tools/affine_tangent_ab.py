"""The element route's tangent of a law affine in the strain: its
``pk2_from_E`` at the increment against forward mode, on whole decks.

    python3 tools/affine_tangent_ab.py [--device cpu|cuda] [deck ...]

(the repository root on the path; default decks: the two TSI bars, whose
thermo-elastic SVK takes the element route; default device: the card).
Runs each deck through ``driver.run`` four times, affine, forward mode,
forward mode, affine (``Material.affine_in_strain`` switched off on every
law that sets it), and prints the wall time of each run, its Newton and
Krylov counts, and whether the final states of the two derivatives are
equal to the bit.
"""

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fourc_tpu_torch.materials.base import MATERIAL_REGISTRY  # noqa: E402
from fourc_tpu_torch.physics import driver  # noqa: E402

DECKS = ("decks/tsi_heated_bar.yaml", "decks/tsi_partitioned_bar.yaml")
AFFINE = [cls for cls in MATERIAL_REGISTRY.values()
          if getattr(cls, "affine_in_strain", False)]


def _run(deck, device, affine):
    for cls in AFFINE:
        cls.affine_in_strain = affine
    final = {}
    try:
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = driver.run(deck, device=device, callbacks=[
            lambda _, st, __: final.update(
                {k: v.clone() for k, v in st.items() if torch.is_tensor(v)})])
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for cls in AFFINE:
            cls.affine_in_strain = True
    agg = res.stats[next(iter(res.stats))]
    return wall, agg["newton_iters"], agg["lin_iters"], final


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("decks", nargs="*", default=DECKS)
    args = ap.parse_args()
    print("laws affine in the strain:", [c.deck_name for c in AFFINE])
    for deck in args.decks:
        runs = [(mode, _run(deck, args.device, mode == "affine"))
                for mode in ("affine", "forward", "forward", "affine")]
        for mode, (wall, newton, krylov, _) in runs:
            print(f"{deck} {args.device} {mode}: {wall:.3f} s, newton "
                  f"{newton}, krylov {krylov}")
        a, f = runs[0][1][3], runs[1][1][3]
        same = all(torch.equal(a[k], f[k]) for k in a)
        best = {m: min(r[0] for mm, r in runs if mm == m)
                for m in ("affine", "forward")}
        print(f"{deck} {args.device}: final states equal to the bit: {same};"
              f" best of two, affine {best['affine']:.3f} s, forward mode "
              f"{best['forward']:.3f} s")


if __name__ == "__main__":
    main()
