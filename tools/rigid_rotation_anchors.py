"""The GTN and Lemaitre decks' anchors and their free rigid rotation.

Usage, from the repository root on the CPU:

    python tools/rigid_rotation_anchors.py [--reference]

Runs decks/gtn_voided_tension.yaml and decks/lemaitre_damage_bar.yaml
through the port's CLI (``--device cpu``) and prints each anchor and the
sum of the two that a rotation about the z axis moves (node 24 dispx, -w y
there, and the dispy at x = 1, y = 0, w x there), which the rotation
leaves.  With ``--reference`` it also runs the JAX package's CLI
(``python -m fourc_tpu.app.main``, in a subprocess) on each deck as
written and with E one ulp above and below 1000 (copies under
build/rigid_rotation/): the rotated anchors move with the rounding of the
singular solve, their sum does not.
"""

import os
import subprocess
import sys

import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from fourc_tpu_torch.io.result_test import read_node_lines  # noqa: E402

# the decks that hold no rigid rotation about the z axis (node 1 lies on
# it): their stiffness is singular, and the rounding of the reference's
# singular LU sets the rotation in their x- and y-anchors.  Deck -> the
# anchors (node, quantity) that a rotation w moves by -w y and w x, whose
# sum it leaves (tests/port/test_torch_plasticity.py and chip_smoke.py
# read this table)
ROTATION_FREE = {"decks/gtn_voided_tension.yaml": ((24, "dispx"),
                                                   (19, "dispy")),
                 "decks/lemaitre_damage_bar.yaml": ((24, "dispx"),
                                                    (18, "dispy"))}
ULPS = {"as written": 1000.0, "E + 1 ulp": 1000.0000000000001,
        "E - 1 ulp": 999.9999999999999}


def run(cmd):
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return read_node_lines(out.stdout)


def report(label, lines, pair):
    got = sum(lines[k][0] for k in pair)
    want = sum(lines[k][1] for k in pair)
    print(f"  {label}: " + ", ".join(
        f"node {n} {q} {lines[(n, q)][0]!r}" for n, q in pair)
          + f"; sum {got!r} (the anchors' {want!r}, off by "
            f"{abs(got - want):.3e})")


def main():
    reference = "--reference" in sys.argv[1:]
    for path, pair in ROTATION_FREE.items():
        name = os.path.splitext(os.path.basename(path))[0]
        print(f"{path}: anchors " + ", ".join(
            f"node {n} {q}" for n, q in pair) + " (rotated) and dispz")
        report("port (CPU)", run([sys.executable, "-m",
                                  "fourc_tpu_torch.app.main", path,
                                  "--device", "cpu"]), pair)
        if not reference:
            continue
        with open(os.path.join(ROOT, path)) as fh:
            data = yaml.safe_load(fh)
        out_dir = os.path.join(ROOT, "build", "rigid_rotation")
        os.makedirs(out_dir, exist_ok=True)
        for i, (label, youngs) in enumerate(ULPS.items()):
            data["materials"][1]["youngs"] = youngs
            copy = os.path.join(out_dir, f"{name}_{i}.yaml")
            with open(copy, "w") as fh:
                yaml.safe_dump(data, fh)
            report(f"reference, {label}",
                   run([sys.executable, "-m", "fourc_tpu.app.main", copy,
                        "--platform", "cpu"]), pair)


if __name__ == "__main__":
    main()
