"""Where the GPU and CPU runs of decks/solid_timada_pulse.yaml part, float64.

Run from the repository root on a machine with a CUDA device:

    python3 tools/timada_gpu_cpu.py

Prints the relative difference of d between the runs on the card and on the
CPU after every sixth accepted step; the difference of each field operator
(the mass by B6's mass-only pass against its twin, the element route's
force and tangent) at one random state; B6's mass against the element
route's on each device, and against its twin with the element coordinates
moved by -0.5; how far the hex8 table's reference gradients are from
antisymmetric along the element's edges (the twins and the element route
form J = sum_a x_a dN_a, the kernels' edge forms J from edge differences
with dN_b taken for -dN_a, so the two differ by that asymmetry times the
coordinates); and, on the CPU, how much the final d, v and a move when the
mass is scaled by 1 + 1e-15 and 1 + 1e-14 (the deck's amplification of a
change in one operator).
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fourc_tpu_torch.core.cells import get_cell  # noqa: E402
from fourc_tpu_torch.core.mesh import HEX8_OFFSETS  # noqa: E402
from fourc_tpu_torch.io import deck as deck_mod  # noqa: E402
from fourc_tpu_torch.ops import solid as sops  # noqa: E402
from fourc_tpu_torch.ops import solid_kernels as sk  # noqa: E402
from fourc_tpu_torch.physics import driver, structure_driver  # noqa: E402
from fourc_tpu_torch.physics import solid as ps  # noqa: E402

DECK = "decks/solid_timada_pulse.yaml"


def rel(a, b):
    return float((a.cpu() - b.cpu()).abs().max() / b.cpu().abs().max())


def run(device):
    ds = []
    res = driver.run(DECK, device=device, callbacks=[
        lambda name, state, agg: ds.append(state["d"].cpu().clone())])
    return res.states["structure"], ds


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    _, gpu = run("cuda")
    final, cpu = run("cpu")
    for i, (a, b) in enumerate(zip(gpu, cpu)):
        if i % 6 == 0 or i == len(cpu) - 1:
            print(f"step {i}: d max rel err {rel(a, b):.3e}, max|d| "
                  f"{float(b.abs().max()):.3e}")
    deck = deck_mod.load(DECK)
    fields = {dev: structure_driver.build_field(deck, device=dev)
              for dev in ("cuda", "cpu")}
    gen = torch.Generator().manual_seed(0)
    n = fields["cpu"].ndof
    u = torch.randn(n, generator=gen, dtype=torch.float64) * 1e-3
    v = torch.randn(n, generator=gen, dtype=torch.float64)
    ops = {"mass (B6 mass-only on the card, its twin on the CPU)":
           lambda f, u, v: f.mass_matvec(v),
           "force (element route)": lambda f, u, v: f.internal_force(u),
           "tangent with the mass (element route)":
           lambda f, u, v: f.tangent(u, v, 5.8e4)}
    for name, fn in ops.items():
        got = fn(fields["cuda"], u.cuda(), v.cuda())
        print(f"{name}: GPU vs CPU max rel err "
              f"{rel(got, fn(fields['cpu'], u, v)):.3e}")
    for dev, f in fields.items():
        b = f.blocks[0]
        ve = f.dofmap.gather(v.to(dev), b.key)
        route = sops.element_force(b.G, b.wdet, ve, None, mcoef=b.density,
                                   N=b.N, stiff=False)
        print(f"{dev}: element mass, B6 (twin on the CPU) vs the element "
              f"route: max rel err {rel(b.mass(ve), route):.3e}")
    b = fields["cpu"].blocks[0]
    ve = fields["cpu"].dofmap.gather(v, b.key)
    for shift in (0.0, -0.5):
        X = b.X + shift
        twin = sops.hex8_force_ref(X, ve, 0.0, 0.0, "svk", mcoef=1.0,
                                   stiff=False)
        got = sk.hex8_force(X.cuda(), ve.cuda(), 0.0, 0.0, "svk", mcoef=1.0,
                            stiff=False)
        print(f"B6 mass-only vs its twin, coordinates moved by {shift:g}: "
              f"max rel err {rel(got, twin):.3e}")
    dN = np.asarray(get_cell("hex8").dN)
    offs = np.asarray(HEX8_OFFSETS)
    asym = 0.0
    for a in range(8):
        for j in range(3):
            o = offs[a].copy()
            o[j] ^= 1
            b_ = int(np.flatnonzero((offs == o).all(axis=1))[0])
            asym = max(asym, float(np.abs(dN[:, a, j] + dN[:, b_, j]).max()))
    print(f"hex8 table: max |dN_a + dN_b| over the edges {asym:.3e}, max "
          f"|sum_a dN_a| {float(np.abs(dN.sum(axis=1)).max()):.3e}")
    mass = ps.FieldBlock.mass
    try:
        for eps in (1e-15, 1e-14):
            ps.FieldBlock.mass = (lambda self, ve, e=eps:
                                  mass(self, ve) * (1 + e))
            moved = driver.run(DECK, device="cpu").states["structure"]
            print(f"CPU, mass scaled by 1 + {eps:g}: final d / v / a move "
                  + " / ".join(f"{rel(moved[k], final[k]):.3e}"
                               for k in ("d", "v", "a")))
    finally:
        ps.FieldBlock.mass = mass


if __name__ == "__main__":
    main()
