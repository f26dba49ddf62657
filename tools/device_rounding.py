"""Which operations of the element route round differently on the card
and on the CPU.

    python3 tools/device_rounding.py

(on a machine with a CUDA device; the repository root on the path).  On
seeded float64 inputs, each operation runs on the CPU and on the card;
prints the share of entries that differ and the largest relative
difference: the elementwise operators, the 3x3 helpers of ops/common.py,
the correctly rounded square root and the square root and logarithm of
plasticity.py, the two plastic laws'
return maps, a history deck's internal force and tangent, the incidence
assembly, and the host LU of one matrix at two memory offsets.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fourc_tpu_torch.io import deck as deck_mod  # noqa: E402
from fourc_tpu_torch.materials import make_material  # noqa: E402
from fourc_tpu_torch.materials import plasticity  # noqa: E402
from fourc_tpu_torch.ops import common as gm  # noqa: E402
from fourc_tpu_torch.physics import solid as ps  # noqa: E402
from fourc_tpu_torch.physics import structure_driver as sd  # noqa: E402

N = 200_000


def report(name, fn, *args):
    """fn(*args) on the CPU and on the card (tensors moved), compared."""
    def move(x, dev):
        if isinstance(x, dict):
            return {k: move(v, dev) for k, v in x.items()}
        return x.to(dev) if torch.is_tensor(x) else x

    got = [fn(*[move(a, dev) for a in args]) for dev in ("cpu", "cuda")]
    c, g = got
    if isinstance(c, tuple):
        c, g = c[0], g[0]
    g = g.cpu()
    differ = (c != g) & ~(torch.isnan(c) & torch.isnan(g))
    rel = float(((c - g).abs() / c.abs().clamp(min=1e-300)).max())
    print(f"{name:42s} {float(differ.double().mean()):9.2e} of "
          f"{c.numel():>9d} entries differ, max rel {rel:.2e}", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.uniform(0.5, 2.0, N))
    b = torch.as_tensor(rng.uniform(0.5, 2.0, N))
    print("operation                                  share differing")
    report("a * b", torch.mul, a, b)
    report("a + b", torch.add, a, b)
    report("a - b", torch.sub, a, b)
    report("a / b", torch.div, a, b)
    report("a / 3.0", lambda x: x / 3.0, a)
    report("a * (1 / 3)", lambda x: x * (1.0 / 3.0), a)
    report("sqrt(a)", torch.sqrt, a)
    report("sqrt_rn(a)", gm.sqrt_rn, a)
    report("log1p(a)", torch.log1p, a)
    report("expm1(a)", torch.expm1, a)
    report("exp(a)", torch.exp, a)
    M = torch.as_tensor(np.eye(3)[:, :, None]
                        + rng.normal(size=(3, 3, N)) * 0.2)
    C = gm.tmatmul3l(M, M)
    report("det3l", gm.det3l, M)
    report("inv3l", gm.inv3l, M)
    report("matmul3l", gm.matmul3l, M, M)
    report("sqrtm_db", plasticity.sqrtm_db, C)
    report("logm_spd", plasticity.logm_spd, C)
    j2 = make_material({"type": "plasticlinelast", "youngs": 1000.0,
                        "nue": 0.3, "yield_stress": 5.0, "isohard": 50.0,
                        "kinhard": 30.0})
    eps = 0.5 * (M - gm.eye3l(M)) * 0.05
    eps = 0.5 * (eps + eps.transpose(0, 1))
    h = torch.zeros((19, N), dtype=torch.float64)
    report("plasticlinelast stress", j2.evaluate_small, eps, h)
    report("plasticlinelast history", lambda e, hh: j2.evaluate_small(
        e, hh)[1], eps, h)
    ln = make_material({"type": "plasticnlnlogneohooke", "youngs": 1000.0,
                        "nue": 0.3, "yield_stress": 10.0, "isohard": 50.0})
    report("plasticnlnlogneohooke stress", ln.evaluate, C,
           torch.zeros((7, N), dtype=torch.float64))
    for path in ("decks/solid_j2_cyclic.yaml",
                 "decks/plasticity_lognh_torsion.yaml"):
        deck = deck_mod.load(path)
        fields = {dev: sd.build_field(deck, device=dev)
                  for dev in ("cpu", "cuda")}
        f = fields["cpu"]
        u = torch.as_tensor(rng.normal(size=f.ndof) * 0.01)
        v = torch.as_tensor(rng.normal(size=f.ndof))
        hist = ps.init_state(f)["hist"]
        name = os.path.basename(path)

        def force(uu, hh, _f=fields):
            fd = _f["cuda" if uu.is_cuda else "cpu"]
            return fd.internal_force(uu, hh, 0.1)

        def tangent(uu, vv, hh, _f=fields):
            fd = _f["cuda" if uu.is_cuda else "cpu"]
            return fd.tangent(uu, vv, 0.0, hh, 0.1)

        def assembly(uu, _f=fields):
            fd = _f["cuda" if uu.is_cuda else "cpu"]
            blk = fd.blocks[0]
            return fd.dofmap.scatter_add(
                {blk.key: fd.dofmap.gather(uu, blk.key)})

        report(f"{name} internal force", force, u, hist)
        report(f"{name} tangent", tangent, u, v, hist)
        report(f"{name} gather + assembly", assembly, u)
    A = torch.as_tensor(rng.normal(size=(81, 81))) + 20 * torch.eye(
        81, dtype=torch.float64)
    rhs = torch.as_tensor(rng.normal(size=81))
    x0 = torch.linalg.solve(A, rhs)
    buf = torch.empty(81 * 81 + 1, dtype=torch.float64)
    A1 = buf[1:].view(81, 81)
    A1.copy_(A)
    x1 = torch.linalg.solve(A1, rhs)
    print(f"host LU at two memory offsets: {int((x0 != x1).sum())} of 81 "
          f"entries differ, max {float((x0 - x1).abs().max()):.2e}")
    print(f"host LU twice: {int((x0 != torch.linalg.solve(A, rhs)).sum())}"
          f" of 81 entries differ")


if __name__ == "__main__":
    main()
