"""How far crystal plasticity's stress, history and forward derivative
move for one-ulp changes of C, in the port and in the reference.

Usage, from the repository root on the CPU:

    python tools/crystal_sensitivity.py [dt] [--reference]

Evaluates the port's crystal plasticity law at the states of
tests/port/test_torch_plasticity.py's ``crystal_dt_floored_g`` case
(float64): 300 seeded C = F^T F of all sizes, a third each from a zero
history (Fp read as I, g floored at g0 / 1000), from [I, g0], and from a
nontrivial Fp of det 1 with g between g0 and g_sat.  It evaluates again
with 20 seeded one-ulp changes of C's entries and prints, for all states
and for each start, the largest change of the stress, of the new history
and of the stress's forward derivative along the test's seeded direction,
each over its largest entry, as the test measures.  With ``--reference``
it does the same for the JAX package's law (jit on the CPU, float64) and
prints how far the port lies from the reference at the unchanged C.  The rate
law |tau / g|^(1/m) with a floored g makes the zero start touchy: the
reference's own one-ulp spread there bounds how closely any second
implementation can agree with it.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fourc_tpu_torch.materials import make_material  # noqa: E402

CRYSTAL = {"type": "crystal_plasticity", "youngs": 1000.0, "nue": 0.3,
           "g0": 4.0, "gdot0": 1e-2, "rate_m": 0.2, "h0": 10.0,
           "g_sat": 12.0, "nsub": 10}
N = 300
SEEDS = 20
WHAT = ("stress", "history", "derivative")


def states(mat, rng):
    """The seeded C (N, 3, 3), histories (N, 10) and derivative direction
    (N, 3, 3) of the test's ``crystal_dt_floored_g`` case, and the rows of
    each start."""
    F = np.eye(3) + rng.normal(size=(N, 3, 3)) * np.geomspace(
        1e-4, 0.06, N)[:, None, None]
    C = np.einsum("nki,nkj->nij", F, F)
    h = np.zeros((N, 10))
    third = N // 3
    h[third:2 * third] = np.r_[np.eye(3).reshape(9), mat.g0]
    Fp = np.eye(3) + rng.normal(size=(N - 2 * third, 3, 3)) * 0.02
    Fp /= np.cbrt(np.linalg.det(Fp))[:, None, None]
    h[2 * third:, :9] = Fp.reshape(-1, 9)
    h[2 * third:, 9] = rng.uniform(mat.g0, mat.g_sat, size=N - 2 * third)
    dC = rng.normal(size=C.shape)
    dC = 0.5 * (dC + np.swapaxes(dC, 1, 2))
    return C, h, dC, {"all starts": slice(None),
                  "zero history": slice(0, third),
                  "[I, g0]": slice(third, 2 * third),
                  "nontrivial Fp": slice(2 * third, None)}


def one_ulp(C, seed):
    """C with each entry moved by -1, 0 or +1 ulp, kept symmetric."""
    step = np.random.default_rng(seed).choice([-1, 0, 1], size=C.shape)
    Cp = np.where(step > 0, np.nextafter(C, np.inf),
                  np.where(step < 0, np.nextafter(C, -np.inf), C))
    return np.triu(Cp) + np.swapaxes(np.triu(Cp, 1), 1, 2)


def spread(law, C, rows):
    """For each start, the largest one-ulp change of each of WHAT in its
    rows, over the largest entry of all rows; and the law's values at C."""
    base = law(C)
    scale = [float(np.abs(b).max()) for b in base]
    worst = {name: [0.0] * len(WHAT) for name in rows}
    for seed in range(SEEDS):
        moved = law(one_ulp(C, seed))
        for name, r in rows.items():
            for i in range(len(WHAT)):
                worst[name][i] = max(worst[name][i], float(np.abs(
                    moved[i][r] - base[i][r]).max() / scale[i]))
    return worst, base


def port_law(mat, h, dC, dt):
    """C -> (stress, history, the stress's derivative along dC), the
    port's law."""
    th = torch.as_tensor(h.T)
    tdC = torch.as_tensor(dC.transpose(1, 2, 0))

    def law(C):
        (S, hn), (dS, _) = torch.func.jvp(
            lambda c: mat.evaluate(c, th, dt),
            (torch.as_tensor(C.transpose(1, 2, 0)),), (tdC,))
        return (S.numpy().transpose(2, 0, 1), hn.numpy().T,
                dS.numpy().transpose(2, 0, 1))
    return law


def reference_law(h, dC, dt):
    """The JAX package's law, on the CPU in float64 (imported here only)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from fourc_tpu.materials import make_material as reference_make

    mat = reference_make(dict(CRYSTAL))
    fn = jax.jit(lambda c: jax.jvp(jax.vmap(
        lambda cc, hh: mat.evaluate(cc, hh, dt=dt)), (c, h),
        (dC, np.zeros_like(h))))

    def law(C):
        (S, hn), (dS, _) = fn(C)
        return np.asarray(S), np.asarray(hn), np.asarray(dS)
    return law


def main():
    args = [a for a in sys.argv[1:] if a != "--reference"]
    reference = "--reference" in sys.argv[1:]
    dt = float(args[0]) if args else 0.25
    mat = make_material(dict(CRYSTAL))
    C, h, dC, rows = states(mat, np.random.default_rng(17))
    port_spread, port = spread(port_law(mat, h, dC, dt), C, rows)
    if reference:
        ref_spread, ref = spread(reference_law(h, dC, dt), C, rows)

    def line(values):
        return ", ".join(f"{w} {v:.3e}" for w, v in zip(WHAT, values))

    for name, r in rows.items():
        print(f"dt {dt}, {name}: one-ulp changes of C move the port's "
              f"{line(port_spread[name])}")
        if not reference:
            continue
        gap = [float(np.abs(p[r] - q[r]).max() / np.abs(q).max())
               for p, q in zip(port, ref)]
        print(f"dt {dt}, {name}: ... the reference's "
              f"{line(ref_spread[name])}; the port lies {line(gap)} from it")


if __name__ == "__main__":
    main()
