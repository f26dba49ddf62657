"""The fluid field's Newton operator: the closed-form tangent of
``ops/fluid.py`` ``linearize`` against forward mode (``torch.func.jvp``)
through the residual, per call and on whole decks.

    python3 tools/fluid_tangent_ab.py [--device cpu|cuda] [--n N] [deck ...]

(from the repository root; default device: the card; default decks:
``fluid_poiseuille_ost`` and ``fluid_mfs_decay``, float64).  For each deck,
and for ``cavity3d_ost`` of chip_smoke.py at n=N (default 64 on the card,
8 on the CPU, float32), at a random state: the ms per residual, per
linearization, per closed-form Jacobian action and per forward-mode
Jacobian action (CUDA events on the card, the host clock on the CPU), and
the largest difference of the two actions over the largest entry.  Then
runs ``fluid_cavity_stationary`` through ``driver.run`` with each operator
(closed form, forward mode) and prints its wall time, Newton and GMRES
counts and whether the final states are equal to the bit.
"""

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from fourc_tpu_torch.io import deck as deck_io  # noqa: E402
from fourc_tpu_torch.physics import driver  # noqa: E402
from fourc_tpu_torch.physics import fluid as pf  # noqa: E402
from fourc_tpu_torch.physics import fluid_driver  # noqa: E402

DECKS = ("decks/fluid_poiseuille_ost.yaml", "decks/fluid_mfs_decay.yaml")
WHOLE = "decks/fluid_cavity_stationary.yaml"
CLOSED_FORM = pf.FluidField.linearize


def forward_mode_linearize(self, x, xdot, t, dt=None, mesh_disp=None,
                           mesh_vel=None):
    """``FluidField.linearize`` with its action by ``torch.func.jvp``
    through the residual."""
    def res(a, b):
        return CLOSED_FORM(self, a, b, t, dt, mesh_disp, mesh_vel)[0]

    def apply(dx, dxdot):
        return torch.func.jvp(res, (x, xdot), (dx, dxdot))[1]

    return res(x, xdot), apply


def _timer(device):
    if device == "cuda":
        return cs._time

    def host(fn, reps=20):
        for _ in range(3):
            fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps

    return host


def per_call(name, f, device, reps):
    timer = _timer(device)
    gen = torch.Generator().manual_seed(0)
    state = pf.init_state(f)
    x = state["x"] + 0.1 * torch.randn(f.ndof, generator=gen,
                                       dtype=f.dtype).to(f.device)
    xdot = torch.zeros_like(x)
    v = torch.randn(f.ndof, generator=gen, dtype=f.dtype).to(f.device)
    dv = pf.zero_pressure_rate(f, v * 10.0)
    dt = f.params.dt

    r, closed = f.linearize(x, xdot, 1.0, dt=dt)
    _, fwd = forward_mode_linearize(f, x, xdot, 1.0, dt=dt)
    a, b = closed(v, dv), fwd(v, dv)
    err = float((a - b).abs().max() / b.abs().max())
    ms = {"residual": timer(lambda: f.residual_transient(x, xdot, 1.0,
                                                          dt=dt), reps),
          "linearization": timer(lambda: f.linearize(x, xdot, 1.0, dt=dt),
                                 reps),
          "closed-form action": timer(lambda: closed(v, dv), reps),
          "forward-mode action": timer(lambda: fwd(v, dv), reps)}
    print(f"{name} ({f.ndof} unknowns, {f.dtype}, {device}): "
          + ", ".join(f"{k} {t:.3f} ms" for k, t in ms.items())
          + f"; forward mode / closed form "
          f"{ms['forward-mode action'] / ms['closed-form action']:.1f}x; "
          f"actions differ by {err:.3e} of the largest entry", flush=True)


def whole_deck(device):
    rows = []
    for label, lin in (("closed form", CLOSED_FORM),
                       ("forward mode", forward_mode_linearize)):
        pf.FluidField.linearize = lin
        final = {}
        try:
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = driver.run(WHOLE, device=device, callbacks=[
                lambda _, st, __: final.update(
                    {k: v.clone() for k, v in st.items()
                     if torch.is_tensor(v)})])
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            pf.FluidField.linearize = CLOSED_FORM
        agg = res.stats["fluid"]
        rows.append(final)
        print(f"{WHOLE} ({device}, {label}): {wall:.2f} s, "
              f"{agg['newton_iters']} Newton, {agg['lin_iters']} GMRES",
              flush=True)
    same = all(torch.equal(rows[0][k], rows[1][k]) for k in rows[0])
    print(f"{WHOLE}: final states equal to the bit: {same}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("decks", nargs="*", default=DECKS)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass --device cpu)")
    if args.device == "cpu":
        torch.set_num_threads(1)
    reps = 20 if args.device == "cuda" else 5
    for deck in args.decks:
        f = fluid_driver.build_field(deck_io.load(deck), device=args.device)
        per_call(deck, f, args.device, reps)
    n = args.n or (64 if args.device == "cuda" else 8)
    per_call(f"cavity3d_ost n={n}",
             cs.cavity3d_problem(n, args.device, torch.float32),
             args.device, reps)
    whole_deck(args.device)


if __name__ == "__main__":
    main()
