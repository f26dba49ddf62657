"""Where a fluid deck's card run parts from its CPU run: the deck stepped on
the CPU, and at every step's state the card's and the CPU's ingredients
compared from the same inputs.

    python3 tools/fluid_deck_gpu_cpu.py [--steps N] [deck.yaml ...]

(from the repository root on a machine with a CUDA device; default: the
five fluid decks of chip_smoke.py phase 16, float64, every step).  For
each of the first N steps of the CPU run, from the CPU's state before it:
the largest difference, over the CPU value's largest entry, of the
stabilization parameters tau_M and tau_C, the residual, the Jacobian
action along a fixed direction and the state after one step taken on each
device; 0 means the same bits.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fourc_tpu_torch.io import deck as deck_io  # noqa: E402
from fourc_tpu_torch.ops import fluid as fops  # noqa: E402
from fourc_tpu_torch.physics import fluid as pf  # noqa: E402
from fourc_tpu_torch.physics import fluid_driver  # noqa: E402

DECKS = ("decks/fluid_cavity_stationary.yaml",
         "decks/fluid_poiseuille_ost.yaml",
         "decks/fluid_smagorinsky_decay.yaml", "decks/fluid_mfs_decay.yaml",
         "decks/windkessel_channel.yaml")


def _rel(got, want):
    got, want = got.cpu(), want.cpu()
    scale = float(want.abs().max()) or 1.0
    return float((got - want).abs().max()) / scale


def _on(state, device):
    return {k: v.to(device) if torch.is_tensor(v) else v
            for k, v in state.items()}


def _dt(f):
    return None if f.params.dyntype == "stationary" else f.params.dt


def _taus(f, x):
    """tau_M and tau_C of every block at the velocity of x (stationary
    form), concatenated."""
    out = []
    for key, (G, wdet, N) in f.geometry.items():
        nen = f.cells[key].nen
        xe = f.dofmap.gather(x, key).reshape(nen, f.ndpn, -1)
        u = fops.interp_vec(N, xe[:, :f.dim])
        m = f.block_mat[key]
        tm, tc = fops.stab_params(u, float(m.visc()), float(m.density), G,
                                  wdet, _dt(f))
        out += [tm.reshape(-1), tc.reshape(-1)]
    return torch.cat(out)


def compare(path, max_steps=None):
    deck = deck_io.load(path)
    fields = {d: fluid_driver.build_field(deck, device=d)
              for d in ("cpu", "cuda")}
    steps = {d: pf.make_step(f, f.params.dt) for d, f in fields.items()}
    state = pf.init_state(fields["cpu"])
    gen = torch.Generator().manual_seed(0)
    v = torch.randn(fields["cpu"].ndof, generator=gen, dtype=torch.float64)
    n = deck.sections["fluid_dynamic"]["numstep"]
    for k in range(min(n, max_steps or n)):
        row = {}
        got = {}
        for d, f in fields.items():
            st = _on(state, d)
            x, xdot = st["x"], st["xdot"]
            r, apply = f.linearize(x, xdot, st["t"] + f.params.dt,
                                   dt=_dt(f))
            vd = v.to(d)
            got[d] = (_taus(f, x), r, apply(vd, pf.zero_pressure_rate(
                f, vd * (1.0 / f.params.dt))),
                steps[d](st)[0]["x"])
        for name, i in (("tau", 0), ("residual", 1), ("J v", 2),
                        ("step", 3)):
            row[name] = _rel(got["cuda"][i], got["cpu"][i])
        print(f"{path} step {k + 1}: " + ", ".join(
            f"{name} {e:.3e}" for name, e in row.items()), flush=True)
        state, _ = steps["cpu"](state)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("decks", nargs="*", default=DECKS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    for path in args.decks:
        compare(path, args.steps)


if __name__ == "__main__":
    main()
