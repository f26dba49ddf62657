"""Where the card's run of a deck parts from the CPU's, step by step.

    python3 tools/history_deck_gpu_cpu.py [deck]   (default: the J2 deck)

(on a machine with a CUDA device; the repository root on the path).  Builds
the deck's field on the card and on the CPU in float64 and steps both from
the same state: before each step the card's state is set to the CPU's, so
each line compares one step from equal inputs.  Prints per step the Newton
counts, the first norm of Newton's (residual, line search, increment)
that differs between the devices and by how much, and the largest device
difference, at the CPU's state, of each ingredient: the internal force and
the new history, the dense tangent (the direct solve's probes) and the
solve; then the difference of the two steps' results.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fourc_tpu_torch.io import deck as deck_mod  # noqa: E402
from fourc_tpu_torch.linalg import solvers  # noqa: E402
from fourc_tpu_torch.physics import newton  # noqa: E402
from fourc_tpu_torch.physics import solid as ps  # noqa: E402
from fourc_tpu_torch.physics import structure_driver as sd  # noqa: E402

DECK = "decks/solid_j2_cyclic.yaml"


def _to(state, device):
    return {k: ({kk: vv.to(device) for kk, vv in v.items()}
                if isinstance(v, dict) else
                v.to(device) if torch.is_tensor(v) else v)
            for k, v in state.items()}


def _diff(a, b):
    return float((a.cpu() - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-300)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    path = sys.argv[1] if len(sys.argv) > 1 else DECK
    deck = deck_mod.load(path)
    dyn = deck.sections["structural_dynamic"]
    fields = {dev: sd.build_field(deck, device=dev) for dev in ("cuda", "cpu")}
    norms = []
    orig = newton._norm

    def record(x):
        val = orig(x)
        norms.append(val)
        return val

    newton._norm = record
    dt = dyn["timestep"]
    steps = {dev: ps.make_step(f, dt) for dev, f in fields.items()}
    fc, fg = fields["cpu"], fields["cuda"]
    state = ps.compute_initial_state(fc, ps.init_state(fc))
    for k in range(dyn["numstep"]):
        u, hist = state["d"], state["hist"]
        fi_c, h_c = fc.internal_force(u, hist, dt, with_history=True)
        fi_g, h_g = fg.internal_force(u.cuda(), _to(hist, "cuda"), dt,
                                      with_history=True)
        n = u.numel()
        eye = torch.eye(n, dtype=u.dtype)
        Kc = torch.func.vmap(lambda e: fc.tangent(u, e, 0.0, hist, dt))(eye)
        Kg = torch.func.vmap(lambda e: fg.tangent(
            u.cuda(), e, 0.0, _to(hist, "cuda"), dt))(eye.cuda())
        rhs = fi_c
        xc = torch.linalg.solve(Kc + torch.eye(n, dtype=u.dtype), rhs)
        xg = solvers.direct(lambda v: (Kg + torch.eye(
            n, dtype=u.dtype, device="cuda")) @ v, rhs.cuda()).x
        out = {}
        for dev in ("cpu", "cuda"):
            norms.clear()
            new, st = steps[dev](_to(state, dev))
            out[dev] = (new, st, list(norms))
        (nc, sc, rc), (ng, sg, rg) = out["cpu"], out["cuda"]
        first = next((i for i, (a, b) in enumerate(zip(rc, rg)) if a != b),
                     None)
        dh = max([_diff(ng["hist"][b], nc["hist"][b])
                  for b in nc["hist"]] or [0])
        print(f"step {k}: newton cpu {sc['iters']}, card {sg['iters']}; "
              f"{len(rc)} / {len(rg)} norms, first differing "
              + ("none" if first is None else
                 f"#{first}: {rc[first]:.17e} vs {rg[first]:.17e}")
              + f"; at the CPU's state: fint {_diff(fi_g, fi_c):.2e}, "
              f"hist {max([_diff(h_g[b], h_c[b]) for b in h_c] or [0]):.2e},"
              f" tangent {_diff(Kg, Kc):.2e}, solve {_diff(xg, xc):.2e}; "
              f"after the step d {_diff(ng['d'], nc['d']):.2e}, hist "
              f"{dh:.2e}", flush=True)
        state = nc
    newton._norm = orig


if __name__ == "__main__":
    main()
