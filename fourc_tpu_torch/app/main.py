"""Command-line driver of the PyTorch/CUDA port.

Counterpart of fourc_tpu/app/main.py: reads a deck, runs the problem on the
CUDA card (``--device cpu`` runs the kernels' plain PyTorch twins on the
CPU), prints a summary line and checks the deck's RESULT DESCRIPTION.
There is no ``--x64``: the deck's ``problem.dtype`` sets the precision.

Usage:
  python -m fourc_tpu_torch.app.main <deck.yaml> [--device cuda|cpu]
      [--timers] [--ngroup N] [--parameters]
"""

from __future__ import annotations

import argparse
import sys

# flags of the reference's CLI that the port does not carry
_UNPORTED_FLAGS = ("restart", "restart_from", "profile", "debug_nans")


def _same(a, b):
    """Bitwise equality of state entries: tensors, dicts of them (the
    history), numbers."""
    import torch

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(v, b[k])
                                            for k, v in a.items())
    return torch.equal(a, b) if torch.is_tensor(a) else a == b


def main(argv=None):
    p = argparse.ArgumentParser(prog="fourc_tpu_torch", description=__doc__)
    p.add_argument("deck", nargs="?", help="input deck (.yaml)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="run on the CUDA card (default) or on the CPU")
    p.add_argument("--restart", type=int, default=0,
                   help="restart from step N (not ported)")
    p.add_argument("--restart-from", default=None,
                   help="checkpoint directory (not ported)")
    p.add_argument("--parameters", action="store_true",
                   help="print the deck schema and exit")
    p.add_argument("--timers", action="store_true", help="print phase-timer table")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="trace the run into DIR (not ported)")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise on NaN/Inf in any computation (not ported)")
    p.add_argument("--ngroup", type=int, default=1,
                   help="run N independent instances of the deck and require "
                        "bitwise-identical final states")
    args = p.parse_args(argv)

    if args.parameters:
        from fourc_tpu_torch.io.deck import DECK_SPEC, describe

        print(describe(DECK_SPEC))
        return 0
    if not args.deck:
        p.error("deck file required")
    for flag in _UNPORTED_FLAGS:
        if getattr(args, flag):
            p.error(f"--{flag.replace('_', '-')} is not ported")

    import torch

    from fourc_tpu_torch.core.device import resolve_device
    from fourc_tpu_torch.io import deck as deck_mod
    from fourc_tpu_torch.io.result_test import run_result_tests
    from fourc_tpu_torch.physics import driver

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        p.error(str(e))
    deck = deck_mod.load(args.deck)
    print(f"fourc_tpu_torch: problem={deck.problem_type}, "
          f"discretizations={ {k: (v.n_nodes, v.n_elements) for k, v in deck.disc.items()} }, "
          f"device={device}")

    if args.ngroup > 1:
        # every group must produce bitwise-identical states (determinism
        # check; the reference compares group 0 with the others)
        results = [driver.run(deck_mod.load(args.deck), device=device)
                   for _ in range(args.ngroup)]
        result = results[0]
        for g, rg in enumerate(results[1:], start=1):
            for name, st in result.states.items():
                other = rg.states[name]
                same = st.keys() == other.keys() and all(
                    _same(v, other[k]) for k, v in st.items())
                if not same:
                    print(f"[DIFFGROUP] group {g} field {name} "
                          f"differs from group 0")
                    return 1
        print(f"diffgroup: {args.ngroup} groups bitwise identical")
    else:
        result = driver.run(deck, device=device)

    if args.timers and result.timers:
        print(result.timers.summary())

    rc = 0
    if deck.result_tests:
        tests = run_result_tests(deck.result_tests, result)
        for t in tests:
            print(t)
        nfail = sum(not t.ok for t in tests)
        print(f"result tests: {len(tests) - nfail}/{len(tests)} passed")
        rc = 1 if nfail else 0
    return rc


if __name__ == "__main__":
    sys.exit(main())
