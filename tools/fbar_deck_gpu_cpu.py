"""Where the card's run of the 4C-converted F-bar deck parts from the CPU's.

Runs decks/ref_converted/solid_ele_hex8_standard_fbar.yaml through
``driver.run`` on the card and on the CPU in float64, then prints, against
4C's verbatim values, the nodal stresses of each run's final displacement
evaluated on each device, and the largest device difference of each
ingredient of the residual at the CPU's final displacement: the element
geometry, the internal force, the body force and the whole residual.

    python3 tools/fbar_deck_gpu_cpu.py

(on a machine with a CUDA device; the repository root on the path).
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fourc_tpu_torch.physics import driver  # noqa: E402

DECK = "decks/ref_converted/solid_ele_hex8_standard_fbar.yaml"
ANCHORS = {(4, 0, 0): 24.66368771114965, (4, 1, 1): 0.860509091130061,
           (4, 2, 2): 0.15421244576752716, (4, 0, 1): -0.5695001478856991,
           (7, 0, 0): 1.4950391697543606, (7, 0, 1): -5.810056754984995}


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    runs = {}
    for device in ("cuda", "cpu"):
        res = driver.run(DECK, device=device)
        runs[device] = (res.fields["structure"].f,
                        res.states["structure"]["d"])
    fg, dg = runs["cuda"]
    fc, dc = runs["cpu"]
    print(f"max |d_gpu - d_cpu| {float((dg.cpu() - dc).abs().max()):.3e}, "
          f"max |d| {float(dc.abs().max()):.3e}")
    for dname, d in (("d_gpu", dg.cpu()), ("d_cpu", dc)):
        for fname, f in (("gpu", fg), ("cpu", fc)):
            sig = f.nodal_stresses(d.to(f.device)).cpu()
            print(f"stress of {dname} on the {fname}: anchor - 4C "
                  + ", ".join(f"{k}: {float(sig[k]) - v:+.3e}"
                              for k, v in ANCHORS.items()))
    bg, bc = fg.blocks[0], fc.blocks[0]
    for name in ("G", "wdet", "geo"):
        a, b = getattr(bg, name).cpu(), getattr(bc, name)
        print(f"{name}: max |gpu - cpu| {float((a - b).abs().max()):.3e}")
    t1 = 1.0
    for name, fn in (("internal force", lambda f, d: f.internal_force(d)),
                     ("body force", lambda f, d: f.body_force(t1)),
                     ("external force", lambda f, d: f.external_force(t1))):
        a, b = fn(fg, dc.cuda()).cpu(), fn(fc, dc)
        print(f"{name} at d_cpu: max |gpu - cpu| "
              f"{float((a - b).abs().max()):.3e} of max {float(b.abs().max()):.3e}")


if __name__ == "__main__":
    main()
