"""The asymmetry of Blemker's PK2 stress (muscle_blemker) in the JAX
package (``--reference``), which takes the gradient of the energy in the
nine entries of C, where I5 = |C-bar a|^2 gives 2 (C-bar a) (x) a, not
its symmetric part; and the port's stress, which is that symmetric part
(symmetric to the last bit).

    python tools/blemker_asymmetry.py [--reference | --deck]

Prints S and max |S - S^T| / max |S| at one state of the gate deck's law
(decks/muscle_blemker_contraction.yaml): F with an in-plane shear, history
t 0.5, dt 0.25.  With ``--deck``, runs that deck with the port on the CPU
and prints, after every step, the largest off-diagonal entry of C over
its Gauss points and the reference's max |S - S^T| / max |S| there (a
uniaxial contraction along the fibre: C diagonal, both stresses alike).
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SPEC = {"type": "muscle_blemker", "g1": 0.5, "g2": 0.5, "p1": 0.05,
        "p2": 6.6, "sigma_max": 40.0, "lambda_ofl": 1.2,
        "lambda_star": 1.4, "alpha": 1.0, "beta": 2.0, "t_act_start": 0.0,
        "youngs": 200.0, "nue": 0.3, "a": [1.0, 0.0, 0.0]}
F = np.array([[1.1, 0.05, 0.0], [0.02, 0.96, 0.0], [0.0, 0.0, 0.95]])


def deck_states():
    """The reference's asymmetry at the gate deck's Gauss points, step by
    step of the port's CPU run."""
    import jax
    import jax.numpy as jnp
    import yaml

    from fourc_tpu.materials import make_material
    from fourc_tpu_torch.ops import solid as sops
    from fourc_tpu_torch.physics import driver

    jax.config.update("jax_enable_x64", True)
    deck = "decks/muscle_blemker_contraction.yaml"
    with open(deck) as fh:
        spec = yaml.safe_load(fh)["materials"][1]
    law = make_material(dict(spec))
    states = []
    res = driver.run(deck, device="cpu", callbacks=[
        lambda _, st, __: states.append((st["d"].clone(), {
            k: v.clone() for k, v in st["hist"].items()}))])
    f = res.fields["structure"].f
    blk = f.blocks[0]
    conn = torch.as_tensor(np.asarray(f.disc.blocks[blk.key].conn),
                           dtype=torch.long)
    dt = float(f.params.dt)
    for i, (d, hist) in enumerate(states):
        ue = d.reshape(-1, 3)[conn].permute(1, 2, 0)  # (nen, 3, E)
        E = sops._green_lagrange(sops._grad(ue, blk.G))  # (3, 3, g, E)
        C = (2.0 * E).permute(3, 2, 0, 1).reshape(-1, 3, 3).numpy() \
            + np.eye(3)
        h = hist[blk.key].reshape(-1, hist[blk.key].shape[-1]).numpy()
        S = np.asarray(jax.vmap(lambda c, hh: law.evaluate(c, hh, dt)[0])(
            jnp.asarray(C), jnp.asarray(h)))
        off = np.abs(C - C * np.eye(3)).max()
        asym = np.abs(S - S.transpose(0, 2, 1)).max() / np.abs(S).max()
        print(f"step {i}: max |C_ij|, i != j, {off:.3e}; reference "
              f"max |S - S^T| / max |S| {asym:.3e}")


def main(argv):
    if "--deck" in argv:
        return deck_states()
    C = F.T @ F
    if "--reference" in argv:
        import jax
        import jax.numpy as jnp

        from fourc_tpu.materials import make_material

        jax.config.update("jax_enable_x64", True)
        S = np.asarray(make_material(dict(SPEC)).evaluate(
            jnp.asarray(C), jnp.array([0.5]), 0.25)[0])
        who = "reference"
    else:
        from fourc_tpu_torch.materials import make_material

        S = make_material(dict(SPEC)).evaluate(
            torch.as_tensor(C)[..., None], torch.tensor([[0.5]],
                                                        dtype=torch.float64),
            0.25)[0][..., 0].numpy()
        who = "port"
    print(f"{who}: S =\n{S}")
    print(f"{who}: max |S - S^T| / max |S| = "
          f"{np.abs(S - S.T).max() / np.abs(S).max():.6e}")


if __name__ == "__main__":
    main(sys.argv[1:])
