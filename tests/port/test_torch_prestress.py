"""Slice 5a: MULF prestress on the CPU in float64, held to 4C.

4C's MULF measures the displacement gradient on the last prestressed
configuration and multiplies, F_tot = (I + Grad_xp u) F0 = F0 + Grad_X u,
takes the wrapped law's PK2 stress at F_tot as it is, and folds
F0 <- F_tot after each prestress step; the 4C-converted deck's 12 anchors
(1e-12) decide it against the reference's form (F = (I + H) F0, stress
scaled det(F0) F0 S F0^T), which misses them by about 2x.  Held here: the
fold against the reference's ``update_prestress`` from F0 = I and against
4C's fold written out from a prestretched F0, the element stress against
4C's formula written out in numpy, both MULF decks through the CLI, and the
refusals.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from fourc_tpu_torch.app.main import main
from fourc_tpu_torch.core import gridgen
from fourc_tpu_torch.core.cells import get_cell
from fourc_tpu_torch.io import deck as deck_mod
from fourc_tpu_torch.materials import make_material
from fourc_tpu_torch.ops import solid as ops
from fourc_tpu_torch.physics import driver
from fourc_tpu_torch.physics import solid as ps
from fourc_tpu_torch.physics import structure_driver

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MULF_4C = os.path.join(ROOT, "decks", "ref_converted",
                       "solid_ele_hex8_standard_mulf.yaml")
MULF_SELF = os.path.join(ROOT, "decks", "mulf_prestress.yaml")
RTOL = 1e-12
NEOHOOKE = {"type": "neohooke", "youngs": 1000.0, "nue": 0.3}


def _mulf_deck(nx=2):
    with open(MULF_SELF) as fh:
        data = yaml.safe_load(fh)
    data["geometry"]["generator"].update(nx=nx)
    return data


def _field_and_state(rng, scale=0.02):
    data = _mulf_deck()
    f = structure_driver.build_field(deck_mod.load(data), device="cpu")
    state = ps.init_state(f)
    state["d"] = torch.as_tensor(scale * rng.normal(size=f.ndof))
    return f, state


def test_fold_from_identity_matches_the_reference():
    """The first prestress step (F0 = I): F0 <- I + H, the reference's
    fold F F0, at 1e-12; d, v, a restart from zero."""
    import jax.numpy as jnp

    from fourc_tpu.io import deck as jdeck
    from fourc_tpu.physics import solid as jps
    from fourc_tpu.physics import structure_driver as jsd

    rng = np.random.default_rng(21)
    f, state = _field_and_state(rng)
    jf = jsd.build_field(jdeck.load(_mulf_deck()), "structure")
    js = jps.init_state(jf)
    js["d"] = jnp.asarray(state["d"].numpy())
    want = jps.update_prestress(jf, js)
    got = ps.update_prestress(f, state)
    key = next(iter(got["hist"]))
    assert np.abs(np.asarray(want["hist"][key]) - 1.0).max() > 1e-3
    np.testing.assert_allclose(got["hist"][key].numpy(),
                               np.asarray(want["hist"][key]), rtol=RTOL,
                               atol=RTOL)
    for k in ("d", "v", "a", "fint"):
        assert not got[k].any()


def _H(f, d):
    b = f.blocks[0]
    nen, _, g, E = b.G.shape
    return ops._grad(f.dofmap.gather(d, b.key).reshape(nen, 3, E), b.G)


def test_fold_from_a_prestretch_is_4c():
    """From a prestretched F0, F0 <- (I + Grad_xp u) F0 with Grad_xp u =
    Grad_X u F0^-1 (4C pushes its inverse Jacobian forward), written out
    in numpy; the reference's (I + Grad_X u) F0 lands elsewhere."""
    rng = np.random.default_rng(22)
    f, state = _field_and_state(rng)
    state = ps.update_prestress(f, state)  # a first fold: F0 != I
    state["d"] = torch.as_tensor(0.02 * rng.normal(size=f.ndof))
    key = f.blocks[0].key
    F0 = state["hist"][key].numpy().reshape(-1, 8, 3, 3)  # (E, g, 3, 3)
    H = _H(f, state["d"]).numpy().transpose(3, 2, 0, 1)  # (E, g, 3, 3)
    dF = np.eye(3) + H @ np.linalg.inv(F0)
    want = dF @ F0
    got = ps.update_prestress(f, state)["hist"][key].numpy()
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=RTOL,
                               atol=RTOL)
    assert np.abs((np.eye(3) + H) @ F0 - want).max() > 1e-4


def _neo_pk2(F, youngs=1000.0, nue=0.3):
    lam = youngs * nue / ((1 + nue) * (1 - 2 * nue))
    mu = youngs / (2 * (1 + nue))
    C = np.swapaxes(F, -1, -2) @ F
    Ci = np.linalg.inv(C)
    lnJ = np.log(np.linalg.det(F))
    return mu * (np.eye(3) - Ci) + lam * lnJ[..., None, None] * Ci


def test_mulf_stress_is_4cs_formula():
    """The element force of a MULF block with a prestretch F0: sum_g wdet_g
    P G_g with P = F_tot S(F_tot), F_tot = (I + Grad_X u F0^-1) F0 and the
    Neo-Hooke S of the mesh as given, all written out in numpy."""
    rng = np.random.default_rng(23)
    disc = gridgen.box(2, 1, 1)
    Xe = disc.coords[disc.blocks["hex8"].conn] + 0.03 * rng.normal(
        size=(2, 8, 3))
    E = Xe.shape[0]
    m = make_material({"type": "mulf", "material": dict(NEOHOOKE)})
    F0 = np.eye(3) + 0.05 * rng.normal(size=(E, 8, 3, 3))
    u = 0.03 * rng.normal(size=(E, 8, 3))
    X = torch.as_tensor(Xe.reshape(E, -1).T.copy())
    G, wdet = ops.element_geometry(X, get_cell("hex8"))
    hist = torch.as_tensor(F0.reshape(E, 8, 9))
    got = ops.element_force(G, wdet, torch.as_tensor(u.reshape(E, -1).T.copy()),
                            m, history=hist)
    Gn = G.numpy().transpose(3, 2, 0, 1)  # (E, g, a, 3)
    Hn = np.einsum("eai,egaj->egij", u, Gn)
    Ftot = (np.eye(3) + Hn @ np.linalg.inv(F0)) @ F0
    P = Ftot @ _neo_pk2(Ftot)
    want = np.einsum("ge,egij,egaj->eai", wdet.numpy(), P, Gn)
    np.testing.assert_allclose(got.numpy().T.reshape(E, 8, 3), want,
                               rtol=RTOL, atol=RTOL * np.abs(want).max())
    # its tangent is the force's forward derivative
    v = torch.randn(24, E, dtype=torch.float64)
    uu = torch.as_tensor(u.reshape(E, -1).T.copy())
    _, jv = torch.func.jvp(lambda x: ops.element_force(G, wdet, x, m,
                                                       history=hist),
                           (uu,), (v,))
    tv = ops.element_tangent(G, wdet, uu, v, m, history=hist)
    assert float((tv - jv).abs().max() / jv.abs().max()) <= 1e-13


def test_converted_mulf_deck_meets_4cs_anchors(capsys):
    """solid_ele_hex8_Standard_mulf: 12/12 at 1e-12 (4C's values), 42
    Newton iterations over its 8 steps after the 2 prestress steps."""
    assert main([MULF_4C, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "result tests: 12/12 passed" in out and "FAIL" not in out
    assert "[structure] 8 steps (8 substeps), 42 Newton its" in out


def test_self_anchored_mulf_deck_balances_its_load():
    """decks/mulf_prestress.yaml prestresses under the load it then
    carries: under 4C's MULF the prestressed mesh is in equilibrium, so
    the step takes 0 Newton iterations and d stays 0 to rounding.  Its
    anchors (-3.81e-4, ..., no stated source) are neither this nor the
    reference's -5.64e-4 (ROADMAP C)."""
    res = driver.run(MULF_SELF, device="cpu")
    st = res.stats["structure"]
    assert st["newton_iters"] == 0 and st["steps"] == 1
    assert float(res.states["structure"]["d"].abs().max()) == 0.0
    key = next(iter(res.states["structure"]["hist"]))
    F0 = res.states["structure"]["hist"][key]
    assert float((F0 - torch.eye(3, dtype=F0.dtype).reshape(9)).abs().max()) \
        > 1e-3


# MULF settings the port refuses: (deck changes, what the refusal names)
MULF_REFUSALS = {
    "fbar": ({"structural_dynamic": {"tech": "fbar"}},
             "MULF prestress under tech 'fbar'"),
    "eas": ({"structural_dynamic": {"tech": "eas_mild"}},
            "MULF prestress under tech 'eas_mild'"),
    "k_damp": ({"structural_dynamic": {"dynamictype": "genalpha",
                                       "k_damp": 0.01}},
               "MULF prestress under k_damp"),
    "kinem_linear": ({"structural_dynamic": {"kinem": "linear"}},
                     "MULF prestress under kinem 'linear'"),
}


@pytest.mark.parametrize("name", list(MULF_REFUSALS))
def test_mulf_setting_is_refused_by_name(name, monkeypatch):
    changes, named = MULF_REFUSALS[name]
    data = _mulf_deck()
    for section, values in changes.items():
        data[section].update(values)

    def built(*args, **kwargs):
        raise AssertionError("the field was built before the refusal")

    monkeypatch.setattr(structure_driver, "build_field", built)
    with pytest.raises(NotImplementedError, match="not ported") as exc:
        driver.run(data, device="cpu")
    assert named in str(exc.value)
