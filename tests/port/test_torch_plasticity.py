"""Slice 4f: the other plasticity laws (Drucker-Prager, Lemaitre, GTN,
superelastic SMA, Robinson, Perzyna, crystal plasticity) on the CPU in
float64.

Held against the JAX package eagerly (no jit, no step, no JAX field): each
law's stress and new history under ``jax.vmap`` of its ``evaluate_small``
/ ``evaluate`` with the step's dt by name, at 1e-12 relative over a few
hundred seeded states that take every branch of its return map, and its
forward derivative against ``jax.jvp`` at 1e-10;
the tie helpers against ``jax.jvp`` at their bounds.  The rest is pure
torch: the ``*_ieee`` functions against numpy, crystal plasticity's
initial state, the refusals, and the six gate decks through the CLI with
the reference's Newton iterations and substeps.
"""

import math
import os
import re

import numpy as np
import pytest
import torch
import yaml

from fourc_tpu_torch import convert
from fourc_tpu_torch.app.main import main
from fourc_tpu_torch.io import deck as deck_mod
from fourc_tpu_torch.io.result_test import read_node_lines
from fourc_tpu_torch.materials import make_material
from fourc_tpu_torch.materials import base as mbase
from fourc_tpu_torch.ops import common as gm
from fourc_tpu_torch.physics import driver, solid as ps
from fourc_tpu_torch.physics import structure_driver
from tools.rigid_rotation_anchors import ROTATION_FREE

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RTOL, JVP_TOL = 1e-12, 1e-10
# crystal plasticity at dt 0.25 from a zero history (Fp read as I, g
# floored at g0 / 1000): one-ulp changes of C move the reference's own
# stress there by up to 2.28e-10 of its largest entry, its history by
# 1.10e-10 and the stress's forward derivative by 8.43e-9 (the port's by
# 1.13e-10, 5.5e-11 and 4.2e-9; tools/crystal_sensitivity.py --reference):
# no second implementation can be held closer than the reference's spread
FLOORED_G_TOL, FLOORED_G_JVP_TOL = 2.5e-10, 1e-8
N_STATES = 300

DP = {"type": "plasticdruckerprager", "youngs": 1000.0, "nue": 0.3,
      "cohesion": 10.0, "eta": 0.4, "xi": 1.0, "isohard": 20.0}
LEMAITRE = {"type": "plasticlemaitre", "youngs": 1000.0, "nue": 0.3,
            "yield_stress": 10.0, "isohard": 60.0, "s0": 0.02, "s_exp": 1.0}
GTN = {"type": "plasticgtn", "youngs": 1000.0, "nue": 0.3,
       "yield_stress": 12.0, "isohard": 40.0, "f0": 0.02, "fn": 0.04,
       "en": 0.1, "sn": 0.05}
SMA = {"type": "superelastic_sma", "youngs": 1000.0, "nue": 0.3,
       "eps_l": 0.05, "s_as_s": 20.0, "s_as_f": 30.0, "s_sa_s": 15.0,
       "s_sa_f": 8.0}
ROBINSON = {"type": "robinson", "youngs": 1000.0, "nue": 0.3, "k0": 5.0,
            "a_flow": 1.0, "n_exp": 2.0, "hard": 50.0, "recov": 0.1,
            "omega_t": 0.0}
PERZYNA = {"type": "viscoplastic_perzyna", "youngs": 1000.0, "nue": 0.3,
           "yield_stress": 5.0, "eta": 2.0, "m_exp": 1.0, "isohard": 30.0}
CRYSTAL = {"type": "crystal_plasticity", "youngs": 1000.0, "nue": 0.3,
           "g0": 4.0, "gdot0": 1e-2, "rate_m": 0.2, "h0": 10.0,
           "g_sat": 12.0, "nsub": 10}
# case -> (deck spec, kinematics, the step's dt)
LAWS = {
    "druckerprager": (DP, "linear", None),
    "druckerprager_nonassociative": ({**DP, "etabar": 0.1}, "linear", None),
    "lemaitre": (LEMAITRE, "linear", None),
    "lemaitre_s_exp_1.5": ({**LEMAITRE, "s_exp": 1.5}, "linear", None),
    "gtn": (GTN, "linear", None),
    "sma": (SMA, "linear", None),
    "robinson": (ROBINSON, "linear", None),
    "robinson_dt": (ROBINSON, "linear", 0.5),
    "perzyna": (PERZYNA, "linear", None),
    "perzyna_m_1.5_dt": ({**PERZYNA, "m_exp": 1.5}, "linear", 0.5),
    "crystal": (CRYSTAL, "nonlinear", None),
    "crystal_dt": (CRYSTAL, "nonlinear", 0.25),
    "crystal_dt_floored_g": (CRYSTAL, "nonlinear", 0.25),
}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _materials(spec):
    from fourc_tpu.materials import make_material as jmake

    return jmake(yaml.safe_load(yaml.safe_dump(spec))), make_material(
        yaml.safe_load(yaml.safe_dump(spec)))


def _sym(a):
    return 0.5 * (a + np.swapaxes(a, -1, -2))


def _small_states(law, nh, rng):
    """Strains (N, 3, 3) of all sizes and directions, some nearly
    hydrostatic, and histories (N, nh) that start each law on every branch
    (symmetric plastic strains, as a return map leaves them)."""
    n = N_STATES
    eps = _sym(rng.normal(size=(n, 3, 3))) * np.geomspace(
        1e-4, 0.08, n)[:, None, None]
    eps[::5] += np.eye(3) * rng.uniform(-0.05, 0.08, size=(len(eps[::5]),
                                                          1, 1))
    h = np.zeros((n, nh))
    h[:, :9] = _sym(rng.normal(size=(n, 3, 3)) * 2e-3).reshape(n, 9)
    h[: n // 6, :9] = 0.0
    if law == "plasticlemaitre":
        h[:, 9] = np.abs(rng.normal(size=n)) * 1e-2
        h[:, 10] = rng.choice([0.0, 0.3, 0.9, 0.985, 0.9899, 0.99], size=n)
    elif law == "plasticgtn":
        h[:, 9] = np.abs(rng.normal(size=n)) * 2e-2
        h[:, 10] = rng.choice([0.0, 0.01, 0.1, 0.2, 0.3], size=n)
    elif law == "plasticdruckerprager":
        h[:, 9] = np.abs(rng.normal(size=n)) * 1e-2
    elif law == "superelastic_sma":
        h[:, :9] *= 10.0
        h[:, 9] = rng.choice([0.0, 1.0, 0.4, 0.05, 0.95], size=n)
    elif law == "robinson":  # a deviatoric back stress, as the flow
        back = _sym(rng.normal(size=(n, 3, 3)))  # leaves it
        back -= np.trace(back, axis1=1, axis2=2)[:, None, None] / 3 \
            * np.eye(3)
        h[:, 9:18] = back.reshape(n, 9)
    elif law == "viscoplastic_perzyna":
        h[:, 9:18] = rng.normal(size=(n, 9))
        h[:, 18] = np.abs(rng.normal(size=n)) * 1e-2
    return eps, h


def _crystal_states(tm, rng, zero_g=True):
    """C = F^T F of all sizes (N, 3, 3) and histories (N, 10): Fp zero (the
    lazy seed; with ``zero_g`` g zero too, floored at g0 / 1000, else g0),
    the initial [I, g0], and a nontrivial Fp of det 1 with g between g0
    and g_sat.  The floored g makes |tau| / g huge and the capped power law
    touchy (FLOORED_G_TOL)."""
    n = N_STATES
    F = np.eye(3) + rng.normal(size=(n, 3, 3)) * np.geomspace(
        1e-4, 0.06, n)[:, None, None]
    C = np.einsum("nki,nkj->nij", F, F)
    h = np.zeros((n, 10))
    third = n // 3
    if not zero_g:
        h[:third, 9] = tm.g0
    h[third:2 * third] = np.concatenate([np.eye(3).reshape(9), [tm.g0]])
    Fp = np.eye(3) + rng.normal(size=(n - 2 * third, 3, 3)) * 0.02
    Fp /= np.cbrt(np.linalg.det(Fp))[:, None, None]
    h[2 * third:, :9] = Fp.reshape(-1, 9)
    h[2 * third:, 9] = rng.uniform(tm.g0, tm.g_sat, size=n - 2 * third)
    return C, h


def _branches(law, spec, arg, h, s, hn):
    """Each branch of the return map taken by the reference: the number of
    states in it, by name."""
    dev = s - np.trace(s, axis1=1, axis2=2)[:, None, None] / 3 * np.eye(3)
    if law == "plasticdruckerprager":
        plastic = hn[:, 9] > h[:, 9]
        apex = plastic & (np.abs(dev).max(axis=(1, 2)) == 0.0)
        return {"elastic": ~plastic, "cone": plastic & ~apex, "apex": apex}
    if law == "plasticlemaitre":
        plastic = hn[:, 9] > h[:, 9]
        return {"elastic": ~plastic, "plastic": plastic,
                "at d_crit": hn[:, 10] == 0.99}
    if law == "plasticgtn":
        yielding = hn[:, 9] > h[:, 9]
        f = np.where(h[:, 10] == 0.0, spec["f0"], h[:, 10])
        return {"elastic": ~yielding, "yielding below fc":
                yielding & (f <= 0.15), "yielding above fc":
                yielding & (f > 0.15), "seeded f0": h[:, 10] == 0.0}
    if law == "superelastic_sma":
        return {"forward": hn[:, 9] > h[:, 9], "reverse": hn[:, 9] < h[:, 9],
                "elastic": hn[:, 9] == h[:, 9],
                "to xi 1": (hn[:, 9] == 1.0) & (h[:, 9] < 1.0),
                "to xi 0": (hn[:, 9] == 0.0) & (h[:, 9] > 0.0)}
    if law == "robinson":  # the cap lands on the surface at the old
        flow = np.abs(hn[:, :9] - h[:, :9]).max(axis=1) > 0  # back stress
        xi_new = dev - h[:, 9:18].reshape(-1, 3, 3)
        j2 = 0.5 * (xi_new ** 2).sum(axis=(1, 2))
        return {"below": ~flow, "above": flow,
                "capped on the surface": flow & np.isclose(
                    np.sqrt(j2), spec["k0"], rtol=1e-9, atol=0.0)}
    if law == "viscoplastic_perzyna":
        flow = hn[:, 18] > h[:, 18]
        return {"elastic": ~flow, "flow": flow}
    return {"seeded": np.abs(h[:, :9]).sum(1) == 0.0,
            "nontrivial Fp": np.abs(h[:, :9] - np.eye(3).reshape(9)).max(1)
            > 1e-6,
            "slip": np.abs(hn[:, :9] - np.where(
                np.abs(h[:, :9]).sum(1, keepdims=True) > 1e-12, h[:, :9],
                np.eye(3).reshape(9))).max(1) > 0}


def _ref_fn(jm, kinem, dt):
    """The reference's law at the step's dt, by name (its element route
    passes dt positionally, which lands on Robinson's T: a fault the port
    does not carry over, test_robinson_takes_the_step_dt)."""
    fn = jm.evaluate_small if kinem == "linear" else jm.evaluate
    return fn if dt is None else (lambda x, h: fn(x, h, dt=dt))


@pytest.mark.parametrize("case", list(LAWS))
def test_law_matches_reference(case):
    """Stress and new history over N_STATES seeded states at 1e-12, every
    branch taken, and the stress's forward derivative along a seeded
    direction against ``jax.jvp`` at 1e-10 (crystal plasticity's floored
    g at dt 0.25 within the reference's own one-ulp spread,
    FLOORED_G_TOL and FLOORED_G_JVP_TOL)."""
    import jax
    import jax.numpy as jnp

    spec, kinem, dt = LAWS[case]
    jm, tm = _materials(spec)
    rng = np.random.default_rng(17)
    if kinem == "linear":
        arg, h = _small_states(spec["type"], tm.history_shape[0], rng)
    else:
        arg, h = _crystal_states(tm, rng, zero_g=dt is None
                                 or case.endswith("floored_g"))
    darg = _sym(rng.normal(size=arg.shape))
    ref = jax.vmap(_ref_fn(jm, kinem, dt))
    (sj, hj), (dj, _) = jax.jvp(lambda x: ref(x, jnp.asarray(h)),
                                (jnp.asarray(arg),), (jnp.asarray(darg),))
    fn = tm.evaluate_small if kinem == "linear" else tm.evaluate
    targ, th = torch.as_tensor(arg.transpose(1, 2, 0)), torch.as_tensor(h.T)
    st, ht = fn(targ, th, dt)
    tol = FLOORED_G_TOL if case.endswith("floored_g") else RTOL
    assert _rel(st.numpy().transpose(2, 0, 1), sj) <= tol
    assert _rel(ht.numpy().T, hj) <= tol
    for name, mask in _branches(spec["type"], spec, arg, h, np.asarray(sj),
                                np.asarray(hj)).items():
        assert mask.sum() >= 3, f"branch {name!r}: {mask.sum()} states"
    _, dt_ = torch.func.jvp(lambda x: fn(x, th, dt)[0], (targ,),
                            (torch.as_tensor(darg.transpose(1, 2, 0)),))
    assert _rel(dt_.numpy().transpose(2, 0, 1), dj) <= (
        FLOORED_G_JVP_TOL if case.endswith("floored_g") else JVP_TOL)


@pytest.mark.parametrize("T, dt", [(None, 1.0), (320.0, 0.5), (350.0, 2.0)])
def test_robinson_return_map_matches_the_law_by_name(T, dt):
    """Robinson's law with T and dt by name (thermal softening of the
    threshold on) against the reference's at 1e-12, and through
    ``evaluate_small`` with per-Gauss-point temperatures (TSI) around T."""
    import jax

    spec = {**ROBINSON, "omega_t": 2e-3, "t_ref": 300.0}
    jm, tm = _materials(spec)
    eps, h = _small_states("robinson", 18, np.random.default_rng(4))
    sj, hj = jax.vmap(lambda x, hh: jm.evaluate_small(x, hh, T=T, dt=dt))(
        eps, h)
    st, ht = tm.return_map(torch.as_tensor(eps.transpose(1, 2, 0)),
                           torch.as_tensor(h.T), T=T, dt=dt)
    assert _rel(st.numpy().transpose(2, 0, 1), sj) <= RTOL
    assert _rel(ht.numpy().T, hj) <= RTOL
    Tg = (T or 300.0) + np.random.default_rng(5).uniform(-50, 50, N_STATES)
    sj, hj = jax.vmap(lambda x, hh, tt: jm.evaluate_small(x, hh, T=tt,
                                                          dt=dt))(eps, h, Tg)
    st, ht = tm.evaluate_small(torch.as_tensor(eps.transpose(1, 2, 0)),
                               torch.as_tensor(h.T), dt,
                               T=torch.as_tensor(Tg))
    assert _rel(st.numpy().transpose(2, 0, 1), sj) <= RTOL
    assert _rel(ht.numpy().T, hj) <= RTOL


def test_robinson_takes_the_step_dt():
    """``evaluate_small(eps, h, dt)`` is Robinson's law at the step's dt
    (flow dt A <F>^n, recovery -dt R alpha), the reference's law with dt
    by name; the reference's element route, which passes dt positionally,
    binds it to T and flows at dt = 1, and lands elsewhere."""
    import jax

    jm, tm = _materials(ROBINSON)
    eps, h = _small_states("robinson", 18, np.random.default_rng(5))
    sj, hj = jax.vmap(lambda x, hh: jm.evaluate_small(x, hh, dt=0.5))(eps, h)
    sf, hf = jax.vmap(lambda x, hh: jm.evaluate_small(x, hh, 0.5))(eps, h)
    st, ht = tm.evaluate_small(torch.as_tensor(eps.transpose(1, 2, 0)),
                               torch.as_tensor(h.T), 0.5)
    assert _rel(st.numpy().transpose(2, 0, 1), sj) <= RTOL
    assert _rel(ht.numpy().T, hj) <= RTOL
    assert _rel(ht.numpy().T, hf) > 1e-3


def test_tie_helpers_take_the_reference_derivatives():
    """``maximum``, ``minimum``, ``clip`` and ``abs1`` against
    ``jnp.maximum``, ``jnp.minimum``, ``jnp.clip`` and ``jnp.abs``: values
    and forward derivatives at both bounds, at 0 and off the ties, with
    bounds that carry a derivative of their own."""
    import jax
    import jax.numpy as jnp

    x = np.array([-2.0, -1.0, -0.0, 0.0, 0.5, 1.0, 3.0])
    lo = np.array([-1.0, -1.0, 0.0, 0.0, 0.0, 0.0, -1.0])
    hi = np.array([1.0, 1.0, 1.0, 2.0, 0.5, 1.0, 3.0])
    tx, tlo, thi = np.ones(7), np.full(7, 3.0), np.full(7, -5.0)
    cases = {
        "maximum": (lambda a, b, c: jnp.maximum(a, b),
                    lambda a, b, c: mbase.maximum(a, b)),
        "maximum scalar": (lambda a, b, c: jnp.maximum(a, 0.0),
                           lambda a, b, c: mbase.maximum(a, 0.0)),
        "minimum": (lambda a, b, c: jnp.minimum(a, c),
                    lambda a, b, c: mbase.minimum(a, c)),
        "minimum scalar": (lambda a, b, c: jnp.minimum(a, 1.0),
                           lambda a, b, c: mbase.minimum(a, 1.0)),
        "clip": (lambda a, b, c: jnp.clip(a, b, c),
                 lambda a, b, c: mbase.clip(a, b, c)),
        "clip scalars": (lambda a, b, c: jnp.clip(a, -1.0, 1.0),
                         lambda a, b, c: mbase.clip(a, -1.0, 1.0)),
        "abs": (lambda a, b, c: jnp.abs(a), lambda a, b, c: mbase.abs1(a)),
    }
    for name, (ref, port) in cases.items():
        vj, dj = jax.jvp(ref, (x, lo, hi), (tx, tlo, thi))
        args = [torch.as_tensor(a) for a in (x, lo, hi)]
        vt, dt_ = torch.func.jvp(port, tuple(args), tuple(
            torch.as_tensor(a) for a in (tx, tlo, thi)))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj), name)
        np.testing.assert_array_equal(dt_.numpy(), np.asarray(dj), name)


@pytest.mark.parametrize("dtype, tol", [(torch.float64, 4e-16),
                                        (torch.float32, 2.5e-7)])
def test_ieee_functions_match_numpy(dtype, tol):
    """exp, cosh, sinh, log and pow from additions and products within a
    few ulps of numpy's float64 values, over the ranges the laws call them
    on; their forward derivatives those of the functions."""
    xt = torch.linspace(-50.0, 50.0, 20001, dtype=dtype)
    x = xt.double().numpy()
    c, s = gm.cosh_sinh_ieee(xt)
    pos = torch.as_tensor(np.geomspace(
        1e-300 if dtype == torch.float64 else 1e-30, 1e30, 4001), dtype=dtype)
    small = pos.double().numpy()
    want = {"exp": (gm.exp_ieee(xt), np.exp(x)), "cosh": (c, np.cosh(x)),
            "sinh": (s, np.sinh(x)),
            "log": (gm.log_ieee(pos), np.log(small))}
    bt = torch.linspace(0.0, 3.0, 3001, dtype=dtype)
    base = bt.double().numpy()
    for y in (1.0, 2.0, 5.0, 20.0, 1.5, 0.3):
        want[f"pow {y}"] = (gm.pow_ieee(bt, y), base ** y)
    normal = torch.finfo(dtype).tiny
    for name, (got, ref) in want.items():
        keep = np.abs(ref) >= normal  # a power below float's normal range
        err = np.abs(got.double().numpy() - ref)[keep] / np.abs(ref[keep])
        scale = 4.0 if name == "log" else 8.0 if name.startswith("pow") \
            else 1.0
        assert err.max() <= scale * tol, name
    assert gm.pow_ieee(torch.zeros(1, dtype=dtype), 1.5).item() == 0.0
    assert gm.exp_ieee(torch.tensor([-800.0, 800.0],
                                    dtype=dtype)).tolist() == [0.0, math.inf]
    one = torch.ones_like(xt)
    _, d = torch.func.jvp(gm.exp_ieee, (xt,), (one,))
    assert (torch.abs(d - gm.exp_ieee(xt)) <= 4 * tol * gm.exp_ieee(xt)).all()
    _, (dc, ds) = torch.func.jvp(gm.cosh_sinh_ieee, (xt,), (one,))
    assert (torch.abs(dc - s) <= 4 * tol * c).all()
    assert (torch.abs(ds - c) <= 4 * tol * c).all()
    _, dp = torch.func.jvp(lambda b: gm.pow_ieee(b, 1.5), (bt,),
                           (torch.ones_like(bt),))
    ref = 1.5 * np.sqrt(base)
    assert np.abs(dp.double().numpy() - ref).max() <= 16 * tol * ref.max()


def _box_deck(law, kinem):
    """A 2x2x2 hex8 box of ``law`` (statics, direct), as a deck dict."""
    return {"problem": {"type": "structure"},
            "structural_dynamic": {"dynamictype": "statics", "kinem": kinem,
                                   "numstep": 1, "timestep": 0.5},
            "solver": {"method": "direct"},
            "functions": {1: "1.0 + 0.06 * t"},
            "materials": {1: law},
            "geometry": {"generator": {"kind": "box", "nx": 2, "ny": 2,
                                       "nz": 2, "cell": "hex8", "mat": 1}},
            "conditions": {"dirichlet": [{"nodes": "zmin",
                                          "onoff": [1, 1, 1],
                                          "val": [0, 0, 0]}]}}


@pytest.mark.parametrize("spec, kinem", [
    (DP, "nonlinear"), (LEMAITRE, "nonlinear"), (GTN, "nonlinear"),
    (SMA, "nonlinear"), (ROBINSON, "nonlinear"), (PERZYNA, "nonlinear"),
    (CRYSTAL, "linear")], ids=lambda v: v if isinstance(v, str)
    else v["type"])
def test_law_under_the_kinematics_it_lacks_is_refused(spec, kinem):
    """The reference has one form per law (``evaluate_small`` or
    ``evaluate``): the other kinematics is refused, naming the law, before
    the field is built."""
    law = type(make_material(dict(spec))).__name__
    deck = deck_mod.load(yaml.safe_load(yaml.safe_dump(_box_deck(spec,
                                                                 kinem))))
    with pytest.raises(NotImplementedError,
                       match=f"{law} under kinem {kinem!r}"):
        structure_driver.check_supported(deck)


def test_thermoplastic_law_is_refused_by_name():
    """thermoplastic_j2 (ported with TSI's temperatures, a small-strain
    law) under nonlinear kinematics is refused, naming it."""
    deck = deck_mod.load(yaml.safe_load(yaml.safe_dump(_box_deck({
        "type": "thermoplastic_j2", "youngs": 1000.0, "nue": 0.3,
        "yield_stress": 5.0}, "nonlinear"))))
    with pytest.raises(NotImplementedError,
                       match="ThermoPlasticJ2 under kinem 'nonlinear'"):
        structure_driver.check_supported(deck)


def test_crystal_initial_state_is_the_references():
    """[I, g0] at every Gauss point: the port's ``init_state`` equals the
    reference's ``init_history`` through ``convert.state_from_jax``, and
    the crystal deck's field starts from it."""
    jm, tm = _materials(CRYSTAL)
    want = np.asarray(jm.init_history(24))
    np.testing.assert_array_equal(tm.init_history(24).numpy(), want)
    path = os.path.join(ROOT, "decks", "crystal_plasticity_shear.yaml")
    f = structure_driver.build_field(deck_mod.load(path), device="cpu")
    hist = ps.init_state(f)["hist"]
    (key, h), = hist.items()
    ref = np.asarray(jm.init_history(h.shape[0] * h.shape[1])).reshape(
        h.shape)
    conv = convert.state_from_jax({
        **{k: np.zeros(f.ndof) for k in convert.STATE_FIELDS}, "t": 0.0,
        "step": 0, "hist": {key: ref}}, None)
    np.testing.assert_array_equal(h.numpy(), conv["hist"][key])


# gate deck -> (anchors met, Newton iterations, substeps), the reference's
# counts of its own CLI run
DECKS = {"druckerprager_shear": (3, 16, 4),
         "gtn_voided_tension": (1, 27, 8),
         "lemaitre_damage_bar": (1, 29, 8),
         "robinson_relaxation": (3, 8, 10),
         "sma_superelastic_cycle": (3, 95, 15),
         "crystal_plasticity_shear": (3, 24, 6)}


@pytest.mark.parametrize("name", list(DECKS))
def test_gate_deck_through_the_cli(name, capsys):
    """Each deck through ``app.main`` on the CPU in float64 with the
    reference's Newton iterations and substeps, meeting its anchors.  The
    GTN and Lemaitre decks fix no rotation about the z axis (node 1 lies on
    it): their stiffness is singular, and their x- and y-anchors carry the
    reference's rotation, set by the rounding of its singular LU (one ulp
    of E moves them by 0.04 in the reference's own run).  There the port
    must meet the dispz anchor and the rotation-free sum of the two others
    (dispx at x = 1 plus dispy at x = 1, y = 0: a rotation w adds -w y and
    w x), and the rotation must be a null vector of the tangent."""
    n_anchors, newton, substeps = DECKS[name]
    path = os.path.join(ROOT, "decks", f"{name}.yaml")
    main([path, "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"result tests: {n_anchors}/3 passed" in out
    assert re.search(rf"\d+ steps \({substeps} substeps\), {newton} Newton "
                     rf"its", out), out
    rel = f"decks/{name}.yaml"
    if rel not in ROTATION_FREE:
        return
    lines = read_node_lines(out)
    assert abs(lines[(2, "dispz")][0] - lines[(2, "dispz")][1]) \
        <= lines[(2, "dispz")][2]
    got = want = tol = 0.0
    for key in ROTATION_FREE[rel]:
        actual, expected, t = lines[key]
        got, want, tol = got + actual, want + expected, tol + t
    assert abs(got - want) <= tol
    f = structure_driver.build_field(deck_mod.load(path), device="cpu")
    state = ps.init_state(f)
    X = torch.as_tensor(f.disc.coords, dtype=f.dtype)
    rot = torch.stack([-X[:, 1], X[:, 0], torch.zeros_like(X[:, 0])], 1)
    rot = rot.reshape(-1)
    assert not bool(torch.where(f.free, 0.0, rot).abs().max() > 0)
    rnd = torch.where(f.free, torch.randn(f.ndof, dtype=f.dtype), 0.0)
    u = torch.zeros(f.ndof, dtype=f.dtype)
    k_rot = f.tangent(u, rot, 0.0, state["hist"], 0.125)
    k_rnd = f.tangent(u, rnd, 0.0, state["hist"], 0.125)
    assert float(k_rot.abs().max()) <= 1e-12 * float(k_rnd.abs().max())


@pytest.mark.parametrize("spec, kinem", [(GTN, "linear"),
                                         (CRYSTAL, "nonlinear")],
                         ids=["gtn", "crystal"])
def test_halved_step_restarts_from_the_seeded_history(spec, kinem):
    """``divercont: halve_step`` on a law whose history does not start at
    zero (GTN's lazy f0, crystal plasticity's [I, g0]): the halves restart
    from the state before the failed step, seeded history unchanged, and
    give bitwise two half steps."""
    data = _box_deck(spec, kinem)
    load = [0.03, 0, 0.01] if kinem == "linear" else [0.01, 0, 0.005]
    data["conditions"]["dirichlet"].append(
        {"nodes": "zmax", "onoff": [1, 0, 1], "val": load,
         "funct": [1, 0, 1]})
    f = structure_driver.build_field(deck_mod.load(data), device="cpu")
    state0 = ps.compute_initial_state(f, ps.init_state(f))
    h0 = {k: v.clone() for k, v in state0["hist"].items()}
    seen = []

    def make_step(dt):
        real = ps.make_step(f, dt)

        def step(state):
            new, stats = real(state)
            seen.append((dt, state, new))
            return new, (dict(stats, converged=False) if dt == 1.0
                         else stats)
        return step

    state, agg = driver.time_loop("structure", state0, make_step, 1.0, 1,
                                  divercont="halve_step", verbose=False)
    assert agg["halvings"] == 1 and [s[0] for s in seen] == [1.0, 0.5, 0.5]
    key = next(iter(h0))
    assert seen[1][1] is state0 and torch.equal(state0["hist"][key], h0[key])
    half = ps.make_step(f, 0.5)
    want = half(half(state0)[0])[0]
    assert torch.equal(state["hist"][key], want["hist"][key])
    assert torch.equal(state["d"], want["d"])
    h = state["hist"][key]
    if kinem == "linear":  # f >= f0 everywhere, grown where it yielded
        assert float(h[..., 10].min()) >= spec["f0"]
        assert float(h[..., 9].max()) > 0.0
    else:  # Fp moved off I, det Fp = 1 to the expm3 truncation
        Fp = h[..., :9].reshape(-1, 3, 3)
        assert float((Fp - torch.eye(3, dtype=Fp.dtype)).abs().max()) > 0
        assert float((torch.linalg.det(Fp) - 1.0).abs().max()) < 1e-6
