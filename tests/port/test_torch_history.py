"""Slice 4e: Gauss-point history (viscoelasthyper, plasticlinelast,
plasticnlnlogneohooke), the isoogden and volsussmanbathe summands,
spring-dashpots and the penalty volume constraint, on the CPU in float64.

Held against the JAX package eagerly (no jit, no step): each history law's
stress and new history under ``jax.vmap`` of its ``evaluate`` /
``evaluate_small`` at 1e-12 relative over a few hundred seeded states that
take the elastic and the plastic branch, its forward derivative against
``jax.jvp`` at 1e-10; the two summands' stress against ``jax.grad`` of the
reference's energy at 1e-12; ``VolumeConstraint``'s volume, force and
tangent on the 2x2x2 box; and the field's internal force and new history
against the reference's ``SolidField.internal_force(u, history, dt)`` on a
2x2x2 box per law.  The rest is pure torch: the float32 Ogden tangent at
coincident stretches, the spring-dashpot and constraint terms of the steps
against central differences of their residuals, and a halved step that
restarts from the old history.  The six decks of the slice meet their
anchors in tests/port/test_torch_deck.py.
"""

import numpy as np
import pytest
import torch
import yaml

from fourc_tpu_torch.io import deck as deck_mod
from fourc_tpu_torch.materials import make_material
from fourc_tpu_torch.physics import driver, solid as ps
from fourc_tpu_torch.physics import solid_lattice as psl
from fourc_tpu_torch.physics import structure_driver

RTOL, JVP_TOL = 1e-12, 1e-10
N_STATES = 300
LAWS = {  # name -> (deck spec, kinematics, dt of the call)
    "viscoelasthyper": ({"type": "viscoelasthyper", "taus": [1.0],
                         "betas": [0.5], "material": {
                             "type": "neohooke", "youngs": 100.0,
                             "nue": 0.3}}, "nonlinear", 0.5),
    "viscoelasthyper_no_dt": ({"type": "viscoelasthyper", "taus": [1.0, 0.3],
                               "betas": [0.5, 0.2], "material": {
                                   "type": "neohooke", "youngs": 100.0,
                                   "nue": 0.3}}, "nonlinear", None),
    "plasticlinelast": ({"type": "plasticlinelast", "youngs": 1000.0,
                         "nue": 0.3, "yield_stress": 5.0, "isohard": 50.0,
                         "kinhard": 30.0}, "linear", None),
    "plasticnlnlogneohooke": ({"type": "plasticnlnlogneohooke",
                               "youngs": 1000.0, "nue": 0.3,
                               "yield_stress": 10.0, "isohard": 50.0},
                              "nonlinear", None),
}
OGDEN = {"type": "elasthyper", "density": 1.0, "summands": [
    {"type": "isoogden", "mue": 80.0, "alpha": 2.5},
    {"type": "volsussmanbathe", "kappa": 800.0}]}


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


def _states(name, nh, rng):
    """N_STATES strains (eps, or C = F^T F) and histories, (N, 3, 3) and
    (N, nh): strains of all sizes, so that both branches of a return map
    are taken; the plastic histories symmetric, as a return map leaves
    them."""
    scale = np.geomspace(1e-5, 0.1, N_STATES)[:, None, None]
    H = rng.normal(size=(N_STATES, 3, 3)) * scale
    if name == "plasticlinelast":
        arg = _sym(H) * 0.2
        h = np.zeros((N_STATES, nh))
        h[:, :9] = _sym(rng.normal(size=(N_STATES, 3, 3)) * 2e-3).reshape(
            -1, 9)
        h[:, 9:18] = _sym(rng.normal(size=(N_STATES, 3, 3))).reshape(-1, 9)
        h[:, 18] = np.abs(rng.normal(size=N_STATES)) * 1e-2
    else:
        F = np.eye(3) + H
        arg = np.einsum("nki,nkj->nij", F, F)
        h = rng.normal(size=(N_STATES, nh)) * (
            1.0 if name.startswith("visco") else 1e-3)
        if name == "plasticnlnlogneohooke":
            h[:, 6] = np.abs(h[:, 6])
    h[0] = 0.0
    arg[0] = np.eye(3) if name != "plasticlinelast" else 0.0
    return arg, h


def _ref_fn(jm, kinem, dt):
    fn = jm.evaluate_small if kinem == "linear" else jm.evaluate
    return fn if dt is None else (lambda x, h: fn(x, h, dt))


def _port_fn(tm, kinem, dt):
    fn = tm.evaluate_small if kinem == "linear" else tm.evaluate
    return lambda x, h: fn(x, h, dt)


@pytest.mark.parametrize("name", list(LAWS))
def test_history_law_matches_reference(name):
    """Stress and new history of a few hundred states against the
    reference's law under ``jax.vmap`` (1e-12), and the stress's forward
    derivative along a seeded direction against ``jax.jvp`` (1e-10)."""
    import jax
    import jax.numpy as jnp

    spec, kinem, dt = LAWS[name]
    jm, tm = _materials(spec)
    rng = np.random.default_rng(11)
    arg, h = _states(name, tm.history_shape[0], rng)
    darg = _sym(rng.normal(size=arg.shape))
    ref = jax.vmap(_ref_fn(jm, kinem, dt))
    (sj, hj), (dj, _) = jax.jvp(lambda x: ref(x, jnp.asarray(h)),
                                (jnp.asarray(arg),), (jnp.asarray(darg),))
    port = _port_fn(tm, kinem, dt)
    targ, th = torch.as_tensor(arg.transpose(1, 2, 0)), torch.as_tensor(h.T)
    st, ht = port(targ, th)
    assert _rel(st.numpy().transpose(2, 0, 1), sj) <= RTOL
    assert _rel(ht.numpy().T, hj) <= RTOL
    if name.startswith("plastic"):  # both branches taken
        k = 18 if name == "plasticlinelast" else 6
        yielded = np.asarray(hj)[:, k] > h[:, k]
        assert 0.1 < yielded.mean() < 0.9
    _, dt_ = torch.func.jvp(lambda x: port(x, th)[0], (targ,),
                            (torch.as_tensor(darg.transpose(1, 2, 0)),))
    assert _rel(dt_.numpy().transpose(2, 0, 1), dj) <= JVP_TOL


def test_max0_keeps_the_half_derivative_at_a_tie():
    """max(x, 0) as the laws take it, ``maximum(x, 0.0)``."""
    from fourc_tpu_torch.materials.base import maximum

    x = torch.tensor([-1.0, 0.0, 2.0], dtype=torch.float64)
    val, der = torch.func.jvp(lambda a: maximum(a, 0.0), (x,),
                              (torch.ones_like(x),))
    assert val.tolist() == [0.0, 0.0, 2.0]
    assert der.tolist() == [0.0, 0.5, 1.0]


def _strains(rng, n=200):
    """Green-Lagrange strains (n, 3, 3): random, and the ties C = I and a
    uniaxial stretch with equal lateral stretches."""
    F = np.eye(3) + rng.normal(size=(n, 3, 3)) * 0.15
    E = 0.5 * (np.einsum("nki,nkj->nij", F, F) - np.eye(3))
    E[0] = 0.0
    E[1] = np.diag([0.1, -0.045, -0.045])
    return E


def test_ogden_summands_match_the_reference_energy():
    """S = 2 dpsi/dC of the reference's psi (``jax.grad``, its eigenvalue
    jitter included) at 1e-12, ties included; the forward derivative
    against ``jax.jvp`` at 1e-10 where the stretches are apart (at a tie
    the reference's derivative through ``eigvalsh`` loses digits), and
    against a central difference at the ties."""
    import jax
    import jax.numpy as jnp

    jm, tm = _materials(OGDEN)
    rng = np.random.default_rng(5)
    E = _strains(rng)
    dE = _sym(rng.normal(size=E.shape))
    Ej, Et = jnp.asarray(E), torch.as_tensor(E.transpose(1, 2, 0))
    dEt = torch.as_tensor(dE.transpose(1, 2, 0))

    def ref(e):
        return jax.vmap(lambda x: 2.0 * jax.grad(jm.psi)(
            2.0 * x + jnp.eye(3)))(e)

    sj, dj = jax.jvp(ref, (Ej,), (jnp.asarray(dE),))
    st, dt_ = torch.func.jvp(tm.pk2_from_E, (Et,), (dEt,))
    assert _rel(st.numpy().transpose(2, 0, 1), sj) <= RTOL
    assert _rel(dt_[..., 2:].numpy().transpose(2, 0, 1), dj[2:]) <= JVP_TOL
    h = 1e-6
    fd = (tm.pk2_from_E(Et[..., :2] + h * dEt[..., :2])
          - tm.pk2_from_E(Et[..., :2] - h * dEt[..., :2])) / (2 * h)
    assert _rel(dt_[..., :2].numpy(), fd.numpy()) <= 1e-8


def test_ogden_float32_tangent_is_finite_at_ties():
    """In float32 the jitter vanishes and the stretches tie exactly: the
    tangent stays finite and within float32 rounding of float64's."""
    _, tm = _materials(OGDEN)
    rng = np.random.default_rng(6)
    E = _strains(rng, n=2)
    dE = torch.as_tensor(_sym(rng.normal(size=E.shape)).transpose(1, 2, 0))
    E = torch.as_tensor(E.transpose(1, 2, 0))
    _, d64 = torch.func.jvp(tm.pk2_from_E, (E,), (dE,))
    S32, d32 = torch.func.jvp(tm.pk2_from_E, (E.float(),), (dE.float(),))
    assert torch.isfinite(S32).all() and torch.isfinite(d32).all()
    assert _rel(d32.double().numpy(), d64.numpy()) <= 1e-5


def _box_deck(law, kinem, **conditions):
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
                                          "val": [0, 0, 0]}],
                           **conditions}}


def _fields(data):
    """The reference's and the port's fields of one deck dict."""
    from fourc_tpu.io import deck as jdeck
    from fourc_tpu.physics import structure_driver as jsd

    dj = jdeck.load(yaml.safe_load(yaml.safe_dump(data)))
    dp = deck_mod.load(yaml.safe_load(yaml.safe_dump(data)))
    return jsd.build_field(dj), structure_driver.build_field(dp, device="cpu")


@pytest.mark.parametrize("name", [n for n in LAWS if n != "viscoelasthyper"
                                  "_no_dt"])
def test_field_internal_force_matches_reference(name):
    """``SolidField.internal_force(u, history, dt)`` of both packages on a
    2x2x2 box: the force and the new history at 1e-12."""
    import jax.numpy as jnp

    spec, kinem, dt = LAWS[name]
    fj, fp = _fields(_box_deck(spec, kinem))
    assert fp.blocks and fp.blocks[0].model is None  # the element route
    rng = np.random.default_rng(8)
    u = rng.normal(size=fp.ndof) * (0.005 if kinem == "linear" else 0.03)
    hist = {key: np.asarray(h) for key, h in ps.init_state(fp)["hist"]
            .items()}
    key = next(iter(hist))
    hist[key] = rng.normal(size=hist[key].shape) * (
        1.0 if name.startswith("visco") else 1e-3)
    if name == "plasticlinelast":  # symmetric plastic strain, back stress
        h = hist[key]
        for s in (slice(0, 9), slice(9, 18)):
            h[..., s] = _sym(h[..., s].reshape(h.shape[:2] + (3, 3))) \
                .reshape(h.shape[:2] + (9,))
        h[..., 9:18] *= 1e3
    hist[key][..., -1] = np.abs(hist[key][..., -1])
    fj_u, hj = fj.internal_force(jnp.asarray(u), history={
        key: jnp.asarray(hist[key])}, dt=dt)
    fp_u, hp = fp.internal_force(torch.as_tensor(u), {
        key: torch.as_tensor(hist[key])}, dt, with_history=True)
    assert _rel(fp_u.numpy(), fj_u) <= RTOL
    assert _rel(hp[key].numpy(), hj[key]) <= RTOL


def test_volume_constraint_matches_reference():
    """Volume, penalty force and its derivative (the reference's by
    ``jax.jvp`` of its force) on the 2x2x2 box's xmax faces at 1e-12."""
    import jax
    import jax.numpy as jnp

    data = _box_deck({"type": "neohooke", "youngs": 10.0, "nue": 0.3},
                     "nonlinear", constraint=[{
                         "kind": "volume", "faces": "xmax", "penalty": 1e4,
                         "funct": 1}])
    from fourc_tpu.io import deck as jdeck
    from fourc_tpu.physics.constraints import VolumeConstraint as JVolume

    from fourc_tpu_torch.physics.constraints import VolumeConstraint

    dj, dp = jdeck.load(data), deck_mod.load(data)
    args = [(d.conditions["structure"]["constraint"][0]["faces"],
             d.disc["structure"].coords, 3, 1e4, 1, d.functions)
            for d in (dj, dp)]
    cj, cp = JVolume(*args[0]), VolumeConstraint(*args[1])
    assert cp.V0 == pytest.approx(cj.V0, rel=RTOL)
    rng = np.random.default_rng(9)
    u, v = rng.normal(size=(2, cp.coords.numel())) * 0.05
    t = 0.37
    uj, ut = jnp.asarray(u), torch.as_tensor(u)
    assert float(cp.volume(ut)) == pytest.approx(float(cj.volume(uj)),
                                                 rel=RTOL)
    fj_, kv = jax.jvp(lambda x: cj.force(x, t), (uj,), (jnp.asarray(v),))
    assert _rel(cp.force(ut, t).numpy(), fj_) <= RTOL
    assert _rel(cp.linearize(ut, t)(torch.as_tensor(v)).numpy(), kv) <= RTOL


@pytest.mark.parametrize("dyntype", ["statics", "genalpha", "onesteptheta"])
def test_springs_and_constraint_operators_are_the_residuals_derivative(
        dyntype, monkeypatch):
    """Each implicit step's Newton operator, with a spring-dashpot support
    and the volume constraint on a lattice box (B1-B3's twins), is the
    derivative of its residual: against a central difference.  The
    dashpot is in the statics and gen-alpha residuals only (the
    reference's u_old)."""
    data = _box_deck({"type": "neohooke", "youngs": 10.0, "nue": 0.3,
                      "density": 1.0}, "nonlinear",
                     constraint=[{"kind": "volume", "faces": "xmax",
                                  "penalty": 1e2, "funct": 1}],
                     spring_dashpot=[{"nodes": "xmax",
                                      "stiffness": [5.0, 0, 20.0],
                                      "viscosity": [0, 3.0, 4.0]}])
    data["structural_dynamic"]["dynamictype"] = dyntype
    f = structure_driver.build_field(deck_mod.load(data), device="cpu")
    assert f.lattice is not None  # springs and constraints ride the lattice
    rng = np.random.default_rng(10)

    def rand(scale):
        return f.to_lattice(torch.as_tensor(rng.normal(size=f.ndof) * scale))

    state = {"d": rand(0.02), "v": rand(0.5), "a": rand(1.0), "t": 0.1,
             "step": 0, "fext": rand(1.0), "hist": {}}
    state["fint"] = f.internal_force(state["d"])
    captured = {}

    def newton(residual, u0, free, M, params, matvec, batched=False):
        captured.update(residual=residual, matvec=matvec)
        return u0, {"iters": 0, "lin_iters": 0, "resnorm": 0.0,
                    "dispnorm": 0.0, "converged": True}

    dt = 0.05
    monkeypatch.setattr(psl, "newton_solve", newton)
    ps.make_step(f, dt)(state)
    residual, matvec = captured["residual"], captured["matvec"]
    u, du = rand(0.03), rand(1.0)
    h = 1e-6
    fd = (residual(u + h * du) - residual(u - h * du)) / (2 * h)
    assert _rel(matvec(u, du).numpy(), fd.numpy()) <= 1e-7
    # the dashpot's term: present where the reference passes u_old
    dash = f.internal_force(u, dt=dt, u_old=state["d"]) \
        - f.internal_force(u)
    assert float(dash.abs().max()) > 0
    r0 = residual(u)
    f.c_spring = torch.zeros_like(f.c_spring)
    moved = float((residual(u) - r0).abs().max())
    assert (moved > 0) == (dyntype != "onesteptheta")


def test_constraint_enters_the_state_as_the_reference_has_it():
    """f_ext of the initial state and of a converged step carries minus the
    constraint's force at the state's d (the reference's
    ``external_force(t, u)``)."""
    data = _box_deck({"type": "neohooke", "youngs": 10.0, "nue": 0.3},
                     "nonlinear", constraint=[{
                         "kind": "volume", "faces": "xmax", "penalty": 1e4,
                         "funct": 1}])
    f = structure_driver.build_field(deck_mod.load(data), device="cpu")
    state = ps.compute_initial_state(f, ps.init_state(f))
    state, stats = ps.make_step(f, 0.5)(state)
    assert stats["converged"]
    d = f.from_lattice(state["d"])
    want = f.from_lattice(f.external_force(0.5)) - f.constraints[0].force(
        d, 0.5)
    assert _rel(f.from_lattice(state["fext"]).numpy(), want.numpy()) <= RTOL


def test_halved_step_restarts_from_the_old_history():
    """``divercont: halve_step``: a step that fails is retried in two
    halves from the state before it, whose history no step changed in
    place; the result is bitwise that of two half steps."""
    spec, kinem, _ = LAWS["plasticlinelast"]
    data = _box_deck(spec, kinem)
    data["conditions"]["dirichlet"].append(
        {"nodes": "zmax", "onoff": [1, 0, 0], "val": [0.02, 0, 0],
         "funct": [1, 0, 0]})
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
    assert not torch.equal(seen[0][2]["hist"][key], h0[key])  # it yielded
    assert seen[1][1] is state0 and torch.equal(state0["hist"][key], h0[key])
    half = ps.make_step(f, 0.5)
    want = half(half(state0)[0])[0]
    assert torch.equal(state["hist"][key], want["hist"][key])
    assert torch.equal(state["d"], want["d"])
    assert float(state["hist"][key][..., 18].max()) > 0  # kappa grew


def test_history_state_converts_from_the_reference():
    """``convert.state_from_jax`` carries the reference's history."""
    from fourc_tpu_torch import convert

    hist = {"hex8": np.arange(24.0).reshape(1, 8, 3)}
    state = {k: np.zeros(3) for k in psl.STATE_FIELDS}
    state.update(t=0.5, step=2, hist=hist)
    out = convert.state_from_jax(state, None)
    np.testing.assert_array_equal(out["hist"]["hex8"], hist["hex8"])


@pytest.mark.parametrize("tech", ["fbar", "eas_mild"])
def test_history_law_under_a_tech_is_refused(tech):
    spec, kinem, _ = LAWS["plasticnlnlogneohooke"]
    data = _box_deck(spec, kinem)
    data["structural_dynamic"]["tech"] = tech
    with pytest.raises(NotImplementedError, match="not ported") as exc:
        structure_driver.check_supported(deck_mod.load(data))
    assert f"PlasticLogFiniteStrain (history) under tech {tech!r}" in str(
        exc.value)


def test_sqrt_rn_is_correctly_rounded_from_either_neighbour(monkeypatch):
    """``sqrt_rn`` returns numpy's (IEEE, correctly rounded) square root,
    also when torch.sqrt lands one ulp off either way, as a card's may; its
    forward derivative is t / (2 sqrt(x)) to the bit."""
    from fourc_tpu_torch.ops import common as gm

    rng = np.random.default_rng(12)
    x = np.concatenate([rng.uniform(0.5, 2.0, 50000),
                        10.0 ** rng.uniform(-30, 30, 50000)])
    want = torch.as_tensor(np.sqrt(x))
    xt = torch.as_tensor(x)
    assert torch.equal(gm.sqrt_rn(xt), want)
    sqrt = torch.sqrt
    for towards in (0.0, float("inf")):
        off = torch.nextafter(want, torch.full_like(want, towards))
        monkeypatch.setattr(torch, "sqrt", lambda t, _o=off: _o.clone())
        assert torch.equal(gm.sqrt_rn(xt), want)
    monkeypatch.setattr(torch, "sqrt", sqrt)
    t = torch.as_tensor(rng.normal(size=x.size))
    val, der = torch.func.jvp(gm.sqrt_rn, (xt,), (t,))
    assert torch.equal(val, want) and torch.equal(der, t / (2.0 * want))
