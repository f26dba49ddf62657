"""Slice 5a: the scalar-transport and thermal field on the CPU in float64.

Held against the JAX package eagerly (no jit, no step): the SUPG parameter
of every kind over the Peclet branches, the element length, the element
residual on a 3x2x2 box with and without convection and SUPG, the lumped
capacity, the assembled field (residual with a body source, capacity,
Jacobi diagonal), the Dirichlet rates of a ramp and a sine, the
multifunction, the
thermal laws and the two plasticity laws that take a temperature
(thermoplastic J2, Robinson) with per-state temperatures, all at 1e-12
relative and their forward derivatives at 1e-10.  Pure torch: the
residual's linear part equals forward mode's tangent to the bit, the
multifunction's range and knot rules, and the refusals.
"""

import numpy as np
import pytest
import torch
import yaml

from fourc_tpu_torch.core import gridgen
from fourc_tpu_torch.core.cells import get_cell
from fourc_tpu_torch.core.conditions import DirichletBC, DirichletHandler
from fourc_tpu_torch.core.functions import FunctionManager, MultiFunctionOfTime
from fourc_tpu_torch.io import deck as deck_mod
from fourc_tpu_torch.materials import make_material
from fourc_tpu_torch.ops import scalar as ops
from fourc_tpu_torch.ops.solid import element_geometry
from fourc_tpu_torch.physics import driver
from fourc_tpu_torch.physics import scalar_transport as st

RTOL, JVP_TOL = 1e-12, 1e-10


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / (scale if scale else 1.0))


def _box(nx=3, ny=2, nz=2, seed=0):
    """A 3x2x2 hex8 box with jittered interior-free nodes: element
    coordinates for the reference (E, 8, 3) and for the port (24, E)."""
    d = gridgen.box(nx, ny, nz, lo=(0.0, 0.0, 0.0), hi=(1.5, 0.8, 1.1))
    X = d.coords + np.random.default_rng(seed).uniform(
        -0.05, 0.05, d.coords.shape)
    Xe = X[d.blocks["hex8"].conn]
    return d, X, Xe, torch.as_tensor(Xe.reshape(len(Xe), -1).T.copy())


def _port_geometry(Xt):
    G, wdet = element_geometry(Xt, get_cell("hex8"))
    return G, wdet, torch.as_tensor(np.asarray(get_cell("hex8").N))


def _ref_geometry(Xe):
    import jax.numpy as jnp

    from fourc_tpu.core.cells import get_cell as jcell
    from fourc_tpu.ops import common as jgm

    cell = jcell("hex8")
    G, detJ = jgm.iso_gradients(jnp.asarray(Xe), cell.dN)
    return cell, G, jgm.weighted(detJ, cell.gauss_weights)


# velocities (E, g, 3) and diffusivities that put the Gauss points on each
# branch: Peclet above and below 1, |u| ~ 0 (the volume length)
VELOCITY_CASES = {
    "convective": (lambda g: np.stack([5.0 + g[..., 0], 0.3 * g[..., 1],
                                       -2.0 + 0 * g[..., 2]], -1), 0.01),
    "diffusive": (lambda g: 0.05 * np.stack([g[..., 1], g[..., 2],
                                             g[..., 0]], -1), 1.0),
    "mixed": (lambda g: np.stack([np.where(g[..., 0] > 0.7, 3.0, 1e-14),
                                  0 * g[..., 0], 0 * g[..., 0]], -1), 0.1),
}


def _gauss_velocity(Xe, case):
    from fourc_tpu.core.cells import get_cell as jcell

    xg = np.einsum("ga,ead->egd", np.asarray(jcell("hex8").N), Xe)
    fn, diff = VELOCITY_CASES[case]
    return fn(xg), diff


@pytest.mark.parametrize("case", list(VELOCITY_CASES))
@pytest.mark.parametrize("kind", ops.TAU_KINDS)
@pytest.mark.parametrize("dt", [None, 0.05])
def test_calc_tau_and_char_length_match_reference(case, kind, dt):
    import jax.numpy as jnp

    from fourc_tpu.ops import scalar as jops

    _, _, Xe, Xt = _box()
    vel, diff = _gauss_velocity(Xe, case)
    _, Gj, wj = _ref_geometry(Xe)
    hj = jops.char_length(jnp.asarray(vel), Gj, wj, 3)
    tauj = jops.calc_tau(jnp.asarray(vel), diff, 2.5, hj, dt, kind=kind)
    G, wdet, _ = _port_geometry(Xt)
    vt = torch.as_tensor(vel.transpose(2, 1, 0).copy())
    h = ops.char_length(vt, G, wdet)
    assert _rel(h.numpy().T, hj) <= RTOL
    tau = ops.calc_tau(vt, diff, 2.5, h, dt, kind)
    assert _rel(tau.numpy().T, tauj) <= RTOL
    if kind == "franca_valentin":  # both Peclet branches where it matters
        pe = (2.5 * np.linalg.norm(vel, axis=-1) * np.asarray(hj)
              / (3.0 * 2.0 * diff))
        assert case != "convective" or (pe > 1).all()
        assert case != "diffusive" or (pe < 1).all()


def test_char_length_without_velocity_is_the_volume_length():
    from fourc_tpu.ops import scalar as jops

    _, _, Xe, Xt = _box()
    _, Gj, wj = _ref_geometry(Xe)
    G, wdet, _ = _port_geometry(Xt)
    assert _rel(ops.char_length(None, G, wdet).numpy().T,
                jops.char_length(None, Gj, wj, 3)) <= RTOL


RESIDUAL_CASES = {
    "diffusion": (None, "zero", None, False),
    "reaction_source": (None, "zero", 0.1, True),
    "convection": ("convective", "zero", None, False),
    "supg_taylor": ("convective", "taylor", 0.05, True),
    "supg_franca_valentin": ("mixed", "franca_valentin", None, False),
    "supg_franca_valentin_dt": ("convective", "franca_valentin", 0.05, True),
}


def _residual_inputs(case, rng):
    _, _, Xe, Xt = _box()
    vcase, kind, dt, extras = RESIDUAL_CASES[case]
    E = Xe.shape[0]
    phie, phidote = rng.normal(size=(E, 8)), rng.normal(size=(E, 8))
    vel = diff = None
    if vcase is not None:
        vel, diff = _gauss_velocity(Xe, vcase)
    diff = 0.7 if diff is None else diff
    source = rng.normal(size=(E, 8)) if extras else None
    return Xe, Xt, phie, phidote, vel, diff, kind, dt, source


@pytest.mark.parametrize("case", list(RESIDUAL_CASES))
def test_scalar_residual_matches_reference(case):
    import jax.numpy as jnp

    from fourc_tpu.ops import scalar as jops

    rng = np.random.default_rng(3)
    Xe, Xt, phie, phidote, vel, diff, kind, dt, source = \
        _residual_inputs(case, rng)
    cell, _, _ = _ref_geometry(Xe)
    rc = 0.4 if source is not None else 0.0
    want = jops.residual(
        jnp.asarray(Xe), jnp.asarray(phie), jnp.asarray(phidote), cell,
        diff, 2.5, vel_gp=None if vel is None else jnp.asarray(vel),
        reaction=(lambda p: rc * p) if rc else None,
        source_gp=None if source is None else jnp.asarray(source),
        tau_kind=kind, dt=dt)
    G, wdet, N = _port_geometry(Xt)

    def t(a):
        return None if a is None else torch.as_tensor(np.ascontiguousarray(a))

    got = ops.residual(
        G, wdet, N, t(phie.T), t(phidote.T), diff, 2.5,
        vel=None if vel is None else t(vel.transpose(2, 1, 0)),
        reaction=(lambda p: rc * p) if rc else None,
        source=None if source is None else t(source.T), tau_kind=kind, dt=dt)
    assert _rel(got.numpy().T, want) <= RTOL


@pytest.mark.parametrize("case", list(RESIDUAL_CASES))
def test_residual_linear_part_is_forward_mode_to_the_bit(case):
    """Without its source the residual is linear in (phi, phidot): the
    scalar steps' Newton operator evaluates it at the increments, which is
    forward mode's tangent to the last bit."""
    rng = np.random.default_rng(4)
    Xe, Xt, phie, phidote, vel, diff, kind, dt, source = \
        _residual_inputs(case, rng)
    G, wdet, N = _port_geometry(Xt)
    vel = None if vel is None else torch.as_tensor(
        vel.transpose(2, 1, 0).copy())
    src = None if source is None else torch.as_tensor(source.T.copy())

    def r(p, pd, s):
        return ops.residual(G, wdet, N, p, pd, diff, 2.5, vel=vel,
                            reaction=lambda x: 0.4 * x, source=s,
                            tau_kind=kind, dt=dt)

    p, pd = torch.as_tensor(phie.T.copy()), torch.as_tensor(phidote.T.copy())
    dp, dpd = torch.randn_like(p), torch.randn_like(pd)
    _, jvp = torch.func.jvp(lambda a, b: r(a, b, src), (p, pd), (dp, dpd))
    assert torch.equal(r(dp, dpd, None), jvp)


def test_capacity_lumped_matches_reference():
    from fourc_tpu.ops import scalar as jops

    _, _, Xe, Xt = _box()
    cell, _, _ = _ref_geometry(Xe)
    _, wdet, N = _port_geometry(Xt)
    assert _rel(ops.capacity_lumped(wdet, N, 3.5).numpy().T,
                jops.capacity_lumped(Xe, cell, 3.5)) <= RTOL


def _funct_manager(jax_side):
    if jax_side:
        from fourc_tpu.core.functions import FunctionManager as JFM

        fm = JFM()
    else:
        fm = FunctionManager()
    fm.add(1, "t/4")
    fm.add(2, "sin(3.0*t)*(x+1)")
    fm.add(3, {"multifunction": {"times": [0.0, 4.0, 10.0],
                                 "pieces": ["t/4", "1"]}})
    fm.add(4, {"multifunction": {"times": [0.0, 1.0, 2.0, 5.0],
                                 "pieces": ["t*t", "cos(t)*x", "2-t/3"]}})
    return fm


def _handlers(coords):
    from fourc_tpu.core.conditions import DirichletBC as JBC
    from fourc_tpu.core.conditions import DirichletHandler as JDH

    sets = [([0, 1, 2], [1], [2.0], [1]), ([3, 4], [1], [-1.5], [2]),
            ([5, 6], [1], [3.0], [3]), ([7], [1], [0.5], [4])]
    jh = JDH([JBC(np.asarray(n), o, v, f) for n, o, v, f in sets], coords, 1,
             _funct_manager(True))
    th = DirichletHandler([DirichletBC(np.asarray(n), o, v, f)
                           for n, o, v, f in sets], coords, 1,
                          _funct_manager(False))
    return jh, th


@pytest.mark.parametrize("t", [0.3, 1.7, 2.5, 4.6])
def test_dirichlet_rates_match_reference(t):
    """The exact rates of a ramp, a sine and two multifunctions (inside
    their pieces) by forward mode, against the reference's ``jax.jvp``."""
    import jax.numpy as jnp

    coords = np.random.default_rng(5).uniform(0, 1, size=(10, 3))
    jh, th = _handlers(coords)
    like = torch.zeros(10, dtype=torch.float64)
    assert _rel(th.rates(t, like).numpy(), jh.rates(t)) <= RTOL
    udot = torch.as_tensor(np.random.default_rng(6).normal(size=10))
    want = jh.apply_rates(jnp.asarray(udot.numpy()), t)
    assert _rel(th.apply_rates(udot, t).numpy(), want) <= RTOL
    np.testing.assert_allclose(th.values(t), np.asarray(jh.values(t)),
                               rtol=1e-15, atol=0)


@pytest.mark.parametrize("t", [0.0, 0.5, 1.0, 1.5, 2.0, 3.9, 5.0])
def test_multifunction_matches_reference_inside_its_range(t):
    from fourc_tpu.core.functions import FunctionManager as JFM

    jfm = JFM()
    spec = {"multifunction": {"times": [0.0, 1.0, 2.0, 5.0],
                              "pieces": ["t*t", "cos(t)*x", "2-t/3"]}}
    jfm.add(1, spec)
    fm = FunctionManager()
    fm.add(1, spec)
    xyz = np.random.default_rng(7).uniform(-1, 2, size=(6, 3))
    np.testing.assert_allclose(fm.get(1)(xyz, t, component=0),
                               np.asarray(jfm.get(1)(xyz, t, component=0)),
                               rtol=1e-15, atol=1e-15)


def test_multifunction_range_and_knots():
    """Outside its range it raises, naming the function (the reference
    returns 0); a time a rounding away from an interior knot is the knot,
    whose piece is the one that ends there (the reference compares
    exactly and takes the next piece), so the rate there is the left
    piece's."""
    mf = MultiFunctionOfTime([0.0, 0.3, 1.0], ["t/0.3", "1"], name="FUNCT 9")
    x = np.zeros((1, 3))
    with pytest.raises(ValueError, match="FUNCT 9: t = 1.5 lies outside"):
        mf(x, 1.5, component=0)
    with pytest.raises(ValueError, match="outside"):
        mf(x, -0.1, component=0)
    t = 0.1 + 0.2  # 0.30000000000000004
    assert t > 0.3 and mf.piece(t) == 0 and mf.piece(0.3) == 0
    assert mf.piece(0.3 + 1e-9) == 1
    assert mf.piece(1.0 + 1e-14) == 1  # the end within its tolerance
    fm = FunctionManager()
    fm.add(1, {"multifunction": {"times": [0.0, 0.3, 1.0],
                                 "pieces": ["t/0.3", "1"]}})
    h = DirichletHandler([DirichletBC([0], [1], [1.0], [1])], x, 1, fm)
    like = torch.zeros(1, dtype=torch.float64)
    assert float(h.rates(t, like)[0]) == pytest.approx(1.0 / 0.3, rel=1e-15)
    assert float(h.rates(0.6, like)[0]) == 0.0


def test_fourier_flux_and_thermo_svk_stress_match_reference():
    import jax.numpy as jnp

    from fourc_tpu.materials import make_material as jmake

    rng = np.random.default_rng(8)
    four = {"type": "fourier", "conductivity": 52.0, "capacity": 420.0}
    g = rng.normal(size=(7, 3))
    assert _rel(make_material(dict(four)).flux(torch.as_tensor(g)).numpy(),
                jmake(dict(four)).flux(jnp.asarray(g))) <= RTOL
    spec = {"type": "thermostvenantkirchhoff", "youngs": 1000.0, "nue": 0.3,
            "thexpans": 1e-3, "inittemp": 293.0, "conductivity": 5.0}
    jm, tm = jmake(dict(spec)), make_material(dict(spec))
    E = 0.02 * rng.normal(size=(3, 3, 12))
    E = 0.5 * (E + E.transpose(1, 0, 2))
    T = 293.0 + 40.0 * rng.normal(size=12)
    want = jm.pk2_from_E(jnp.asarray(E), jnp.asarray(T))
    got = tm.pk2_from_E(torch.as_tensor(E), torch.as_tensor(T))
    assert _rel(got.numpy(), want) <= RTOL
    C = 2.0 * E + np.eye(3)[:, :, None]
    assert _rel(tm.pk2(torch.as_tensor(C), torch.as_tensor(T)).numpy(),
                jm.pk2(jnp.asarray(C), jnp.asarray(T))) <= RTOL
    # its forward derivatives in E and in T, the reference's jax.jvp
    import jax

    dE, dT = rng.normal(size=(3, 3, 12)), rng.normal(size=12)
    Et, Tt = torch.as_tensor(E), torch.as_tensor(T)
    _, gE = torch.func.jvp(lambda e: tm.pk2_from_E(e, Tt), (Et,),
                           (torch.as_tensor(dE),))
    _, gT = torch.func.jvp(lambda x: tm.pk2_from_E(Et, x), (Tt,),
                           (torch.as_tensor(dT),))
    jE, jT = jnp.asarray(E), jnp.asarray(T)
    _, wE = jax.jvp(lambda e: jm.pk2_from_E(e, jT), (jE,), (jnp.asarray(dE),))
    _, wT = jax.jvp(lambda x: jm.pk2_from_E(jE, x), (jT,), (jnp.asarray(dT),))
    assert _rel(gE.numpy(), wE) <= JVP_TOL
    assert _rel(gT.numpy(), wT) <= JVP_TOL


TEMP_LAWS = {
    "thermoplastic_j2": {"type": "thermoplastic_j2", "youngs": 1000.0,
                         "nue": 0.3, "yield_stress": 5.0, "isohard": 20.0,
                         "omega_t": 2e-3, "alpha_t": 1e-4, "t_ref": 300.0},
    "robinson": {"type": "robinson", "youngs": 1000.0, "nue": 0.3, "k0": 5.0,
                 "a_flow": 0.5, "n_exp": 2.0, "hard": 30.0, "recov": 0.1,
                 "omega_t": 2e-3, "t_ref": 300.0},
}
N_STATES = 240


def _temp_states(law, rng):
    n = N_STATES
    eps = rng.normal(size=(n, 3, 3)) * np.geomspace(1e-4, 0.05, n)[:, None,
                                                                  None]
    eps = 0.5 * (eps + eps.transpose(0, 2, 1))
    nh = 10 if law == "thermoplastic_j2" else 18
    h = np.zeros((n, nh))
    ep = rng.normal(size=(n, 3, 3)) * 1e-3
    h[:, :9] = (0.5 * (ep + ep.transpose(0, 2, 1))).reshape(n, 9)
    if law == "thermoplastic_j2":
        h[:, 9] = np.abs(rng.normal(size=n)) * 1e-2
    else:
        b = rng.normal(size=(n, 3, 3))
        b = 0.5 * (b + b.transpose(0, 2, 1))
        b -= np.trace(b, axis1=1, axis2=2)[:, None, None] / 3 * np.eye(3)
        h[:, 9:] = b.reshape(n, 9)
    T = 300.0 + rng.uniform(-80.0, 150.0, size=n)
    return eps, h, T


@pytest.mark.parametrize("law", list(TEMP_LAWS))
def test_temperature_laws_match_reference(law):
    """Stress and new history over elastic and yielding states at
    per-state temperatures at 1e-12, and the forward derivative along a
    strain direction at 1e-10 (Robinson at the step's dt by name, as the
    reference's TSI call passes it)."""
    import jax
    import jax.numpy as jnp

    from fourc_tpu.materials import make_material as jmake

    spec = TEMP_LAWS[law]
    jm, tm = jmake(dict(spec)), make_material(dict(spec))
    rng = np.random.default_rng(9)
    eps, h, T = _temp_states(law, rng)
    deps = rng.normal(size=eps.shape)
    deps = 0.5 * (deps + deps.transpose(0, 2, 1))
    dt = 0.5 if law == "robinson" else None

    def ref(x):
        if dt is None:
            return jax.vmap(jm.evaluate_small)(x, jnp.asarray(h),
                                               jnp.asarray(T))
        return jax.vmap(lambda e, hh, tt: jm.evaluate_small(
            e, hh, T=tt, dt=dt))(x, jnp.asarray(h), jnp.asarray(T))

    (sj, hj), (dj, _) = jax.jvp(ref, (jnp.asarray(eps),),
                                (jnp.asarray(deps),))
    et, ht = torch.as_tensor(eps.transpose(1, 2, 0).copy()), \
        torch.as_tensor(h.T.copy())
    Tt = torch.as_tensor(T)
    st_, hn = tm.evaluate_small(et, ht, dt, T=Tt)
    assert _rel(st_.numpy().transpose(2, 0, 1), sj) <= RTOL
    assert _rel(hn.numpy().T, hj) <= RTOL
    grew = np.abs(np.asarray(hj)[:, :9] - h[:, :9]).max(1) > 0
    assert 10 <= grew.sum() <= N_STATES - 10  # elastic and yielding
    _, dt_ = torch.func.jvp(lambda x: tm.evaluate_small(x, ht, dt, T=Tt)[0],
                            (et,), (torch.as_tensor(
                                deps.transpose(1, 2, 0).copy()),))
    assert _rel(dt_.numpy().transpose(2, 0, 1), dj) <= JVP_TOL


def _scatra_deck(material, generator=None):
    return {"problem": {"type": "scatra"},
            "scatra_dynamic": {"dynamictype": "stationary"},
            "solver": {"method": "cg", "precond": "jacobi"},
            "materials": {1: material},
            "geometry": {"generator": generator or {
                "kind": "box", "nx": 2, "ny": 1, "nz": 1, "cell": "hex8",
                "mat": 1, "name": "scatra"}},
            "conditions": {"dirichlet": [{"nodes": "xmin", "onoff": [1],
                                          "val": [1.0]}]}}


# each refusal this slice adds: the deck, what the refusal names
REFUSALS = {
    "multi_species": (_scatra_deck({"type": "matlist", "species": [
        {"diffusivity": 1.0}, {"diffusivity": 2.0}]}),
        "material type 'matlist' is not ported (multi-species"),
    "matlist_reactions": (_scatra_deck({"type": "matlist_reactions",
                                        "species": []}),
                          "'matlist_reactions' is not ported"),
    "scatra_reaction": (_scatra_deck({"type": "scatra_reaction",
                                      "diffusivity": 1.0}),
                        "'scatra_reaction' is not ported (coupled reactions"),
    "scatra_stvenantkirchhoff": (_scatra_deck({
        "type": "scatra_stvenantkirchhoff", "youngs": 1.0, "nue": 0.3,
        "swelling": 0.1}), "'scatra_stvenantkirchhoff' is not ported "
                           "(scatra-structure interaction)"),
    "rectangle": (_scatra_deck({"type": "scatra", "diffusivity": 1.0}, {
        "kind": "rectangle", "nx": 4, "ny": 4, "cell": "quad9", "mat": 1,
        "name": "scatra"}), "rectangle cell 'quad9' is not ported"),
    "elch_problem": ({**_scatra_deck({"type": "scatra", "diffusivity": 1.0}),
                      "problem": {"type": "elch"}},
                     "problem type 'elch' is not ported"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_unported_scalar_setting_is_refused_by_name(name):
    data, named = REFUSALS[name]
    with pytest.raises(NotImplementedError, match="not ported") as exc:
        driver.run(yaml.safe_load(yaml.safe_dump(data)), device="cpu")
    assert named in str(exc.value)


def test_scalar_field_refuses_several_scalars_per_node():
    class TwoSpecies:
        nspec = 2

    d = gridgen.box(1, 1, 1)
    with pytest.raises(NotImplementedError, match="2 scalars per node"):
        st.ScalarField(d, {1: TwoSpecies()}, st.ScalarParams(), device="cpu")


def test_thermo_statics_is_refused_as_the_reference():
    data = _scatra_deck({"type": "fourier", "conductivity": 1.0})
    data["problem"]["type"] = "thermo"
    data["thermal_dynamic"] = data.pop("scatra_dynamic")
    data["thermal_dynamic"]["dynamictype"] = "statics"
    data["geometry"]["generator"]["name"] = "thermo"
    with pytest.raises(ValueError, match="unknown scalar DYNAMICTYPE"):
        driver.run(deck_mod.load(data), device="cpu")


def _field_deck(convective):
    data = {"problem": {"type": "scatra" if convective else "thermo"},
            "solver": {"method": "gmres", "precond": "jacobi"},
            "materials": {1: ({"type": "scatra", "diffusivity": 0.05,
                               "reacoeff": 0.3, "capacity": 2.0}
                              if convective else
                              {"type": "fourier", "conductivity": 2.5,
                               "capacity": 3.0, "density": 1.5})},
            "functions": {1: "x*(1-x)+t", 2: "2.0*t"},
            "geometry": {"generator": {
                "kind": "box", "nx": 3, "ny": 2, "nz": 2, "cell": "hex8",
                "mat": 1, "hi": [1.5, 1.0, 0.8],
                "name": "scatra" if convective else "thermo"}},
            "conditions": {
                "dirichlet": [{"nodes": "xmin", "onoff": [1], "val": [1.0],
                               "funct": [2]}],
                "body_force": [{"val": [0.7], "funct": [1]}]}}
    section = {"dynamictype": "onesteptheta", "theta": 0.6}
    if convective:
        section.update(velocity=["1.0+y", "0.5", "0.0"],
                       stab="franca_valentin")
    data["scatra_dynamic" if convective else "thermal_dynamic"] = section
    return data


@pytest.mark.parametrize("convective", [False, True],
                         ids=["thermo", "scatra_supg"])
def test_scalar_field_matches_reference(convective):
    """The assembled field on a 3x2x2 box: the residual at t with a body
    source (and convection, SUPG and a reaction), the lumped capacity and
    the Jacobi preconditioner's diagonal, at 1e-12."""
    import jax.numpy as jnp

    from fourc_tpu.io import deck as jdeck
    from fourc_tpu.physics import scalar_driver as jsd

    from fourc_tpu_torch.physics import scalar_driver

    data = _field_deck(convective)
    section = "scatra_dynamic" if convective else "thermal_dynamic"
    name = "scatra" if convective else "thermo"
    jf = jsd.build_field(jdeck.load(yaml.safe_load(yaml.safe_dump(data))),
                         section, name)
    f = scalar_driver.build_field(deck_mod.load(
        yaml.safe_load(yaml.safe_dump(data))), section, name, device="cpu")
    rng = np.random.default_rng(13)
    phi, phidot = rng.normal(size=f.ndof), rng.normal(size=f.ndof)
    want = jf.residual_transient(jnp.asarray(phi), jnp.asarray(phidot), 0.3,
                                 dt=0.1)
    got = f.residual_transient(torch.as_tensor(phi),
                               torch.as_tensor(phidot), 0.3, dt=0.1)
    assert _rel(got.numpy(), want) <= RTOL
    assert _rel(f.lumped_capacity().numpy(), jf.lumped_capacity()) <= RTOL
    one = np.ones(f.ndof)
    assert _rel(f.build_preconditioner(2.0)(torch.as_tensor(one)).numpy(),
                jf.build_preconditioner(2.0)(jnp.asarray(one))) <= RTOL


@pytest.mark.parametrize("deck", ["thermo_fin_cooling.yaml",
                                  "ref_converted/thermo_bar_dbc_genalpha.yaml"])
def test_initial_state_matches_reference(deck):
    """phi(0) from the initial FUNCT (the fin) or zero with the prescribed
    values at t = 0 (the bar), through ``convert.scalar_state_from_jax``."""
    import os

    from fourc_tpu.io import deck as jdeck
    from fourc_tpu.physics import scalar_driver as jsd
    from fourc_tpu.physics import scalar_transport as jst

    from fourc_tpu_torch import convert
    from fourc_tpu_torch.physics import scalar_driver

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "decks", deck)
    jf = jsd.build_field(jdeck.load(path), "thermal_dynamic", "thermo")
    want = convert.scalar_state_from_jax(jst.init_state(jf))
    f = scalar_driver.build_field(deck_mod.load(path), "thermal_dynamic",
                                  "thermo", device="cpu")
    got = st.init_state(f)
    for k in ("phi", "phidot", "phi_nm1"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert (got["t"], got["step"]) == (want["t"], want["step"])
