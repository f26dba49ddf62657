"""Slice 5a: thermo-structure interaction on the CPU in float64.

Held against the JAX package eagerly on a 4x2x2 box (no jit, no step):
the Gauss-point temperatures and heating, the coupled residual
[r_s; r_t] from the same state (``convert.tsi_state_from_jax``) at 1e-12
and its Jacobian action along a random [v_d; v_T] against the reference's
``jax.jvp`` at 1e-10, under statics and one-step-theta structures, with
thermo-elastic SVK and with the two plasticity laws that take a
temperature.  Pure torch: the thermo rows' linear part equals forward
mode's tangent to the bit, the field takes general topology, and the
refusals.  The two TSI decks run in tests/port/test_torch_deck.py.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from fourc_tpu_torch import convert
from fourc_tpu_torch.io import deck as deck_mod
from fourc_tpu_torch.physics import driver
from fourc_tpu_torch.physics import tsi_driver as td

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HEATED_BAR = os.path.join(ROOT, "decks", "tsi_heated_bar.yaml")
RTOL, JVP_TOL = 1e-12, 1e-10

THERMO_SVK = {"type": "thermostvenantkirchhoff", "youngs": 1000.0,
              "nue": 0.3, "thexpans": 1e-3, "inittemp": 293.0,
              "conductivity": 5.0, "capacity": 1.0, "density": 1.0}
# (structure integrator, kinematics, law)
CASES = {
    "statics_nonlinear": ("statics", "nonlinear", THERMO_SVK),
    "ost_nonlinear": ("onesteptheta", "nonlinear", THERMO_SVK),
    "ost_linear": ("onesteptheta", "linear", THERMO_SVK),
}


def _deck(dyntype, kinem, law, nx=4):
    with open(HEATED_BAR) as fh:
        data = yaml.safe_load(fh)
    data["structural_dynamic"].update(dynamictype=dyntype, kinem=kinem,
                                      theta=0.66)
    data["geometry"]["generator"].update(nx=nx, ny=2, nz=2, hi=[2.0, 1.0, 1.0])
    data["materials"] = {1: law}
    data["conditions"]["neumann"] = [{"faces": "xmax", "onoff": [1, 1, 0],
                                      "val": [3.0, 1.0, 0.0]}]
    return data


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(x):
    return torch.as_tensor(np.array(x, np.float64))


def _pair(case):
    """(reference field, its perturbed state, port field, the same state
    through tsi_state_from_jax)."""
    import jax.numpy as jnp

    from fourc_tpu.io import deck as jdeck
    from fourc_tpu.physics import tsi_driver as jtd

    data = _deck(*CASES[case])
    jf = jtd.build_field(jdeck.load(yaml.safe_load(yaml.safe_dump(data))))
    js = jtd.init_state(jf)
    rng = np.random.default_rng(11)
    for k, scale in (("d", 1e-2), ("v", 1e-1), ("a", 1.0), ("T", 5.0),
                     ("Tdot", 10.0), ("fint", 1.0), ("fext", 1.0)):
        base = np.asarray(js[k])
        js[k] = jnp.asarray(base + scale * rng.normal(size=base.shape))
    js["t"] = jnp.asarray(0.1)
    f = td.build_field(deck_mod.load(yaml.safe_load(yaml.safe_dump(data))),
                       device="cpu")
    s = convert.tsi_state_from_jax({k: (np.asarray(v) if k != "hist" else
                                        {kk: np.asarray(vv)
                                         for kk, vv in v.items()})
                                    for k, v in js.items()})
    state = {k: (_t(v) if isinstance(v, np.ndarray) else v)
             for k, v in s.items()}
    state["hist"] = {k: _t(v) for k, v in s["hist"].items()}
    return jf, js, f, state, rng


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    return (request.param, *_pair(request.param))


def test_field_takes_general_topology(pair):
    _, _, _, f, _, _ = pair
    assert f.solid.lattice is None and f.solid.blocks
    assert all(b.model is None for b in f.solid.blocks)  # element route


def test_temperatures_and_heating_at_gauss_points(pair):
    import jax.numpy as jnp

    _, jf, js, f, state, rng = pair
    T = rng.normal(size=f.nt) * 10 + 300
    v = rng.normal(size=f.nd)
    jt = jf.temps_at_gps(jnp.asarray(T))
    tt = f.temps_at_gps(_t(T))
    jh = jf.heating_at_gps(jnp.asarray(v))
    th = f.heating_at_gps(_t(v))
    assert jt.keys() == tt.keys() and jh.keys() == th.keys()
    for key in jt:
        assert _rel(tt[key].numpy().T, jt[key]) <= RTOL
        assert _rel(th[key].numpy().T, jh[key]) <= RTOL


def _reference_residual(jf, js, dt, y):
    from fourc_tpu.physics import tsi_driver as jtd

    d, T = jf.split(y)
    r_s, r_t, *_ = jtd._coupled_residuals(jf, js, dt, d, T, js["t"] + dt)
    return jf.join(r_s, jf.params.thermo_scale * r_t)


def test_coupled_residual_and_jacobian_match_reference(pair):
    import jax
    import jax.numpy as jnp

    _, jf, js, f, state, rng = pair
    dt = 0.05
    y = np.concatenate([np.asarray(js["d"]) + 1e-3 * rng.normal(size=f.nd),
                        np.asarray(js["T"]) + rng.normal(size=f.nt)])
    v = rng.normal(size=y.shape)
    want, jv = jax.jvp(lambda x: _reference_residual(jf, js, dt, x),
                       (jnp.asarray(y),), (jnp.asarray(v),))
    c = td.CoupledStep(f, state, dt)
    got = c.residual(_t(y))
    nd = f.nd
    assert _rel(got[:nd].numpy(), want[:nd]) <= RTOL
    assert _rel(got[nd:].numpy(), want[nd:]) <= RTOL
    jac = c.jacobian(_t(y), _t(v))
    assert _rel(jac[:nd].numpy(), jv[:nd]) <= JVP_TOL
    assert _rel(jac[nd:].numpy(), jv[nd:]) <= JVP_TOL
    # each coupling block alone
    vd, vT = np.zeros_like(v), np.zeros_like(v)
    vd[:nd], vT[nd:] = v[:nd], v[nd:]
    for w in (vd, vT):
        _, jw = jax.jvp(lambda x: _reference_residual(jf, js, dt, x),
                        (jnp.asarray(y),), (jnp.asarray(w),))
        got_w = c.jacobian(_t(y), _t(w)).numpy()
        for sl in (slice(0, nd), slice(nd, None)):
            scale = max(np.abs(np.asarray(jw[sl])).max(), 1e-300)
            assert np.abs(got_w[sl] - np.asarray(jw[sl])).max() / scale \
                <= JVP_TOL or np.abs(np.asarray(jw[sl])).max() == 0.0


def test_thermo_rows_linear_part_is_forward_mode_to_the_bit(pair):
    _, _, _, f, state, rng = pair
    c = td.CoupledStep(f, state, 0.05)
    d = state["d"] + 1e-3 * torch.randn(f.nd, dtype=torch.float64)
    T = state["T"] + torch.randn(f.nt, dtype=torch.float64)
    vd, vT = (torch.randn(f.nd, dtype=torch.float64),
              torch.randn(f.nt, dtype=torch.float64))
    _, jvp = torch.func.jvp(c.thermo, (d, T), (vd, vT))
    assert torch.equal(c.thermo_tangent(vd, vT), jvp)
    _, jvp_s = torch.func.jvp(lambda x: c.structure(d, x), (T,), (vT,))
    assert _rel(c.expansion(d, T, vT).numpy(), jvp_s.numpy()) <= 1e-14


def test_jacobian_applies_share_one_linearization(pair, monkeypatch):
    """The Krylov applies at one Newton iterate y build K_st's temperature
    moduli once; a new iterate builds them anew, and the applies equal
    those of a fresh step to the bit."""
    from fourc_tpu_torch.ops import solid as ops

    _, _, _, f, state, _ = pair
    built = []
    moduli = ops.temperature_moduli
    monkeypatch.setattr(ops, "temperature_moduli",
                        lambda *a, **k: built.append(1) or moduli(*a, **k))
    c = td.CoupledStep(f, state, 0.05)
    y = f.join(state["d"], state["T"])
    vs = [torch.randn_like(y) for _ in range(3)]
    got = [c.jacobian(y, v) for v in vs]
    assert len(built) == 1
    y2 = y + 1e-3 * torch.randn_like(y)
    c.jacobian(y2, vs[0])
    assert len(built) == 2
    fresh = td.CoupledStep(f, state, 0.05)
    for v, g in zip(vs, got):
        assert torch.equal(fresh.jacobian(y.clone(), v), g)


@pytest.mark.parametrize("law", ["thermoplastic_j2", "robinson"])
def test_temperature_law_blocks_match_reference(law):
    """A block of thermoplastic J2 or Robinson under linear kinematics:
    the internal force at the Gauss points' temperatures and its
    derivatives in d and T against the reference's element route at
    1e-12 and ``jax.jvp`` at 1e-10 (Robinson at the step's dt, both
    in their places: the reference's TSI call passes them so)."""
    import jax
    import jax.numpy as jnp

    from fourc_tpu.ops import solid as jops

    from fourc_tpu_torch.core.cells import get_cell
    from fourc_tpu_torch.ops import solid as ops
    from test_torch_thermo import TEMP_LAWS

    from fourc_tpu.core.cells import get_cell as jcell
    from fourc_tpu.materials import make_material as jmake
    from fourc_tpu_torch.materials import make_material

    spec = dict(TEMP_LAWS[law])
    jm, tm = jmake(dict(spec)), make_material(dict(spec))
    from fourc_tpu_torch.core import gridgen

    disc = gridgen.box(2, 2, 1)
    rng = np.random.default_rng(12)
    Xe = disc.coords[disc.blocks["hex8"].conn]
    E = Xe.shape[0]
    ue = 0.02 * rng.normal(size=(E, 8, 3))
    h = np.zeros((E, 8, tm.history_shape[0]))
    h[..., :9] = 1e-3 * rng.normal(size=(E, 8, 9))
    T = 300.0 + 60.0 * rng.normal(size=(E, 8))
    dt = 0.5

    def ref(u, TT):
        return jops._internal_force_einsum(
            jnp.asarray(Xe), u, jcell("hex8"), jm, kinem="linear",
            history=jnp.asarray(h), dt=dt, temps=TT)[0]

    du, dT = rng.normal(size=ue.shape), rng.normal(size=T.shape)
    fj, jv = jax.jvp(ref, (jnp.asarray(ue), jnp.asarray(T)),
                     (jnp.asarray(du), jnp.asarray(dT)))
    X = torch.as_tensor(Xe.reshape(E, -1).T.copy())
    G, wdet = ops.element_geometry(X, get_cell("hex8"))
    u = torch.as_tensor(ue.reshape(E, -1).T.copy())
    hist, Tt = _t(h), _t(T.T)
    f_got = ops.element_force(G, wdet, u, tm, kinem="linear", history=hist,
                              dt=dt, temps=Tt)
    assert _rel(f_got.numpy().T.reshape(E, 8, 3), fj) <= RTOL
    dd = ops.element_tangent(G, wdet, u, torch.as_tensor(
        du.reshape(E, -1).T.copy()), tm, kinem="linear", history=hist, dt=dt,
        temps=Tt)
    dTT = ops.element_temperature_derivative(
        G, ops.temperature_moduli(G, wdet, u, tm, "linear", Tt, hist, dt),
        _t(dT.T))
    assert _rel((dd + dTT).numpy().T.reshape(E, 8, 3), jv) <= JVP_TOL


def _refused(changes, section="structural_dynamic"):
    with open(HEATED_BAR) as fh:
        data = yaml.safe_load(fh)
    data.setdefault(section, {}).update(changes)
    return data


# each TSI refusal this slice adds: the deck, what the refusal names
REFUSALS = {
    "structure_genalpha": (_refused({"dynamictype": "genalpha"}),
                           "structural_dynamic dynamictype 'genalpha' "
                           "under TSI"),
    "thermo_genalpha": (_refused({"dynamictype": "genalpha"},
                                 "thermal_dynamic"),
                        "thermal_dynamic dynamictype 'genalpha' under TSI"),
    "thermo_statics": (_refused({"dynamictype": "statics"},
                                "thermal_dynamic"),
                       "thermal_dynamic dynamictype 'statics' under TSI"),
    "constraint": (_refused({"constraint": [{"kind": "volume",
                                             "faces": "xmax"}]},
                            "conditions"),
                   "constraint conditions under TSI"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_unported_tsi_setting_is_refused_by_name(name, monkeypatch):
    data, named = REFUSALS[name]

    def built(*args, **kwargs):
        raise AssertionError("the field was built before the refusal")

    monkeypatch.setattr(td, "build_field", built)
    with pytest.raises(NotImplementedError, match="not ported") as exc:
        driver.run(yaml.safe_load(yaml.safe_dump(data)), device="cpu")
    assert named in str(exc.value)
