"""Slice 4g: the growth, mixture and muscle laws on the CPU in float64.

Held against the JAX package eagerly (no jit, no step, no JAX field): each
law's stress and new history under ``jax.vmap`` of its ``evaluate`` (the
history-free mixture: ``pk2_from_E``) at 1e-12 relative, over seeded
states that take every branch, and the stress's forward derivative along
the six symmetric directions against ``jax.jvp`` at 1e-10, on the whole
batch and on C = I exactly (the states of u = 0, where the fibre stretch
sits on its ties).  The rest is pure torch: the initial histories, the
refusals, ``SymbolicExpression`` on tensors, and the five gate decks
through the CLI with the reference's Newton iterations.
"""

import os
import re

import numpy as np
import pytest
import torch
import yaml

from fourc_tpu_torch.app.main import main
from fourc_tpu_torch.core.functions import SymbolicExpression
from fourc_tpu_torch.io import deck as deck_mod
from fourc_tpu_torch.materials import make_material
from fourc_tpu_torch.physics import structure_driver

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RTOL, JVP_TOL = 1e-12, 1e-10
N_STATES = 240
# the symmetric unit directions: e_ij for i == j, e_ij + e_ji otherwise
SYM = ((0, 0), (1, 1), (2, 2), (0, 1), (1, 2), (0, 2))

GROWTH_ISO = {"type": "growth_iso", "youngs": 100.0, "nue": 0.3,
              "k_growth": 0.5, "m_target": 1.0}
MUSCLE_ACTIVE = {"type": "muscle_active", "youngs": 200.0, "nue": 0.3,
                 "smax": 30.0, "tau": 0.75, "fiber": [1.0, 0.2, 0.0]}
GR_CM = {"type": "growthremodel_cm", "youngs_elastin": 80.0, "nue": 0.3,
         "k_fiber": 40.0, "sigma_h": 5.0, "k_sigma": 0.4, "k_remodel": 0.4,
         "prestretch": 1.05, "a1": [1.0, 0.0, 0.0], "a2": [0.0, 1.0, 0.0]}
ELASTIN = {"type": "elasthyper", "summands": [
    {"type": "couplogneohooke", "youngs": 60.0, "nue": 0.3}]}


def _fiber(a, impl, **kw):
    return {"kind": "remodelfiber", "frac": 0.3, "k1": 20.0, "k2": 1.5,
            "a": a, "lambda_pre": 1.08, "k_sig": 0.5, "decay_time": 4.0,
            "impl": impl, **kw}


def _mixture_rule(rule, kind, impls, prestretch=(1.05, 1.0, 1.0),
                  solid=ELASTIN, **kw):
    return {"type": "mixture_rule", "rule": rule,
            "growth_strategy": {"kind": kind, "g": [0.0, 0.3, 1.0]},
            "constituents": [
                {"kind": "solid", "frac": 0.4, "material": solid,
                 **({"prestretch": list(prestretch)} if prestretch else {})},
                _fiber([1.0, 0.3, 0.0], impls[0], **kw),
                _fiber([1.0, -0.3, 0.0], impls[1])]}


BLEMKER = {"type": "muscle_blemker", "g1": 0.5, "g2": 0.5, "p1": 0.05,
           "p2": 6.6, "sigma_max": 40.0, "lambda_ofl": 1.2,
           "lambda_star": 1.4, "alpha": 1.0, "beta": 2.0,
           "t_act_start": 0.3, "youngs": 200.0, "nue": 0.3,
           "a": [1.0, 0.0, 0.0]}
ANISO = {"type": "anisoactivestress", "youngs": 150.0, "nue": 0.3,
         "sigma0": 20.0, "u_expr": "4*(t <= 0.5) - 4*(t > 0.5)",
         "lambda_lower": 0.9, "lambda_upper": 1.2, "f0": [1.0, 0.0, 0.0]}
MIXTURE = {"type": "mixture", "constituents": [
    {"frac": 0.6, "material": {"type": "neohooke", "youngs": 100.0,
                               "nue": 0.3}},
    {"frac": 0.4, "material": {"type": "elasthyper", "summands": [
        {"type": "couplogneohooke", "youngs": 60.0, "nue": 0.25},
        {"type": "coupanisoexpo", "k1": 20.0, "k2": 1.5,
         "a": [1.0, 1.0, 0.0]}]}}]}

# laws whose reference stress is the unsymmetric nine-entry gradient
# (ROADMAP C6), held against its symmetric part
SYMMETRIZED = {"muscle_blemker"}

# case -> (deck spec, the step's dt)
LAWS = {
    "growth_iso": (GROWTH_ISO, None),
    "growth_iso_dt": (GROWTH_ISO, 0.5),
    "muscle_active": (MUSCLE_ACTIVE, None),
    "muscle_active_dt": (MUSCLE_ACTIVE, 0.25),
    "growthremodel_cm": (GR_CM, None),
    "growthremodel_cm_dt": (GR_CM, 0.5),
    "growthremodel_cm_rho_clips": ({**GR_CM, "k_remodel": 0.05,
                                    "k_sigma": 2.0}, 1.0),
    "mixture_rule_isotropic_impl": (_mixture_rule(
        "growthremodel", "isotropic", (True, True)), None),
    "mixture_rule_isotropic_impl_dt": (_mixture_rule(
        "growthremodel", "isotropic", (True, True)), 0.5),
    "mixture_rule_anisotropic_explicit_dt": (_mixture_rule(
        "growthremodel", "anisotropic", (False, False)), 0.5),
    "mixture_rule_stiffness_dt": (_mixture_rule(
        "growthremodel", "stiffness", (True, False)), 0.5),
    "mixture_rule_simple_compression_dt": (_mixture_rule(
        "simple", "isotropic", (False, True), prestretch=None,
        solid={"type": "neohooke", "youngs": 60.0, "nue": 0.3},
        supports_compression=True, basal=False), 0.5),
    "muscle_blemker": (BLEMKER, None),
    "muscle_blemker_dt": (BLEMKER, 0.25),
    "muscle_blemker_no_matrix_dt": ({**BLEMKER, "youngs": 0.0}, 0.25),
    "anisoactivestress": (ANISO, None),
    "anisoactivestress_dt": (ANISO, 0.125),
    "anisoactivestress_no_window_dt": ({**ANISO, "lambda_upper": 0.0,
                                        "lambda_lower": 0.0,
                                        "u_expr": "2*t - 0.4"}, 0.125),
}


def _materials(spec):
    from fourc_tpu.materials import make_material as jmake

    return jmake(yaml.safe_load(yaml.safe_dump(spec))), make_material(
        yaml.safe_load(yaml.safe_dump(spec)))


def _close(got, want, tol):
    """max |got - want| within tol of max |want| (both finite)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    return float(np.abs(got - want).max()) <= tol * float(np.abs(want).max())


def _strains(rng, n, direction=(1.0, 0.0, 0.0)):
    """C = F^T F (n, 3, 3): a sixth exactly I, then random F of all sizes,
    then isochoric stretches 0.55-1.9 along ``direction`` (a third of them
    sheared a little)."""
    n_id, n_rand = n // 6, n // 2
    F = np.tile(np.eye(3), (n, 1, 1))
    F[n_id:n_id + n_rand] += rng.normal(size=(n_rand, 3, 3)) * np.geomspace(
        1e-3, 0.3, n_rand)[:, None, None]
    d = np.asarray(direction, float) / np.linalg.norm(direction)
    Q, _ = np.linalg.qr(np.column_stack([d, rng.normal(size=(3, 2))]))
    Q[:, 0] = d
    m = n - n_id - n_rand
    lam = rng.uniform(0.55, 1.9, size=m)
    D = np.zeros((m, 3, 3))
    D[:, 0, 0], D[:, 1, 1] = lam, lam ** -0.5
    D[:, 2, 2] = lam ** -0.5
    Fs = np.einsum("ij,njk,lk->nil", Q, D, Q)
    Fs[::3] += rng.normal(size=Fs[::3].shape) * 0.02
    F[n_id + n_rand:] = Fs
    return np.einsum("nki,nkj->nij", F, F)


def _histories(tm, rng, n):
    """Histories (n, nh) that start each law on every branch."""
    name = tm.deck_name
    if name == "growth_iso":  # below, on and above the clip bounds
        return rng.choice([0.3, 0.5, 0.8, 1.0, 1.7, 3.0, 3.5],
                          size=(n, 1)) * rng.choice([1.0, 1.01], size=(n, 1))
    if name == "muscle_active":  # t before and after tau, and on it
        t = rng.uniform(0.0, 1.5, size=(n, 1))
        t[::7] = 0.5
        return t
    if name == "growthremodel_cm":
        h = np.stack([rng.uniform(0.05, 6.0, n), rng.uniform(0.21, 1.6, n),
                      rng.uniform(0.05, 6.0, n), rng.uniform(0.21, 1.6, n)],
                     axis=1)
        return h
    if name == "mixture_rule":
        return np.stack([rng.uniform(0.5, 2.0, n), rng.uniform(0.8, 1.05, n),
                         rng.uniform(0.5, 2.0, n), rng.uniform(0.8, 1.05, n)],
                        axis=1)
    if name == "muscle_blemker":  # before and after t_act_start = 0.3
        return rng.uniform(0.0, 1.0, size=(n, 1))
    return np.stack([rng.uniform(0.0, 25.0, n), rng.uniform(0.0, 1.0, n)],
                    axis=1)


def _states(tm, rng):
    direction = {"muscle_active": (1.0, 0.2, 0.0),
                 "mixture_rule": (1.0, 0.3, 0.0)}.get(tm.deck_name,
                                                     (1.0, 0.0, 0.0))
    return (_strains(rng, N_STATES, direction),
            _histories(tm, rng, N_STATES))


def _unit(a):
    a = np.asarray(a, float)
    return a / np.linalg.norm(a)


def _branches(tm, spec, C, h, hn, dt):
    """Each branch of the law taken by the reference's run: the number of
    states in it, by name."""
    name = tm.deck_name
    I = np.eye(3)
    if name == "growth_iso":
        out = {"theta below theta_min": h[:, 0] < 0.5,
               "theta above theta_max": h[:, 0] > 3.0}
        if dt:
            out.update({"new theta at theta_min": hn[:, 0] == 0.5,
                        "new theta at theta_max": hn[:, 0] == 3.0,
                        "new theta inside": (hn[:, 0] > 0.5)
                        & (hn[:, 0] < 3.0)})
        return out
    if name == "muscle_active":
        t = hn[:, 0] / spec["tau"]
        return {"t before tau": t < 1.0, "t after tau": t > 1.0}
    if name == "growthremodel_cm":  # by the fibre's stretch at the start
        out = {}
        for k, a in enumerate((spec["a1"], spec["a2"])):
            a = _unit(a)
            q = np.einsum("i,nij,j->n", a, C, a) * (
                spec["prestretch"] / h[:, 2 * k + 1]) ** 2
            out[f"fibre {k + 1} in tension"] = q > 1.0
            out[f"fibre {k + 1} in compression"] = q < 1.0
        if dt == 1.0:
            rho = hn[:, [0, 2]]
            out["rho at 1e-4"] = (rho == 1e-4).any(1)
            out["rho at 10"] = (rho == 10.0).any(1)
        return out
    if name == "mixture_rule":
        out = {}
        for k, c in enumerate(spec["constituents"][1:]):
            a = _unit(c["a"])
            I4 = np.einsum("i,nij,j->n", a, C, a)
            lam_r = h[:, 2 * k + 1]
            # lam_ext is 1 but under isotropic growth: read it as the law does
            if spec["rule"] == "growthremodel" and (
                    spec["growth_strategy"]["kind"] == "isotropic"):
                g = 0.4 + 0.3 * h[:, 0] + 0.3 * h[:, 2]
                lam_ext = g ** (1.0 / 3.0)
            elif spec["rule"] == "growthremodel" and (
                    spec["growth_strategy"]["kind"] == "anisotropic"):
                g = 0.4 + 0.3 * h[:, 0] + 0.3 * h[:, 2]
                gv = _unit(spec["growth_strategy"]["g"])
                iFg = I + (1.0 / g - 1.0)[:, None, None] * np.outer(gv, gv)
                lam_ext = 1.0 / np.linalg.norm(iFg @ a, axis=1)
            else:
                lam_ext = 1.0
            I4e = I4 / (lam_r * lam_ext) ** 2
            out[f"fibre {k + 1} in tension"] = I4e > 1.0
            out[f"fibre {k + 1} in compression"] = I4e < 1.0
        return out
    if name == "muscle_blemker":
        J2 = np.linalg.det(C)
        Cb = C * (J2 ** (-1.0 / 3.0))[:, None, None]
        a = _unit(spec["a"])
        Ca = Cb @ a
        I4, I5 = Ca @ a, (Ca * Ca).sum(1)
        lam = np.sqrt(I4)
        X = (np.trace(Cb, axis1=1, axis2=2) * I4 - I5) / (2 * lam)
        r = lam / spec["lambda_ofl"]
        t = hn[:, 0]
        return {"lam <= 1": lam <= 1.0, "lam == 1": lam == 1.0,
                "1 < lam < lam*": (lam > 1.0) & (lam < 1.4),
                "lam >= lam*": lam >= 1.4, "r <= 0.6": r <= 0.6,
                "0.6 < r < 1.4": (r > 0.6) & (r < 1.4), "r >= 1.4": r >= 1.4,
                "t before t_act_start": t < 0.3,
                "t after t_act_start": t >= 0.3,
                "H1 clamped": X <= 1.0 + 1e-12, "H1 free": X > 1.0 + 1e-12}
    t = hn[:, 1]
    u = SymbolicExpression(spec["u_expr"])(t=t)
    out = {"u on": u > 0.0, "u off": u < 0.0}
    if spec["lambda_upper"] > spec["lambda_lower"]:
        lam = np.sqrt(C[:, 0, 0])
        out.update({"n0 = 0": (lam < 0.9) | (lam > 1.2),
                    "0 < n0 <= 1": (lam > 0.9) & (lam < 1.2)})
    return out


def _ref(jm, dt):
    return jm.evaluate if dt is None else (
        lambda c, hh: jm.evaluate(c, hh, dt))


def _directions(n):
    """(6 n, 3, 3): n copies of each symmetric unit direction."""
    out = np.zeros((len(SYM), n, 3, 3))
    for k, (i, j) in enumerate(SYM):
        out[k, :, i, j] = out[k, :, j, i] = 1.0
    return out.reshape(-1, 3, 3)


def _sym(S):
    """0.5 (S + S^T) of a (n, 3, 3) batch."""
    S = np.asarray(S)
    return 0.5 * (S + S.transpose(0, 2, 1))


def _held(jm, tm, dt, C, h):
    """Stress and new history at 1e-12, and the stress's forward
    derivatives along the six symmetric directions at 1e-10 (one forward
    pass of six copies of the batch); returns the reference's history.
    A law of ``SYMMETRIZED`` is held against the symmetric part of the
    reference's stress and of its derivatives."""
    import jax
    import jax.numpy as jnp

    n = len(C)
    C6, h6 = np.tile(C, (len(SYM), 1, 1)), np.tile(h, (len(SYM), 1))
    d6 = _directions(n)
    ref = jax.vmap(_ref(jm, dt))
    (sj, hj), (dj, _) = jax.jvp(lambda c: ref(c, jnp.asarray(h6)),
                                (jnp.asarray(C6),), (jnp.asarray(d6),))
    if tm.deck_name in SYMMETRIZED:
        sj, dj = _sym(sj), _sym(dj)
    th = torch.as_tensor(h6.T)
    (st, ht), (dt_, _) = torch.func.jvp(
        lambda c: tm.evaluate(c, th, dt),
        (torch.as_tensor(C6.transpose(1, 2, 0)),),
        (torch.as_tensor(d6.transpose(1, 2, 0)),))
    assert _close(st.numpy().transpose(2, 0, 1)[:n], np.asarray(sj)[:n],
                  RTOL)
    assert _close(ht.numpy().T[:n], np.asarray(hj)[:n], RTOL)
    got = dt_.numpy().transpose(2, 0, 1).reshape(len(SYM), n, 3, 3)
    want = np.asarray(dj).reshape(len(SYM), n, 3, 3)
    for k in range(len(SYM)):
        assert _close(got[k], want[k], JVP_TOL), SYM[k]
    return np.asarray(hj)[:n]


@pytest.mark.parametrize("case", list(LAWS))
def test_law_matches_reference(case):
    """Stress and new history at 1e-12 over N_STATES seeded states, every
    branch taken by at least 3 of them, and the stress's forward
    derivatives along the six symmetric directions at 1e-10."""
    spec, dt = LAWS[case]
    jm, tm = _materials(spec)
    C, h = _states(tm, np.random.default_rng(23))
    hj = _held(jm, tm, dt, C, h)
    for name, mask in _branches(tm, spec, C, h, hj, dt).items():
        assert mask.sum() >= 3, f"branch {name!r}: {mask.sum()} states"


@pytest.mark.parametrize("case", [c for c in LAWS if c.endswith("_dt")])
def test_law_at_identity_matches_reference(case):
    """C = I exactly, the state of every Gauss point at u = 0 (the fibre
    stretch on lam = 1 and I4 = 1, Blemker's H1 on its clamp): stress, new
    history and the forward derivatives held on those states alone."""
    spec, dt = LAWS[case]
    jm, tm = _materials(spec)
    h = _histories(tm, np.random.default_rng(5), 12)
    C = np.tile(np.eye(3), (12, 1, 1))
    _held(jm, tm, dt, C, h)


def test_mixture_matches_reference():
    """The history-free mixture: PK2 stress of the mass fractions'
    constituents at 1e-12 and its forward derivatives at 1e-10, also at
    E = 0 (the fibre summand's tie)."""
    import jax
    import jax.numpy as jnp

    jm, tm = _materials(MIXTURE)
    n = N_STATES
    C = np.tile(_strains(np.random.default_rng(3), n, (1.0, 1.0, 0.0)),
                (len(SYM), 1, 1))
    E = 0.5 * (C - np.eye(3)).transpose(1, 2, 0)
    d = _directions(n).transpose(1, 2, 0)
    sj, dj = jax.jvp(jm.pk2_from_E, (jnp.asarray(E),), (jnp.asarray(d),))
    st, dt_ = torch.func.jvp(tm.pk2_from_E, (torch.as_tensor(E),),
                             (torch.as_tensor(d),))
    assert _close(st.numpy()[..., :n], np.asarray(sj)[..., :n], RTOL)
    assert tm.density == jm.density
    got = dt_.numpy().reshape(3, 3, len(SYM), n)
    want = np.asarray(dj).reshape(3, 3, len(SYM), n)
    for k in range(len(SYM)):
        for rows in (slice(None), slice(0, n // 6)):  # all, and E = 0
            assert _close(got[:, :, k, rows], want[:, :, k, rows], JVP_TOL)


@pytest.mark.parametrize("spec", [GROWTH_ISO, MUSCLE_ACTIVE, GR_CM,
                                  LAWS["mixture_rule_isotropic_impl"][0],
                                  BLEMKER, {**ANISO, "tau0": 2.5}],
                         ids=lambda s: s["type"])
def test_initial_history_is_the_references(spec):
    jm, tm = _materials(spec)
    want = np.asarray(jm.init_history(7))
    got = tm.init_history(7)
    assert got.shape == want.shape and got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


def test_symbolic_expression_on_tensors():
    """The cardiac deck's u(t), with comparisons, and an expression with
    calls and constants, on a tensor of times: the numpy evaluation's
    values, in the tensor's dtype and shape."""
    t = np.array([[0.0, 0.125, 0.5], [0.5000000001, 0.875, 1.0]])
    for src in ("4*(t <= 0.5) - 4*(t > 0.5)",
                "sin(2*t) + min(t, 0.3) - (t >= 0.875) * pi", "2.5"):
        e = SymbolicExpression(src)
        for dtype in (torch.float64, torch.float32):
            got = e.on_device(torch.as_tensor(t, dtype=dtype))
            assert got.dtype == dtype and got.shape == t.shape
            want = np.broadcast_to(e(t=t.astype(
                np.float32 if dtype == torch.float32 else np.float64)),
                t.shape)
            np.testing.assert_allclose(got.double().numpy(), want,
                                       rtol=1e-15 if dtype == torch.float64
                                       else 1e-6, atol=0.0)


def _box_deck(law, kinem):
    return {"problem": {"type": "structure"},
            "structural_dynamic": {"dynamictype": "statics", "kinem": kinem,
                                   "numstep": 1, "timestep": 0.5},
            "solver": {"method": "direct"},
            "materials": {1: law},
            "geometry": {"generator": {"kind": "box", "nx": 2, "ny": 1,
                                       "nz": 1, "cell": "hex8", "mat": 1}},
            "conditions": {"dirichlet": [{"nodes": "xmin",
                                          "onoff": [1, 1, 1],
                                          "val": [0, 0, 0]}]}}


@pytest.mark.parametrize("spec", [GROWTH_ISO, MUSCLE_ACTIVE, GR_CM,
                                  LAWS["mixture_rule_isotropic_impl"][0],
                                  BLEMKER, ANISO], ids=lambda s: s["type"])
def test_law_under_kinem_linear_is_refused(spec):
    """The laws have no small-strain form, nor has the reference:
    refused by name before the field is built."""
    law = type(make_material(dict(spec))).__name__
    deck = deck_mod.load(_box_deck(spec, "linear"))
    with pytest.raises(NotImplementedError,
                       match=f"{law} under kinem 'linear'"):
        structure_driver.check_supported(deck)


@pytest.mark.parametrize("spec", [
    {"type": "mixture", "constituents": [{"frac": 1.0,
                                          "material": GROWTH_ISO}]},
    {"type": "mixture_rule", "constituents": [
        {"kind": "solid", "frac": 1.0, "material": ANISO}]}],
    ids=["mixture", "mixture_rule"])
def test_history_carrying_constituent_is_refused(spec):
    """A constituent with Gauss-point history raises ValueError, as the
    reference's does."""
    jm_error = None
    try:
        _materials(spec)
    except ValueError as exc:
        jm_error = exc
    assert jm_error is not None and "history" in str(jm_error)
    with pytest.raises(ValueError, match="history-free"):
        make_material(dict(spec))


def _permuted_box(n):
    """An n^3 box of hex8 with its nodes renumbered at random: general
    topology, no lattice."""
    from fourc_tpu_torch.core import gridgen

    disc = gridgen.box(n, n, n)
    perm = np.random.RandomState(1).permutation(disc.n_nodes).astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(disc.n_nodes, dtype=np.int32)
    disc.coords = np.asarray(disc.coords)[perm]
    disc.structured_shape = None
    for blk in disc.blocks.values():
        blk.conn = inv[np.asarray(blk.conn)]
    for nm in disc.node_sets:
        disc.node_sets[nm] = inv[np.asarray(disc.node_sets[nm])]
    return disc


@pytest.mark.parametrize("spec", [
    {**GR_CM, "youngs_elastin": 1.0e4},
    _mixture_rule("growthremodel", "isotropic", (True, True), solid={
        "type": "elasthyper", "summands": [
            {"type": "couplogneohooke", "youngs": 1.0e4, "nue": 0.3}]})],
    ids=["growthremodel_cm", "mixture_rule"])
def test_sa_amg_builds_from_the_elastin(spec):
    """A growthremodel_cm or mixture_rule block has no youngs of its own:
    SA-AMG's linear-elastic operator takes its elastin's (1e4, 0.3), the
    same matrix as a Neo-Hooke block's of those moduli, and the hierarchy
    builds; a deck with precond gmg or amg is not refused for it."""
    from fourc_tpu_torch.core.conditions import DirichletBC
    from fourc_tpu_torch.physics import solid as ps

    def field(law):
        disc = _permuted_box(3)
        params = ps.SolidParams(kinem="nonlinear", dyntype="genalpha",
                                precond="amg")
        dbc = [DirichletBC(disc.node_sets["zmin"], [1, 1, 1], [0, 0, 0])]
        return ps.SolidField(disc, {1: make_material(dict(law))}, params,
                             dirichlet=dbc, device="cpu")

    f = field({**spec, "density": 1.0})
    want = field({"type": "neohooke", "youngs": 1.0e4, "nue": 0.3,
                  "density": 1.0}).assemble_linear_operator(250.0)
    got = f.assemble_linear_operator(250.0)
    assert got.shape == want.shape == (192, 192)
    np.testing.assert_array_equal(got.toarray(), want.toarray())
    M = f._build_amg(250.0)
    assert M is f._build_amg(250.0) and len(M.levels) >= 1
    for precond in ("gmg", "amg"):
        deck = _box_deck(spec, "nonlinear")
        deck["solver"] = {"method": "cg", "precond": precond}
        structure_driver.check_supported(deck_mod.load(deck))


# gate deck -> the reference's Newton iterations (its CLI run, one substep
# per step, 3/3 anchors)
DECKS = {"muscle_active_twitch": 12, "muscle_blemker_contraction": 13,
         "cardiac_active_stress_twitch": 24, "growth_remodel_strip": 14,
         "mixture_gr_artery_strip": 19}


@pytest.mark.parametrize("name", list(DECKS))
def test_gate_deck_through_the_cli(name, capsys):
    """Each deck through ``app.main`` on the CPU in float64: its anchors
    met, with the reference's Newton iterations and one substep per
    step."""
    path = os.path.join(ROOT, "decks", f"{name}.yaml")
    assert main([path, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "result tests: 3/3 passed" in out
    m = re.search(r"(\d+) steps \((\d+) substeps\), (\d+) Newton its", out)
    assert m and m.group(1) == m.group(2), out
    assert int(m.group(3)) == DECKS[name], out
