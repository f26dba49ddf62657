"""Slice 4c: statics, one-step-theta and explicit steps, lumped mass and
Rayleigh damping, linear kinematics, Jacobi and block-Jacobi, and
Zienkiewicz-Xie adaptivity, on the CPU in float64.

Held against the JAX package op by op, eagerly on tiny inputs (no jit, no
step): D^2 f against ``jax.jvp`` of ``jax.jvp`` of the reference's XLA
stencil force, the linear-kinematics element route against
``_internal_force_einsum(kinem="linear")`` and its ``jax.jvp``, the Jacobi
and block-Jacobi preconditioners against the reference field's
``build_preconditioner``, all at 1e-12 relative; the adaptive controller
against the reference's on the same synthetic steps.  The steps themselves
are held against closed forms (two patch tests under statics) and the
Rayleigh step's Newton operator against a finite difference of its
residual.  The four gate decks meet their anchors in tests/port/
test_torch_deck.py; here one of them runs through the CLI in a process
that must not import JAX.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import fsolve

from fourc_tpu.core import cells as jcells
from fourc_tpu.core import gridgen as jgrid
from fourc_tpu.core.conditions import DirichletBC as JDirichletBC
from fourc_tpu.materials import make_material as jmake
from fourc_tpu.ops import lattice as jlat
from fourc_tpu.ops import solid as jsolid
from fourc_tpu.physics import driver as jdriver
from fourc_tpu.physics import solid as jps
from fourc_tpu_torch.core import cells, gridgen
from fourc_tpu_torch.core.conditions import DirichletBC, NeumannBC
from fourc_tpu_torch.materials import make_material
from fourc_tpu_torch.materials.elastic import lame
from fourc_tpu_torch.ops import lattice as lat
from fourc_tpu_torch.ops import solid as sops
from fourc_tpu_torch.physics import driver, solid as ps
from fourc_tpu_torch.physics import solid_lattice as psl

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RTOL = 1e-12
MATERIALS = {
    "neohooke": {"type": "neohooke", "youngs": 500.0, "nue": 0.3,
                 "density": 2.0},
    "svk": {"type": "stvenantkirchhoff", "youngs": 500.0, "nue": 0.3,
            "density": 2.0},
}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- D^2 f: the second derivative of the lattice force ----------------------


@pytest.mark.parametrize("model", ["neohooke", "svk"])
def test_force_hessian_matches_reference(model):
    """neo_force_hessian_at(u, w)(dv) == d/dt K(u + t dv) w of the reference's
    XLA stencil force on a 3^3 lattice (float64, 1e-12)."""
    hi = (1.2, 0.7, 2.0)
    spec = lat.detect_lattice(gridgen.box(3, 3, 3, hi=hi))
    jspec = jlat.detect_lattice(jgrid.box(3, 3, 3, hi=hi))
    lam, mu = lame(500.0, 0.3)
    rng = np.random.default_rng(3)
    u, w, dv = (rng.normal(size=spec.ndof) * s for s in (5e-2, 1e-2, 1e-2))
    G, wdet = lat.uniform_geometry(cells.get_cell("hex8"), spec)
    tu, tw, tdv = (lat.to_lattice(torch.as_tensor(x), spec)
                   for x in (u, w, dv))
    got = lat.neo_force_hessian_at(tu, tw, G, wdet, lam, mu, model)(tdv)
    jG, jw = jlat.uniform_geometry(jcells.get_cell("hex8"), jspec)
    U, W, D = (jlat.to_lattice(jnp.asarray(x), jspec) for x in (u, w, dv))

    def force(x):
        return jlat.neo_force_ref(x, jspec, jG, jw, lam, mu, model)

    want = jax.jvp(lambda x: jax.jvp(force, (x,), (W,))[1], (U,), (D,))[1]
    assert _rel(got.numpy(), want) <= RTOL
    shell = got.clone()
    shell[:, 1:-1, 1:-1, 1:-1] = 0.0
    assert not shell.any()  # the ghost shell stays zero


# -- kinem linear: the element route ----------------------------------------


@pytest.mark.parametrize("mname", list(MATERIALS))
@pytest.mark.parametrize("cell", ["hex8", "tet4"])
def test_linear_kinematics_element_route_matches_reference(cell, mname):
    """Small-strain force sum_g wdet sigma(eps) G and its tangent ==
    ``_internal_force_einsum(kinem="linear")`` and ``jax.jvp`` of it
    (float64, 1e-12)."""
    disc = gridgen.box(2, 1, 1, cell=cell)
    conn = disc.blocks[cell].conn
    rng = np.random.default_rng(5)
    X = (disc.coords + rng.uniform(-0.08, 0.08, disc.coords.shape))[conn]
    u = rng.normal(size=X.shape) * 0.05
    v = rng.normal(size=X.shape)
    c = cells.get_cell(cell)
    mat = make_material(dict(MATERIALS[mname]))

    def batch(a):
        return torch.as_tensor(a.reshape(a.shape[0], -1).T.copy())

    G, wdet = sops.element_geometry(batch(X), c)
    got_f = sops.element_force(G, wdet, batch(u), mat, kinem="linear")
    got_t = sops.element_tangent(G, wdet, batch(u), batch(v), mat,
                                 kinem="linear")
    jc, jm = jcells.get_cell(cell), jmake(dict(MATERIALS[mname]))
    Xe = jnp.asarray(X)
    want_f, want_t = jax.jvp(
        lambda x: jsolid._internal_force_einsum(Xe, x, jc, jm,
                                                kinem="linear")[0],
        (jnp.asarray(u),), (jnp.asarray(v),))
    nen = c.nen
    assert _rel(got_f.numpy().T.reshape(-1, nen, 3), want_f) <= RTOL
    assert _rel(got_t.numpy().T.reshape(-1, nen, 3), want_t) <= RTOL


def test_linear_kinematics_takes_general_topology_and_amg():
    """kinem linear takes the element route for every block, hex8 of a
    kernel law included, and ``gmg`` falls back to SA-AMG with a warning
    (as the reference's lattice and Pallas paths need kinem nonlinear)."""
    disc = gridgen.box(2, 2, 2)
    params = ps.SolidParams(kinem="linear", dyntype="statics",
                            precond="gmg")
    f = ps.SolidField(disc, {1: make_material(dict(MATERIALS["svk"]))},
                      params, dirichlet=[DirichletBC(disc.node_sets["zmin"],
                                                     [1, 1, 1], [0, 0, 0])],
                      device="cpu")
    assert f.lattice is None
    assert [(b.cell.name, b.model, b.kinem) for b in f.blocks] == [
        ("hex8", None, "linear")]
    with pytest.warns(UserWarning, match="SA-AMG"):
        step = ps.make_step(f, dt=1.0)
    assert step.precond is not None


# -- Jacobi and block-Jacobi ------------------------------------------------


@pytest.mark.parametrize("kinem", ["nonlinear", "linear"])
@pytest.mark.parametrize("kind", ["jacobi", "block_jacobi"])
def test_jacobi_preconditioners_match_reference(kind, kinem):
    """The per-state preconditioner from the element tangents' nodal
    diagonal blocks at u plus a mass shift, applied to a random vector ==
    the reference field's ``build_preconditioner`` (2^3 box, float64,
    1e-12).  Nonlinear: the lattice field, blocks from B7's twin; linear:
    general topology, blocks from the element route."""
    spec = MATERIALS["neohooke"]
    shift = 250.0
    fields = {}
    for pkg, gg, bc, mk in ((ps, gridgen, DirichletBC, make_material),
                            (jps, jgrid, JDirichletBC, jmake)):
        disc = gg.box(2, 2, 2)
        params = pkg.SolidParams(kinem=kinem, dyntype="genalpha",
                                 precond=kind)
        kw = {"device": "cpu"} if pkg is ps else {}
        fields[pkg] = pkg.SolidField(
            disc, {1: mk(dict(spec))}, params,
            dirichlet=[bc(disc.node_sets["zmin"], [1, 1, 1], [0, 0, 0])],
            **kw)
    fp, fj = fields[ps], fields[jps]
    assert (fp.lattice is None) == (kinem == "linear")
    rng = np.random.default_rng(11)
    u = rng.normal(size=fp.ndof) * 0.05
    r = rng.normal(size=fp.ndof)
    M = fp.build_preconditioner(fp.to_lattice(torch.as_tensor(u)), shift)
    got = fp.from_lattice(M(fp.to_lattice(torch.as_tensor(r))))
    want = fj.build_preconditioner(jnp.asarray(u), mass_shift=shift)(
        jnp.asarray(r))
    assert _rel(got.numpy(), want) <= RTOL


# -- statics: two patch tests against closed forms --------------------------


def _uniaxial_box(mat_spec, kinem, traction, precond="jacobi",
                  lin_method="cg"):
    """A 2 x 1 x 1 box on rollers (x=0, y=0, z=0 normal displacements
    held) pulled by a uniform traction on x=2: statics, one step."""
    disc = gridgen.box(4, 2, 2, hi=(2.0, 1.0, 1.0))
    params = ps.SolidParams(kinem=kinem, dyntype="statics", precond=precond)
    nw = params.newton
    nw.tol_res, nw.tol_disp, nw.combine = 1e-11, 1e-12, "and"
    nw.lin_adaptive, nw.lin_rtol, nw.lin_method = False, 1e-13, lin_method
    dbc = [DirichletBC(disc.node_sets[s], [int(k == i) for k in range(3)],
                       [0, 0, 0]) for i, s in enumerate(("xmin", "ymin",
                                                         "zmin"))]
    neu = [NeumannBC(disc.face_sets["xmax"], [1, 0, 0], [traction, 0, 0])]
    f = ps.SolidField(disc, {1: make_material(dict(mat_spec))}, params,
                      dirichlet=dbc, neumann=neu, device="cpu")
    state = ps.compute_initial_state(f, ps.init_state(f))
    state, stats = ps.make_step(f, dt=1.0)(state)
    assert stats["converged"]
    d = psl.from_lattice_state(f, state)["d"].numpy().reshape(-1, 3)
    return disc.coords, d


@pytest.mark.parametrize("solver", ["cg_jacobi", "direct"])
def test_linear_elastic_uniaxial_patch(solver):
    """kinem linear SVK is linear elasticity: u = (s x, -nu s y, -nu s z)
    / E exactly, by CG + Jacobi and by the direct solve (1e-9)."""
    E, nu, s = 1000.0, 0.3, 10.0
    X, d = _uniaxial_box({"type": "stvenantkirchhoff", "youngs": E,
                          "nue": nu, "density": 1.0}, "linear", s,
                         lin_method="cg" if solver == "cg_jacobi"
                         else "direct")
    want = np.stack([s * X[:, 0], -nu * s * X[:, 1], -nu * s * X[:, 2]],
                    axis=1) / E
    assert _rel(d, want) <= 1e-9


def test_neohooke_uniaxial_patch():
    """Neo-Hooke under a nominal traction t on rollers: the homogeneous
    stretch diag(l1, l2, l2) with P11 = t and P22 = 0, solved in 1D, on the
    lattice path with block-Jacobi from B7's twin (1e-9)."""
    E, nu, t = 1000.0, 0.3, 50.0
    lam, mu = lame(E, nu)

    def piola(l):
        l1, l2 = l
        lnJ = np.log(l1 * l2 * l2)
        return [mu * (l1 - 1 / l1) + lam * lnJ / l1 - t,
                mu * (l2 - 1 / l2) + lam * lnJ / l2]

    l1, l2 = fsolve(piola, [1.0, 1.0], xtol=1e-15)
    X, d = _uniaxial_box({"type": "neohooke", "youngs": E, "nue": nu,
                          "density": 1.0}, "nonlinear", t,
                         precond="block_jacobi")
    want = X * np.array([l1 - 1, l2 - 1, l2 - 1])
    assert l1 > 1.04 and _rel(d, want) <= 1e-9


# -- gen-alpha with Rayleigh damping: the Newton operator --------------------


@pytest.mark.parametrize("case", ["lumped", "consistent",
                                  "m_damp_general_topology"])
def test_rayleigh_newton_operator_is_the_residual_derivative(case):
    """The operator (1-af)(1+rb c) K + (...) M + rb D^2f[v_mid, .] is the
    derivative of the damped residual: central difference of the residual
    along a random direction, 1e-6 relative.  On general topology (kinem
    linear SVK, the element route) with m_damp alone."""
    disc = gridgen.box(3, 3, 3)
    general = case == "m_damp_general_topology"
    params = ps.SolidParams(
        dyntype="genalpha", precond="gmg",
        mass="consistent" if general else case, rayleigh_alpha=0.3,
        rayleigh_beta=0.0 if general else 0.002,
        kinem="linear" if general else "nonlinear",
        genalpha=ps.GenAlphaParams(rho_inf=0.9))
    mat = make_material(dict(MATERIALS["svk" if general else "neohooke"]))
    f = ps.SolidField(disc, {1: mat}, params, dirichlet=[DirichletBC(
        disc.node_sets["zmin"], [1, 1, 1], [0, 0, 0])], device="cpu")
    assert (f.lattice is None) == general
    rng = np.random.default_rng(17)

    def rand(scale):
        return f.to_lattice(torch.as_tensor(rng.normal(size=f.ndof) * scale))

    state = {"d": rand(0.02), "v": rand(0.5), "a": rand(10.0), "t": 0.0,
             "step": 0, "fext": rand(1.0)}
    state["fint"] = f.internal_force(state["d"])
    residual, matvec = psl.genalpha_system(f, 0.02, state, rand(1.0))
    u, dv = rand(0.05), rand(1.0)
    h = 1e-6
    fd = (residual(u + h * dv) - residual(u - h * dv)) / (2 * h)
    assert _rel(matvec(u, dv).numpy(), fd.numpy()) <= 1e-6


# -- Zienkiewicz-Xie: the adaptive controller -------------------------------


def test_adaptive_controller_matches_reference():
    """The same synthetic steps (an error that peaks with a pulse in t)
    through the port's and the reference's ``time_loop_adaptive``: the same
    accepted step sizes, rejections and final time."""
    def make_step(dt):
        def step(state):
            return {"t": state["t"] + dt, "a": state["a"]}, {
                "converged": True, "iters": 1, "lin_iters": 0,
                "resnorm": 0.0}

        return step

    def error_fn(old, new, dt):
        t = float(new["t"])
        return 2e-6 * (dt / 0.1) ** 3 * (1 + 80 * np.exp(-200 * (t - 0.2)
                                                          ** 2))

    kw = dict(tol=2e-6, dtmin=0.00625, dtmax=None, safety=0.9,
              verbose=False)
    accepted = []
    _, agg = driver.time_loop_adaptive(
        "s", {"t": 0.0, "a": None}, make_step, 0.1, 0.4, error_fn, **kw)
    st, jagg = jdriver.time_loop_adaptive(
        "s", {"t": 0.0, "a": None}, make_step, 0.1, 0.4, error_fn,
        callbacks=[lambda name, s, a: accepted.append(float(s["t"]))], **kw)
    assert agg["rejections"] == jagg["rejections"] > 0
    assert agg["dt_levels"] == jagg["dt_levels"]
    assert len(agg["dt_levels"]) > 1
    assert np.allclose(np.cumsum(agg["dt_history"]), accepted, rtol=0,
                       atol=1e-14)
    assert st["t"] == pytest.approx(0.4)


def test_adaptive_error_estimate_reads_lattice_states():
    """On a lattice field (the one-step-theta deck) the Zienkiewicz-Xie
    estimate reads the flat initial state and a step's lattice state alike,
    and is |beta - 1/6| dt^2 ||a1 - a0|| / sqrt(ndof), beta = theta / 2."""
    from fourc_tpu_torch.io import deck as deck_mod
    from fourc_tpu_torch.physics import structure_driver

    deck = deck_mod.load(os.path.join(ROOT, "decks",
                                      "solid_ost_vibration.yaml"))
    f = structure_driver.build_field(deck, device="cpu")
    assert f.lattice is not None
    s0 = ps.compute_initial_state(f, ps.init_state(f))
    s1, stats = ps.make_step(f, dt=0.05)(s0)
    assert stats["converged"] and s1["a"].dim() == 4
    da = f.from_lattice(s1["a"]) - s0["a"]
    want = (abs(0.66 / 2 - 1 / 6) * 0.05 ** 2
            * float(torch.linalg.vector_norm(da)) / f.ndof ** 0.5)
    got = ps.make_zienxie_error_fn(f)(s0, s1, 0.05)
    assert want > 0 and got == pytest.approx(want, rel=1e-14)


# -- what stays refused -----------------------------------------------------


def test_rayleigh_outside_genalpha_is_refused():
    disc = gridgen.box(2, 2, 2)
    for dyntype in ("statics", "onesteptheta", "explicit"):
        params = ps.SolidParams(dyntype=dyntype, rayleigh_alpha=0.1)
        f = ps.SolidField(disc, {1: make_material(dict(MATERIALS["svk"]))},
                          params, device="cpu")
        with pytest.raises(NotImplementedError, match="Rayleigh"):
            ps.make_step(f, dt=0.1)


def test_explicit_deck_through_the_cli_imports_no_jax():
    """The explicit deck meets its anchors through the CLI in a process
    that imports every module of the port and neither JAX nor the
    reference."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import fourc_tpu_torch\n"
        "for m in pkgutil.walk_packages(fourc_tpu_torch.__path__,\n"
        "                               'fourc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from fourc_tpu_torch.app.main import main\n"
        "assert main(['decks/solid_explicit_wave.yaml', '--device',\n"
        "             'cpu']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'fourc_tpu'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "result tests: 6/6 passed" in out.stdout
