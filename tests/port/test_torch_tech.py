"""Slice 4d: the element technologies F-bar and EAS9 "mild", GMRES and
BiCGStab, the CoupLogNeoHooke and CoupAnisoExpo summands, body forces,
nodal stresses and stiffness-proportional damping off the uniform lattice,
on the CPU in float64.

Held against the JAX package eagerly on tiny inputs (no jit, no step; the
JAX calls take about 10 s together): the F-bar and EAS forces and the F-bar
Gauss-point stresses against ``fourc_tpu.ops.solid`` at 1e-12 relative, the
centre gradients bitwise, the summands' stresses and their forward
derivatives (at the tension-only tie I4* = 1 and above it) at 1e-12,
``gmres`` and ``bicgstab`` on a seeded 60 x 60 nonsymmetric system with the
same iteration counts and x within 1e-10.  The rest is pure torch: every
tangent against a central difference of its force, the EAS patch test, and
the Rayleigh deck's box stepped off the uniform lattice (general geometry,
general topology) against the same box on it.  The four decks of the slice
meet their anchors in tests/port/test_torch_deck.py.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from fourc_tpu_torch.core import cells, gridgen
from fourc_tpu_torch.core.conditions import BodyForce, DirichletBC
from fourc_tpu_torch.core.functions import FunctionManager
from fourc_tpu_torch.linalg import precond, solvers
from fourc_tpu_torch.materials import make_material
from fourc_tpu_torch.ops import solid as sops
from fourc_tpu_torch.physics import driver, solid as ps

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RTOL = 1e-12
MATERIALS = {
    "svk": {"type": "stvenantkirchhoff", "youngs": 100.0, "nue": 0.3},
    "neohooke": {"type": "neohooke", "youngs": 100.0, "nue": 0.3},
}
FIBRES = {  # the two decks' fibre families
    "aligned": {"type": "coupanisoexpo", "k1": 100.0, "k2": 1.0,
                "a": [0.7071067811865475, 0.7071067811865475, 0.0]},
    "goh": {"type": "coupanisoexpo", "k1": 20.0, "k2": 2.0, "kappa": 0.1,
            "a": [0.866025403784, 0.5, 0.0]},
    "couplogneohooke": {"type": "couplogneohooke", "youngs": 60.0,
                        "nue": 0.45},
}
HEX8 = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1],
                 [1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=np.float64)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _elements(seed=3, n=4, scale=0.08):
    """n jittered hex8 elements X, a displacement U and a direction V,
    (n, 8, 3) each."""
    rng = np.random.default_rng(seed)
    X = HEX8[None] + rng.uniform(-0.1, 0.1, (n, 8, 3))
    return X, rng.normal(size=(n, 8, 3)) * scale, rng.normal(size=(n, 8, 3))


def _batch(a):
    """(E, nen, 3) -> element batch (nen*3, E)."""
    return torch.as_tensor(a.reshape(a.shape[0], -1).T.copy())


def _unbatch(t):
    return t.numpy().T.reshape(t.shape[1], -1, 3)


def _geometry(X, tech):
    cell = cells.get_cell("hex8")
    Xb = _batch(X)
    G, wdet = sops.element_geometry(Xb, cell)
    geo = (sops.origin_geometry(Xb, cell)[0] if tech == "fbar"
           else sops.eas_modes(Xb, cell))
    return G, wdet, geo


@pytest.mark.parametrize("name", ["hex8", "tet4", "wedge6"])
def test_origin_gradients_are_the_reference_bitwise(name):
    from fourc_tpu.core import cells as jcells

    np.testing.assert_array_equal(
        cells.origin_dN(name),
        jcells.get_cell(name).eval_shape_deriv(np.zeros(3)))


# -- against the JAX package --------------------------------------------------


@pytest.fixture(scope="module")
def reference():
    """The reference's F-bar and EAS forces for SVK and Neo-Hooke and its
    Gauss-point stresses with and without F-bar, on the seeded elements."""
    import jax.numpy as jnp

    from fourc_tpu.core.cells import get_cell as jcell
    from fourc_tpu.materials import make_material as jmake
    from fourc_tpu.ops import solid as jops

    X, U, _ = _elements()
    Xj, Uj, hex8 = jnp.asarray(X), jnp.asarray(U), jcell("hex8")
    out = {}
    for mname, spec in MATERIALS.items():
        mat = jmake(dict(spec))
        for tech in sops.TECHS:
            f, _ = jops.internal_force(Xj, Uj, hex8, mat, tech=tech)
            out[mname, tech] = np.asarray(f)
    mat = jmake(dict(MATERIALS["neohooke"]))
    for tech in ("none", "fbar"):
        out["gp", tech] = np.asarray(jops.gp_stresses(Xj, Uj, hex8, mat,
                                                      tech=tech))
    return out


@pytest.mark.parametrize("tech", sops.TECHS)
@pytest.mark.parametrize("mname", list(MATERIALS))
def test_tech_force_matches_reference(reference, mname, tech):
    X, U, _ = _elements()
    G, wdet, geo = _geometry(X, tech)
    f = sops.tech_force(tech, G, wdet, geo, _batch(U),
                        make_material(dict(MATERIALS[mname])))
    assert _rel(_unbatch(f), reference[mname, tech]) <= RTOL


@pytest.mark.parametrize("tech", ["none", "fbar"])
def test_gp_stresses_match_reference(reference, tech):
    X, U, _ = _elements()
    G, _, G0 = _geometry(X, "fbar")
    sig = sops.gp_stresses(G, _batch(U),
                           make_material(dict(MATERIALS["neohooke"])),
                           tech=tech, G0=G0)  # (3, 3, g, E)
    assert _rel(sig.permute(3, 2, 0, 1).numpy(), reference["gp", tech]) \
        <= RTOL


def _summand_material(name):
    return {"type": "elasthyper", "density": 1.0,
            "summands": [dict(FIBRES[name])]}


@pytest.mark.parametrize("name", list(FIBRES))
def test_summand_stress_and_tangent_match_reference(name):
    """S and its forward derivative against the reference's AD of its
    strain energy: at E = 0 (for the fibres the tension-only tie I4* = 1,
    where the reference's tangent carries a quarter of the fibre
    stiffness) and at random strains, 1e-12."""
    import jax
    import jax.numpy as jnp

    from fourc_tpu.materials import make_material as jmake

    spec = _summand_material(name)
    mat, jmat = make_material(dict(spec)), jmake(dict(spec))
    rng = np.random.default_rng(1)
    H = rng.normal(size=(3, 3, 30)) * 0.2
    E = 0.5 * (H + H.transpose(1, 0, 2) + np.einsum("kiM,kjM->ijM", H, H))
    E[..., 0] = 0.0
    dE = rng.normal(size=(3, 3, 30))
    dE = 0.5 * (dE + dE.transpose(1, 0, 2))
    S, dS = torch.func.jvp(mat.pk2_from_E, (torch.as_tensor(E),),
                           (torch.as_tensor(dE),))
    jS, jdS = jax.jvp(jmat.pk2_from_E, (jnp.asarray(E),), (jnp.asarray(dE),))
    assert _rel(S.numpy(), np.asarray(jS)) <= RTOL
    assert _rel(dS.numpy(), np.asarray(jdS)) <= RTOL
    tie = np.asarray(jdS)[..., 0]
    assert np.abs(dS.numpy()[..., 0] - tie).max() <= RTOL * np.abs(tie).max()


def test_fibre_tangent_at_the_tie_is_a_quarter():
    """At I4 = 1 exactly (a fibre along x, E = 0) the tangent carries a
    quarter of the fibre stiffness (JAX's tie rule through two
    derivatives), just above it all of it: a.dS.a = 4 k1 w^2 along
    dE = a a.  (Whether a deck's undeformed fibre sits on the tie depends
    on the rounding of its normalised a; the summand test above holds the
    decks' fibres against the reference at E = 0.)"""
    spec = {"type": "elasthyper", "density": 1.0, "summands": [
        {**FIBRES["aligned"], "a": [1.0, 0.0, 0.0]}]}
    mat = make_material(spec)
    a = np.array([1.0, 0.0, 0.0])
    dE = torch.as_tensor(np.outer(a, a)[:, :, None])
    quarters = []
    for e in (0.0, 1e-9):
        E = torch.as_tensor(e * np.outer(a, a)[:, :, None])
        _, dS = torch.func.jvp(mat.pk2_from_E, (E,), (dE,))
        quarters.append(float(a @ dS[:, :, 0].numpy() @ a) / (4 * 100.0))
    assert quarters[0] == pytest.approx(0.25, rel=1e-12)
    assert quarters[1] == pytest.approx(1.0, rel=1e-6)


def _nonsymmetric(n=60, seed=0):
    rng = np.random.default_rng(seed)
    return np.eye(n) * 4 + rng.normal(size=(n, n)) * 0.3, rng.normal(size=n)


@pytest.mark.parametrize("use_jacobi", [False, True])
@pytest.mark.parametrize("method, restart", [("gmres", 50), ("gmres", 5),
                                             ("bicgstab", None)])
def test_krylov_matches_reference(method, restart, use_jacobi):
    """GMRES (restart 5 restarts the cycle) and BiCGStab against the
    reference's on a seeded nonsymmetric system: the same iteration count,
    x within 1e-10."""
    import jax.numpy as jnp

    from fourc_tpu.linalg import precond as jprecond
    from fourc_tpu.linalg import solvers as jsolvers

    A, b = _nonsymmetric()
    At, Aj = torch.as_tensor(A), jnp.asarray(A)
    M = precond.jacobi(torch.as_tensor(np.diag(A).copy())) \
        if use_jacobi else None
    jM = jprecond.jacobi(jnp.asarray(np.diag(A))) if use_jacobi else None
    kw = {"restart": restart} if restart else {}
    res = solvers.solve(method, lambda v: At @ v, torch.as_tensor(b), M=M,
                        tol=1e-10, maxiter=300, **kw)
    jres = jsolvers.solve(method, lambda v: Aj @ v, jnp.asarray(b), M=jM,
                          tol=1e-10, maxiter=300, **kw)
    assert res.converged and bool(jres.converged)
    assert res.iters == int(jres.iters)
    assert np.abs(res.x.numpy() - np.asarray(jres.x)).max() <= 1e-10
    if restart == 5:
        assert res.iters > 5


def test_krylov_respects_maxiter_and_atol():
    A, b = _nonsymmetric()
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    for method in ("gmres", "bicgstab"):
        res = solvers.solve(method, lambda v: At @ v, bt, tol=1e-14,
                            maxiter=3, **({"restart": 2}
                                          if method == "gmres" else {}))
        assert not res.converged
        assert res.iters == (4 if method == "gmres" else 3)  # a whole cycle
        res = solvers.solve(method, lambda v: At @ v, bt, tol=0.0, atol=1e30)
        assert res.iters == 0 and res.converged


# -- pure torch ---------------------------------------------------------------


CASES = [("fbar", "svk", "nonlinear"), ("fbar", "neohooke", "nonlinear"),
         ("eas_mild", "svk", "nonlinear"), ("eas_mild", "neohooke",
                                            "nonlinear"),
         ("eas_mild", "svk", "linear")]


@pytest.mark.parametrize("tech, mname, kinem", CASES)
def test_tech_tangent_is_the_force_derivative(tech, mname, kinem):
    """tech_tangent (forward-mode AD of the force, nested through EAS's
    local Newton) against a central difference of tech_force, 1e-7, and
    its mass term against the element route's."""
    X, U, V = _elements(seed=5)
    G, wdet, geo = _geometry(X, tech)
    mat = make_material(dict(MATERIALS[mname]))
    u, v = _batch(U), _batch(V)
    h = 1e-6

    def force(x):
        return sops.tech_force(tech, G, wdet, geo, x, mat, kinem)

    fd = (force(u + h * v) - force(u - h * v)) / (2 * h)
    got = sops.tech_tangent(tech, G, wdet, geo, u, v, mat, kinem=kinem)
    assert _rel(got.numpy(), fd.numpy()) <= 1e-7
    N = torch.as_tensor(cells.get_cell("hex8").N)
    mass = sops.tech_tangent(tech, G, wdet, geo, u, v, mat, 2.5, N,
                             kinem) - got
    want = sops.element_force(G, wdet, v, None, 2.5, N, stiff=False)
    assert _rel(mass.numpy(), want.numpy()) <= RTOL


@pytest.mark.parametrize("kinem", ["linear", "nonlinear"])
def test_eas_patch_test(kinem):
    """A homogeneous deformation u = A X on distorted elements: the
    enhanced parameters stay 0 (int M~ dV = 0), so the EAS force is the
    standard one, and the assembled force vanishes at the interior node of
    a 2 x 2 x 2 box."""
    disc = gridgen.box(2, 2, 2)
    coords = disc.coords.copy()
    coords[13] += [0.07, -0.05, 0.04]  # the interior node
    conn = disc.blocks["hex8"].conn
    A = np.random.default_rng(2).normal(size=(3, 3)) * 0.05
    X = coords[conn]
    U = X @ A.T
    G, wdet, geo = _geometry(X, "eas_mild")
    mat = make_material(dict(MATERIALS["neohooke"]))
    f = sops.tech_force("eas_mild", G, wdet, geo, _batch(U), mat, kinem)
    std = sops.element_force(G, wdet, _batch(U), mat, kinem=kinem)
    assert _rel(f.numpy(), std.numpy()) <= 1e-12
    nodal = np.zeros((disc.n_nodes, 3))
    np.add.at(nodal, conn.reshape(-1), _unbatch(f).reshape(-1, 3))
    assert np.abs(nodal[13]).max() <= 1e-12 * np.abs(nodal).max()


def test_fbar_needs_nonlinear_kinematics():
    X, U, _ = _elements()
    G, wdet, geo = _geometry(X, "fbar")
    mat = make_material(dict(MATERIALS["svk"]))
    with pytest.raises(ValueError, match="nonlinear"):
        sops.tech_force("fbar", G, wdet, geo, _batch(U), mat, "linear")
    with pytest.raises(ValueError, match="nonlinear"):
        ps.SolidField(gridgen.box(1, 1, 1), {1: mat}, ps.SolidParams(
            tech="fbar", kinem="linear"), device="cpu")


def _box_field(tech="none", precond_kind="block_jacobi", body_forces=()):
    disc = gridgen.box(2, 2, 2)
    mat = make_material({**MATERIALS["neohooke"], "density": 0.5})
    fm = FunctionManager()
    fm.add(1, "t*(x+1)")
    return ps.SolidField(
        disc, {1: mat}, ps.SolidParams(tech=tech, precond=precond_kind),
        dirichlet=[DirichletBC(disc.node_sets["zmin"], [1, 1, 1],
                               [0, 0, 0])],
        functions=fm, device="cpu", body_forces=body_forces)


@pytest.mark.parametrize("tech", sops.TECHS)
def test_tech_takes_the_element_route_and_the_standard_preconditioner(tech):
    """Under a tech a lattice box takes general topology and the element
    route; block-Jacobi reads the standard tangent (the reference's
    ``build_preconditioner`` takes no tech)."""
    f, plain = _box_field(tech), _box_field()
    assert f.lattice is None and plain.lattice is not None
    assert [b.tech for b in f.blocks] == [tech] and f.blocks[0].model is None
    u = torch.as_tensor(np.random.default_rng(4).normal(
        size=f.ndof) * 0.02)
    r = torch.as_tensor(np.random.default_rng(5).normal(size=f.ndof))
    got = f.build_preconditioner(u, 3.0)(r)
    want = plain.build_preconditioner(plain.to_lattice(u), 3.0)(
        plain.to_lattice(r))
    assert _rel(got.numpy(), plain.from_lattice(want).numpy()) <= RTOL


def test_body_force_is_the_load_times_the_volume():
    """A body force val * FUNCT(x, t) on a unit box: the assembled total is
    rho val int FUNCT dV (the density 0.5 scales it), FUNCT evaluated on
    the device."""
    f = _box_field(body_forces=[BodyForce(val=[2.0, 0.0, -3.0],
                                          funct=[1, 0, 0])])
    total = f.body_force(0.4).reshape(-1, 3).sum(dim=0).numpy()
    # int_0^1 0.4 (x + 1) dx = 0.6 on the unit box; the derivative tables
    # (the reference's Richardson differences) are exact to about 1e-13
    np.testing.assert_allclose(total, [0.5 * 2.0 * 0.6, 0.0, -0.5 * 3.0],
                               rtol=1e-11, atol=1e-14)
    fext = f.from_lattice(f.external_force(0.4)) if f.lattice is not None \
        else f.external_force(0.4)
    assert _rel(fext.numpy(), f.body_force(0.4).numpy()) <= RTOL


def test_nodal_stresses_of_a_homogeneous_deformation():
    """u = A X gives one Cauchy stress everywhere: every node reads it,
    through the extrapolation and the average, under F-bar too."""
    for tech in ("none", "fbar"):
        f = _box_field(tech)
        A = np.random.default_rng(6).normal(size=(3, 3)) * 0.05
        u = torch.as_tensor((f.disc.coords @ A.T).reshape(-1))
        sig = f.nodal_stresses(u).numpy()
        F = np.eye(3) + A
        mat = make_material(dict(MATERIALS["neohooke"]))
        Egl = 0.5 * (F.T @ F - np.eye(3))
        S = mat.pk2_from_E(torch.as_tensor(Egl[:, :, None]))[:, :, 0]
        want = F @ S.numpy() @ F.T / np.linalg.det(F)
        assert np.abs(sig - want[None]).max() <= 1e-12 * np.abs(want).max()


def _rayleigh_run(monkeypatch, mesh):
    """The Rayleigh deck's box (k_damp 0.002) at 2 x 2 x 2 elements, 2
    steps, under solver: direct: on the uniform lattice, or as general
    geometry on the lattice (the lattice detection turned off: B4/B5's
    twins, D^2f by AD of B5's twin) or as general topology (permuted
    nodes: B6/B7's twins, D^2f by AD of B7's twin).  Returns the nodal d
    after each step in the generator's node order, the Newton counts and
    the field."""
    from fourc_tpu_torch.physics import solid as psolid

    with open(os.path.join(ROOT, "decks",
                           "solid_rayleigh_lumped_wide.yaml")) as fh:
        data = yaml.safe_load(fh)
    data["geometry"]["generator"].update(nx=2, ny=2, nz=2,
                                         permute=mesh == "permuted")
    data["structural_dynamic"]["numstep"] = 2
    data["solver"] = {"method": "direct"}
    data["result_description"] = []
    if mesh == "jittered":
        monkeypatch.setattr(psolid._lat, "detect_lattice", lambda disc: None)
    states = []
    res = driver.run(data, device="cpu", callbacks=[
        lambda _, st, __, out=states: out.append(st)])
    view = res.fields["structure"]
    order = np.lexsort(view.f.disc.coords.T[::-1])
    ds = [view.flat_state(st)["d"].reshape(-1, 3).numpy()[order]
          for st in states]
    return ds, res.stats["structure"]["newton_iters"], view.f


@pytest.fixture(scope="module")
def rayleigh_lattice():
    ds, n, f = _rayleigh_run(None, "uniform")
    assert f.lattice is not None and f.lattice.h is not None
    return ds, n


@pytest.mark.parametrize("mesh", ["jittered", "permuted"])
def test_k_damp_off_the_lattice_matches_the_lattice(monkeypatch, mesh,
                                                    rayleigh_lattice):
    """Stiffness-proportional damping off the uniform lattice: the same
    Newton counts and d within 1e-10 of the largest entry after every
    step as on the lattice."""
    want, n_want = rayleigh_lattice
    got, n_got, f = _rayleigh_run(monkeypatch, mesh)
    if mesh == "jittered":
        assert f.lattice is not None and f.lattice.h is None
    else:
        assert f.lattice is None and f.blocks[0].model == "neohooke"
    assert n_got == n_want
    scale = max(np.abs(d).max() for d in want)
    assert scale > 1e-4
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 1e-10 * scale
