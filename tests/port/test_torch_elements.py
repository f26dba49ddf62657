"""Slice 4b: tet4 and wedge6 cells, the ElastHyper law, the element route,
fields of several blocks and the direct solve, on the CPU in float64.

Held against the JAX package op by op, eagerly (no jit, no step): the cell
tables and the box generator bitwise; the CoupNeoHooke stress against the
reference's AD of its strain energy; the element route's force and tangent
against ``fourc_tpu.ops.solid.internal_force`` (its einsum path on the CPU)
and ``jax.jvp`` of it, at 1e-12 relative; ``solvers.direct`` against the
reference's.  The JAX side of each comparison is computed once per module.
"""

import numpy as np
import pytest
import torch

from fourc_tpu_torch.core import cells, gridgen
from fourc_tpu_torch.core.mesh import Discretization
from fourc_tpu_torch.linalg import solvers
from fourc_tpu_torch.materials import make_material
from fourc_tpu_torch.materials.elastic import lame
from fourc_tpu_torch.ops import solid as sops
from fourc_tpu_torch.physics import solid as ps

RTOL = 1e-12
CELLS = ("hex8", "tet4", "wedge6")
MATERIALS = {
    "neohooke": {"type": "neohooke", "youngs": 100.0, "nue": 0.3,
                 "density": 2.0},
    "svk": {"type": "stvenantkirchhoff", "youngs": 100.0, "nue": 0.3,
            "density": 2.0},
    "elasthyper": {"type": "elasthyper", "density": 2.0, "summands": [
        {"type": "coupneohooke", "youngs": 100.0, "nue": 0.25}]},
}
# the reference element of each cell, jittered per element
CORNERS = {
    "hex8": [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1],
             [1, 0, 1], [1, 1, 1], [0, 1, 1]],
    "tet4": [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
    "wedge6": [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 0, 1],
               [0, 1, 1]],
}
N_ELE, MCOEF = 5, 3.5


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _batch(a):
    """(E, nen, 3) -> element batch (nen*3, E)."""
    return torch.as_tensor(a.reshape(a.shape[0], -1).T.copy())


def _unbatch(t, nen):
    return t.numpy().T.reshape(-1, nen, 3)


def _jax():
    import jax
    import jax.numpy as jnp

    return jax, jnp


@pytest.mark.parametrize("name", ["tet4", "wedge6"])
def test_cell_tables_are_the_reference_bitwise(name):
    from fourc_tpu.core import cells as jcells

    got, want = cells.get_cell(name), jcells.get_cell(name)
    for attr in ("gauss_points", "gauss_weights", "N", "dN"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))
    assert (got.nen, got.dim, got.surfaces) == (want.nen, want.dim,
                                                want.surfaces)


@pytest.mark.parametrize("cell", ["tet4", "wedge6"])
def test_box_is_the_reference_bitwise(cell):
    from fourc_tpu.core import gridgen as jgridgen

    got, want = gridgen.box(2, 2, 2, cell=cell), jgridgen.box(2, 2, 2,
                                                              cell=cell)
    np.testing.assert_array_equal(got.coords, want.coords)
    assert got.blocks.keys() == want.blocks.keys() == {cell}
    assert got.blocks[cell].cell == cell
    np.testing.assert_array_equal(got.blocks[cell].conn,
                                  want.blocks[cell].conn)
    assert got.node_sets.keys() == want.node_sets.keys()
    for nm, ids in got.node_sets.items():
        np.testing.assert_array_equal(ids, want.node_sets[nm])
    assert got.face_sets.keys() == want.face_sets.keys()
    for nm, fbs in got.face_sets.items():
        (a,), (b,) = fbs, want.face_sets[nm]
        assert a.cell == b.cell == "quad4"
        np.testing.assert_array_equal(a.conn, b.conn)


def test_box_refuses_unported_cells():
    with pytest.raises(NotImplementedError, match="not ported"):
        gridgen.box(2, 2, 2, cell="hex27")


@pytest.mark.parametrize("nue", [0.25, 0.0, 0.45])
def test_coupneohooke_stress_matches_reference_ad(nue):
    from fourc_tpu.materials import make_material as jmake

    _, jnp = _jax()
    spec = {"type": "elasthyper", "density": 0.1, "summands": [
        {"type": "coupneohooke", "youngs": 10.0, "nue": nue}]}
    rng = np.random.default_rng(7)
    H = rng.normal(size=(3, 3, 40)) * 0.3
    Egl = 0.5 * (H + H.transpose(1, 0, 2) + np.einsum("kiM,kjM->ijM", H, H))
    got = make_material(dict(spec)).pk2_from_E(torch.as_tensor(Egl))
    want = jmake(dict(spec)).pk2_from_E(jnp.asarray(Egl))
    assert _rel(got.numpy(), want) <= RTOL


def test_unported_summand_is_refused():
    with pytest.raises(NotImplementedError, match="isoyeoh"):
        make_material({"type": "elasthyper", "summands": [
            {"type": "isoyeoh", "c1": 1.0, "c2": 0.0, "c3": 0.0}]})


@pytest.fixture(scope="module")
def route_cases():
    """Per (cell, material): inputs and the reference's force, tangent
    (jax.jvp of the force) and unit-density mass matvec, eagerly."""
    from fourc_tpu.core import cells as jcells
    from fourc_tpu.materials import make_material as jmake
    from fourc_tpu.ops import solid as jsolid

    jax, jnp = _jax()
    out = {}
    rng = np.random.default_rng(3)
    for cname in CELLS:
        jc = jcells.get_cell(cname)
        Xe = (np.asarray(CORNERS[cname], float)[None]
              + rng.uniform(-0.1, 0.1, (N_ELE, jc.nen, 3)))
        ue = rng.normal(size=(N_ELE, jc.nen, 3)) * 0.1
        ve = rng.normal(size=(N_ELE, jc.nen, 3))
        mass = np.asarray(jsolid.consistent_mass_matvec(
            jnp.asarray(Xe), jnp.asarray(ve), jc, 1.0))
        for mname, spec in MATERIALS.items():
            jm = jmake(dict(spec))

            def force(u, jm=jm, Xe=Xe, jc=jc):
                return jsolid.internal_force(jnp.asarray(Xe), u, jc, jm)[0]

            f, t = jax.jvp(force, (jnp.asarray(ue),), (jnp.asarray(ve),))
            out[cname, mname] = (Xe, ue, ve, np.asarray(f),
                                 np.asarray(t) + MCOEF * mass)
    return out


@pytest.mark.parametrize("mname", list(MATERIALS))
@pytest.mark.parametrize("cname", CELLS)
def test_element_route_matches_reference(route_cases, cname, mname):
    Xe, ue, ve, f_want, t_want = route_cases[cname, mname]
    cell = cells.get_cell(cname)
    mat = make_material(dict(MATERIALS[mname]))
    G, wdet = sops.element_geometry(_batch(Xe), cell)
    N = torch.as_tensor(cell.N)
    f = sops.element_force(G, wdet, _batch(ue), mat)
    t = sops.element_tangent(G, wdet, _batch(ue), _batch(ve), mat, MCOEF, N)
    assert _rel(_unbatch(f, cell.nen), f_want) <= RTOL
    assert _rel(_unbatch(t, cell.nen), t_want) <= RTOL


@pytest.mark.parametrize("cname", CELLS)
def test_element_route_mass_matches_reference(route_cases, cname):
    """mcoef * M u alone (stiff=False) is the tangent's mass term."""
    Xe, ue, ve, _, _ = route_cases[cname, "neohooke"]
    cell = cells.get_cell(cname)
    G, wdet = sops.element_geometry(_batch(Xe), cell)
    N = torch.as_tensor(cell.N)
    got = sops.element_force(G, wdet, _batch(ve), None, mcoef=2.5, N=N,
                             stiff=False)
    want = sops.consistent_mass_matvec(Xe, ve, cell, 2.5)
    assert _rel(_unbatch(got, cell.nen), want) <= RTOL


@pytest.mark.parametrize("model", ["neohooke", "svk"])
def test_element_route_matches_hex8_twins(route_cases, model):
    """hex8: the element route and the twins of B6/B7."""
    Xe, ue, ve, _, _ = route_cases["hex8", model]
    cell = cells.get_cell("hex8")
    mat = make_material(dict(MATERIALS[model]))
    lam, mu = lame(mat.youngs, mat.nue)
    X, u, v = _batch(Xe), _batch(ue), _batch(ve)
    G, wdet = sops.element_geometry(X, cell)
    N = torch.as_tensor(cell.N)
    assert _rel(sops.element_force(G, wdet, u, mat, MCOEF, N),
                sops.hex8_force_ref(X, u, lam, mu, model, MCOEF)) <= RTOL
    assert _rel(sops.element_tangent(G, wdet, u, v, mat, MCOEF, N),
                sops.hex8_tangent_ref(X, u, v, lam, mu, model,
                                      MCOEF)) <= RTOL


def _two_block_mesh():
    """A hex8 on [0,1]^3 beside the hex on [1,2]x[0,1]^2 split into two
    wedge6, conforming on the face x = 1, jittered off that face."""
    box = gridgen.box(2, 1, 1, hi=(2.0, 1.0, 1.0))
    X = np.array(box.coords)
    X[:, 1:] += np.random.default_rng(5).uniform(-0.05, 0.05, (len(X), 2))
    hexes = box.blocks["hex8"].conn
    disc = Discretization(name="structure", coords=X)
    disc.add_block("hex8", hexes[:1], 1)
    disc.add_block("wedge6", np.concatenate(
        [hexes[1:, [0, 1, 2, 4, 5, 6]], hexes[1:, [0, 2, 3, 4, 6, 7]]]), 2)
    return disc


@pytest.fixture(scope="module")
def two_blocks():
    """The field of the two-block mesh (hex8 Neo-Hooke on B6/B7's twins,
    wedge6 ElastHyper on the element route) and the reference's
    per-block force, tangent and mass, assembled by hand."""
    from fourc_tpu.core import cells as jcells
    from fourc_tpu.materials import make_material as jmake
    from fourc_tpu.ops import solid as jsolid

    jax, jnp = _jax()
    disc = _two_block_mesh()
    specs = {1: MATERIALS["neohooke"],
             2: {**MATERIALS["elasthyper"], "density": 0.7}}
    f = ps.SolidField(disc, {k: make_material(dict(s))
                             for k, s in specs.items()},
                      ps.SolidParams(dyntype="genalpha", precond="amg"),
                      device="cpu")
    rng = np.random.default_rng(9)
    u = rng.normal(size=f.ndof) * 0.05
    v = rng.normal(size=f.ndof)
    want = {op: np.zeros(f.ndof) for op in ("force", "tangent", "mass",
                                            "lumped")}
    for key, blk in disc.blocks.items():
        jc = jcells.get_cell(blk.cell)
        spec = specs[int(blk.mat_id[0])]
        jm = jmake(dict(spec))
        Xe = jnp.asarray(disc.coords[blk.conn])
        ue, ve = (jnp.asarray(a.reshape(-1, 3)[blk.conn]) for a in (u, v))
        fe, te = jax.jvp(lambda x: jsolid.internal_force(Xe, x, jc, jm)[0],
                         (ue,), (ve,))
        me = jsolid.consistent_mass_matvec(Xe, ve, jc, spec["density"])
        ml = np.repeat(np.asarray(jsolid.lumped_mass(Xe, jc,
                                                     spec["density"])), 3)
        edof = (blk.conn[:, :, None] * 3 + np.arange(3)).reshape(-1)
        for name, val in (("force", fe), ("tangent", te + MCOEF * me),
                          ("mass", me), ("lumped", ml)):
            np.add.at(want[name], edof, np.asarray(val).reshape(-1))
    return f, torch.as_tensor(u), torch.as_tensor(v), want


def test_two_block_field_takes_both_routes(two_blocks):
    f = two_blocks[0]
    assert f.lattice is None
    assert [(b.key, b.cell.name, b.model) for b in f.blocks] == [
        ("hex8", "hex8", "neohooke"), ("wedge6", "wedge6", None)]


@pytest.mark.parametrize("op", ["force", "tangent", "mass", "lumped"])
def test_two_block_field_assembles_the_blocks(two_blocks, op):
    f, u, v, want = two_blocks
    got = {"force": lambda: f.internal_force(u),
           "tangent": lambda: f.tangent(u, v, MCOEF),
           "mass": lambda: f.mass_matvec(v),
           "lumped": f.lumped_mass}[op]()
    assert _rel(got.numpy(), want[op]) <= RTOL


def test_two_block_amg_refuses_a_law_without_youngs(two_blocks):
    f = two_blocks[0]
    with pytest.raises(NotImplementedError, match="youngs"):
        f.assemble_linear_operator(1.0)


def test_direct_solve_matches_reference():
    from fourc_tpu.linalg import solvers as jsolvers

    _, jnp = _jax()
    rng = np.random.default_rng(11)
    A = rng.normal(size=(12, 12)) + 12 * np.eye(12)
    b = rng.normal(size=12)
    At = torch.as_tensor(A)
    got = solvers.direct(lambda x: At @ x, torch.as_tensor(b))
    want = jsolvers.direct(lambda x: jnp.asarray(A) @ x, jnp.asarray(b))
    assert got.iters == 1 and got.converged
    assert _rel(got.x.numpy(), want.x) <= RTOL
    assert got.resnorm <= 1e-12 * np.linalg.norm(b)
