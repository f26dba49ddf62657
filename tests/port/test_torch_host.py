"""Host layer of the port against fourc_tpu: cells, box generator, functions,
conditions, materials and the setup-time element operators.

Inputs are made with numpy from fixed seeds and handed to both packages.
Tolerances: tables built by the same numpy code must be bit-identical;
anything computed through another summation order is held to 1e-12
relative (float64 roundoff of a few dozen terms).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourc_tpu.core import cells as jcells
from fourc_tpu.core import conditions as jcond
from fourc_tpu.core import functions as jfun
from fourc_tpu.core import gridgen as jgrid
from fourc_tpu.materials import make_material as jmake
from fourc_tpu.materials.small_strain import LinearElastic as JLinearElastic
from fourc_tpu.ops import solid as jsolid
from fourc_tpu_torch.core import cells, conditions, functions, gridgen
from fourc_tpu_torch.materials import make_material
from fourc_tpu_torch.materials.small_strain import LinearElastic
from fourc_tpu_torch.ops import solid as psolid

RTOL = 1e-12


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rtol * scale


@pytest.mark.parametrize("name", ["hex8", "quad4"])
@pytest.mark.parametrize("table", ["N", "dN", "gauss_weights",
                                   "gauss_points"])
def test_cell_tables_identical(name, table):
    got = getattr(cells.get_cell(name), table)
    want = getattr(jcells.get_cell(name), table)
    np.testing.assert_array_equal(got, want)


def test_cell_surfaces_identical():
    assert cells.get_cell("hex8").surfaces == jcells.get_cell("hex8").surfaces


@pytest.mark.parametrize("n, hi", [((4, 3, 5), (1.2, 0.7, 2.0)),
                                   ((2, 2, 2), (1.0, 1.0, 1.0)),
                                   ((6, 1, 3), (3.0, 0.5, 1.0))])
def test_box_matches_reference(n, hi):
    got = gridgen.box(*n, hi=hi)
    want = jgrid.box(*n, hi=hi)
    # the reference may build coordinates in native code: last-bit spacing
    _close(got.coords, want.coords, rtol=1e-15)
    np.testing.assert_array_equal(got.blocks["hex8"].conn,
                                  want.blocks["hex8"].conn)
    assert got.structured_shape == want.structured_shape
    assert sorted(got.node_sets) == sorted(want.node_sets)
    for nm in want.node_sets:
        np.testing.assert_array_equal(got.node_sets[nm], want.node_sets[nm])
    for nm in want.face_sets:
        np.testing.assert_array_equal(got.face_sets[nm][0].conn,
                                      want.face_sets[nm][0].conn)


@pytest.mark.parametrize("ids", ["canonical", "permuted"])
def test_dofmap_rejects_unstructured(ids):
    """Without generator provenance the canonical connectivity is still a
    lattice (detected from conn alone); permuted node ids give a block of
    general topology with a node-incidence table (the name dates from when
    such a mesh was refused)."""
    disc = gridgen.box(2, 3, 2)
    disc.structured_shape = None
    if ids == "canonical":
        blk = disc.dofmap(3).blocks["hex8"]
        assert blk.structured["shape"] == (2, 3, 2)
        assert blk.structured["pshape"] == (3, 4, 3)
        assert blk.inc_clip is None and blk.inc_w is None
        return
    perm = np.random.default_rng(0).permutation(disc.n_nodes)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(disc.n_nodes)
    disc.coords = disc.coords[perm]
    disc.blocks["hex8"].conn = inv[disc.blocks["hex8"].conn].astype(np.int32)
    blk = disc.dofmap(3).blocks["hex8"]
    assert blk.structured is None
    assert blk.inc_clip.shape == blk.inc_w.shape == (disc.n_nodes, 8)
    # every node's real slots name the element corners that are this node
    flat = blk.conn.reshape(-1)
    real = blk.inc_w > 0
    assert int(real.sum()) == flat.size
    node_of_slot = np.broadcast_to(np.arange(disc.n_nodes)[:, None],
                                   real.shape)
    np.testing.assert_array_equal(flat[blk.inc_clip[real]],
                                  node_of_slot[real])


@pytest.mark.parametrize("expr", [
    "sin(50.0*t)*(1-exp(-t/0.06))",
    "2^3^0.5 - -x*y",
    "max(x, 0.5) + heaviside(z - 0.25) * atan2(y, 1.5)",
    "(t >= 0.1) * cos(pi*x) + sqrt(abs(y - z)) / 3",
    "pow(1 + x, 2.5) - log10(2 + t) + e",
])
def test_functions_match_reference(expr):
    rng = np.random.default_rng(1)
    xyz = rng.uniform(0, 1, size=(7, 3))
    for t in (0.0, 0.13, 0.7):
        got = functions.FunctionOfSpaceTime.from_spec(expr)(xyz, t,
                                                            component=0)
        want = jfun.FunctionOfSpaceTime.from_spec(expr)(jnp.asarray(xyz), t,
                                                        component=0)
        _close(got, want, rtol=1e-14)


def test_function_manager_default_is_one():
    fm = functions.FunctionManager()
    np.testing.assert_array_equal(fm.get(0)(np.zeros((3, 3)), 1.0,
                                            component=0), np.ones(3))


def _dbc_setup(mod_cond, mod_fun, disc):
    fm = mod_fun.FunctionManager()
    fm.add(1, "t*(1 + x)")
    conds = [mod_cond.DirichletBC(disc.node_sets["zmin"], [1, 1, 1],
                                  [0.0, 0.0, 0.0]),
             mod_cond.DirichletBC(disc.node_sets["xmax"], [0, 1, 0],
                                  [0.0, 2.5, 0.0], funct=[0, 1, 0])]
    return mod_cond.DirichletHandler(conds, disc.coords, 3, fm)


def test_dirichlet_handler_matches_reference():
    disc = gridgen.box(3, 2, 4)
    got = _dbc_setup(conditions, functions, disc)
    want = _dbc_setup(jcond, jfun, jgrid.box(3, 2, 4))
    np.testing.assert_array_equal(got.free_mask, np.asarray(want.free_mask))
    np.testing.assert_array_equal(got.free_w, np.asarray(want.free_w))
    _close(got.values(0.4), want.values(0.4), rtol=1e-15)
    rng = np.random.default_rng(2)
    u = rng.normal(size=disc.n_nodes * 3)
    _close(got.apply(torch.as_tensor(u), 0.4),
           want.apply(jnp.asarray(u), 0.4), rtol=1e-15)
    _close(got.mask(torch.as_tensor(u)), want.mask(jnp.asarray(u)),
           rtol=1e-15)


@pytest.mark.parametrize("law", ["neohooke", "stvenantkirchhoff"])
@pytest.mark.parametrize("scale", [1e-6, 1e-2, 0.3])
def test_pk2_from_E_matches_reference(law, scale):
    spec = {"type": law, "youngs": 1.0e4, "nue": 0.3, "density": 1.0}
    rng = np.random.default_rng(3)
    H = rng.normal(size=(3, 3, 11)) * scale
    E = 0.5 * (H + H.transpose(1, 0, 2) + np.einsum("ki...,kj...->ij...",
                                                    H, H))
    got = make_material(dict(spec)).pk2_from_E(torch.as_tensor(E))
    want = jmake(dict(spec)).pk2_from_E(jnp.asarray(E))
    _close(got, want)


def test_linear_elastic_stress_matches_reference():
    rng = np.random.default_rng(4)
    eps = rng.normal(size=(3, 3, 5))
    eps = 0.5 * (eps + eps.transpose(1, 0, 2))
    got = LinearElastic(youngs=200.0, nue=0.25).stress_small(
        torch.as_tensor(eps))
    want = JLinearElastic(youngs=200.0, nue=0.25).stress_small(
        jnp.asarray(eps))
    _close(got, want)


def test_make_material_rejects_unported():
    with pytest.raises(NotImplementedError):
        make_material({"type": "mooneyrivlin", "c1": 1.0})


def _elements(seed, E=3):
    """Jittered hex8 elements (general geometry, positive jacobians)."""
    rng = np.random.default_rng(seed)
    base = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], float)
    return base[None] * rng.uniform(0.5, 2.0, size=(E, 1, 3)) + \
        rng.uniform(-0.08, 0.08, size=(E, 8, 3))


@pytest.mark.parametrize("seed", [0, 1])
def test_element_stiffness_matches_reference(seed):
    Xe = _elements(seed)
    cell = cells.get_cell("hex8")
    got = psolid.element_stiffness(Xe, cell, LinearElastic(youngs=200.0,
                                                           nue=0.3))
    want = jsolid.element_stiffness(
        jnp.asarray(Xe), jnp.zeros_like(jnp.asarray(Xe)),
        jcells.get_cell("hex8"), JLinearElastic(youngs=200.0, nue=0.3),
        kinem="linear")
    _close(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_mass_operators_match_reference(seed):
    Xe = _elements(seed)
    rng = np.random.default_rng(10 + seed)
    ve = rng.normal(size=Xe.shape)
    cell, jcell = cells.get_cell("hex8"), jcells.get_cell("hex8")
    _close(psolid.lumped_mass(Xe, cell, 2.7),
           jsolid.lumped_mass(jnp.asarray(Xe), jcell, 2.7))
    _close(psolid.consistent_mass_matvec(Xe, ve, cell, 2.7),
           jsolid.consistent_mass_matvec(jnp.asarray(Xe), jnp.asarray(ve),
                                         jcell, 2.7))


def test_surface_traction_matches_reference():
    disc = gridgen.box(3, 4, 2, hi=(1.5, 1.0, 0.5))
    conn = disc.face_sets["zmax"][0].conn
    Xf = disc.coords[conn]
    rng = np.random.default_rng(5)
    trac = rng.normal(size=(conn.shape[0], 4, 3))
    got = psolid.surface_traction_force(Xf, trac, cells.get_cell("quad4"))
    want = jsolid.surface_traction_force(jnp.asarray(Xf), jnp.asarray(trac),
                                         jcells.get_cell("quad4"))
    _close(got, want)
