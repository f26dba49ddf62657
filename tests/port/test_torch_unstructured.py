"""Slice 3, the permuted box (general topology), against fourc_tpu, float64.

Meshes are made as bench.py makes its ``permuted`` mesh: interior nodes
jittered from ``np.random.RandomState(0)``, then the nodes renumbered at
random from ``np.random.RandomState(1)`` in coordinates, connectivity, node
sets and face sets, so that neither package finds a lattice.  Both packages
get the same mesh, material, loads and Newton settings.  The JAX side:

- the twins of B6 and B7 (ops/solid.py) against
  ``ops/solid._internal_force_einsum``, ``consistent_mass_matvec`` and
  ``jax.jvp`` of the force, to 1e-12 of the largest entry (float64 roundoff
  of a few dozen terms); and against the Pallas kernels ``_run_fwd`` and
  ``_run_jvp`` in interpret mode (float32 inside), to 1e-5 relative;
- what the twins must satisfy by themselves, cheaply: no force from a
  rigid motion, a symmetric tangent that is the derivative of the force, a
  mass that sums to rho * volume;
- the dof map's incidence table, gather and assembly against the
  reference's (identical tables) and against ``np.add.at``;
- the field's operators, the assembled linear operator of the AMG (the
  reference's assembly rebuilt here from its public element operators) and
  the initial state, to 1e-12 (1e-10 for the acceleration, whose mass solve
  stops at 1e-10);
- two gen-alpha steps on the permuted 6^3 box against the reference's step,
  which takes its flat gather/scatter path with SA-AMG by itself.  Newton
  to tol_res 1e-10 with lin_rtol 1e-12, so that the preconditioner (float32
  inside the reference, float64 in the port) does not set the agreement:
  d and v within 1e-7 relative, Newton counts within 1.
"""

import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from fourc_tpu.core import cells as jcells
from fourc_tpu.core import gridgen as jgrid
from fourc_tpu.core.conditions import DirichletBC as JDirichletBC
from fourc_tpu.core.conditions import NeumannBC as JNeumannBC
from fourc_tpu.core.functions import FunctionManager as JFunctionManager
from fourc_tpu.materials import make_material as jmake
from fourc_tpu.materials.small_strain import LinearElastic as JLinearElastic
from fourc_tpu.ops import solid as jsolid
from fourc_tpu.ops import solid_pallas as jspk
from fourc_tpu.physics import solid as jps
from fourc_tpu_torch import convert
from fourc_tpu_torch.core import gridgen
from fourc_tpu_torch.core.conditions import DirichletBC, NeumannBC
from fourc_tpu_torch.core.functions import FunctionManager
from fourc_tpu_torch.materials import make_material
from fourc_tpu_torch.materials.elastic import lame
from fourc_tpu_torch.ops import solid as psolid
from fourc_tpu_torch.ops import solid_kernels as sk
from fourc_tpu_torch.physics import solid as ps

RTOL = 1e-12
N_STEP, DT = 6, 0.05
E_MOD, NUE, RHO = 1.0e4, 0.3, 1.0
MTYPE = {"neohooke": "neohooke", "svk": "stvenantkirchhoff"}
SHAPES = {"4x4x4": (4, 4, 4), "3x2x2": (3, 2, 2), "2x3x5": (2, 3, 5)}


def _permuted(box, shape):
    """bench.py's permuted mesh from either package's box generator."""
    disc = box(*shape)
    X = np.array(disc.coords)
    interior = np.all((X > 1e-12) & (X < 1.0 - 1e-12), axis=1)
    X[interior] += (np.random.RandomState(0).rand(int(interior.sum()), 3)
                    - 0.5) * (0.35 / max(shape))
    perm = np.random.RandomState(1).permutation(disc.n_nodes).astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(disc.n_nodes, dtype=np.int32)
    disc.coords = X[perm]
    disc.structured_shape = None
    for blk in disc.blocks.values():
        blk.conn = inv[np.asarray(blk.conn)]
    for nm in disc.node_sets:
        disc.node_sets[nm] = inv[np.asarray(disc.node_sets[nm])]
    for fbs in disc.face_sets.values():
        for fb in fbs:
            fb.conn = inv[np.asarray(fb.conn)]
    return disc


def _field(pkg, disc, precond="gmg", field_kw=()):
    """The flagship problem on a given mesh in either package."""
    params = pkg.ps.SolidParams(
        kinem="nonlinear", dyntype="genalpha",
        genalpha=pkg.ps.GenAlphaParams(rho_inf=0.9), precond=precond)
    params.newton.tol_res = 1e-10
    params.newton.lin_adaptive = False
    params.newton.lin_rtol = 1e-12
    fm = pkg.FunctionManager()
    fm.add(1, "sin(3.0*t)")
    dbc = [pkg.DirichletBC(disc.node_sets["zmin"], [1, 1, 1], [0, 0, 0])]
    neu = [pkg.NeumannBC(disc.face_sets["zmax"], [1, 0, 0], [80.0, 0, 0],
                         funct=[1, 0, 0])]
    mat = pkg.make_material({"type": "neohooke", "youngs": E_MOD,
                             "nue": NUE, "density": RHO})
    return pkg.ps.SolidField(disc, {1: mat}, params, dirichlet=dbc,
                             neumann=neu, functions=fm, **dict(field_kw))


JAX = types.SimpleNamespace(
    ps=jps, FunctionManager=JFunctionManager, DirichletBC=JDirichletBC,
    NeumannBC=JNeumannBC, make_material=jmake)
PORT = types.SimpleNamespace(
    ps=ps, FunctionManager=FunctionManager, DirichletBC=DirichletBC,
    NeumannBC=NeumannBC, make_material=make_material)


@pytest.fixture(scope="module")
def meshes():
    """The operator meshes in both packages: name -> (port, JAX)."""
    return {name: (_permuted(gridgen.box, shape), _permuted(jgrid.box, shape))
            for name, shape in SHAPES.items()}


@pytest.fixture(scope="module")
def problem():
    """The step problem (permuted 6^3 box, 1,029 dofs) in both packages."""
    fj = _field(JAX, _permuted(jgrid.box, (N_STEP,) * 3))
    fp = _field(PORT, _permuted(gridgen.box, (N_STEP,) * 3),
                field_kw={"device": "cpu"})
    ga = fp.params.genalpha
    return types.SimpleNamespace(
        fj=fj, fp=fp, shift=(1 - ga.alpha_m) / (ga.beta * DT * DT))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _rand(disc, scale, seed):
    return np.random.default_rng(seed).normal(size=disc.n_nodes * 3) * scale


def _batch(disc, v):
    """Flat nodal vector -> the kernels' element batch (24, E), float64."""
    conn = np.asarray(disc.blocks["hex8"].conn)
    return torch.as_tensor(
        np.asarray(v).reshape(-1, 3)[conn].reshape(-1, 24).T.copy())


def _jax_batches(jdisc, *vs):
    """Element batches (E, 8, 3) of the reference for flat nodal vectors."""
    conn = np.asarray(jdisc.blocks["hex8"].conn)
    return [jnp.asarray(np.asarray(v).reshape(-1, 3)[conn]) for v in vs]


def _jax_force(Xe, model):
    mat = jmake({"type": MTYPE[model], "youngs": E_MOD, "nue": NUE,
                 "density": RHO})
    cell = jcells.get_cell("hex8")
    return lambda ue: jsolid._internal_force_einsum(Xe, ue, cell, mat)[0]


def _as24(fe):
    """Reference element vectors (E, 8, 3) -> (24, E)."""
    return np.asarray(fe).reshape(-1, 24).T


# -- B6 / B7 twins ----------------------------------------------------------


@pytest.mark.parametrize("mesh", list(SHAPES))
@pytest.mark.parametrize("model", ["neohooke", "svk"])
def test_force_twin_matches_reference(meshes, mesh, model):
    disc, jdisc = meshes[mesh]
    lam, mu = lame(E_MOD, NUE)
    u = _rand(disc, 2e-2, 1)
    got = psolid.hex8_force_ref(_batch(disc, disc.coords), _batch(disc, u),
                                lam, mu, model)
    Xe, ue = _jax_batches(jdisc, jdisc.coords, u)
    assert _rel(got.numpy(), _as24(_jax_force(Xe, model)(ue))) <= RTOL


@pytest.mark.parametrize("mesh", list(SHAPES))
@pytest.mark.parametrize("mode", ["mass", "fused"])
def test_force_twin_mass_modes_match_reference(meshes, mesh, mode):
    disc, jdisc = meshes[mesh]
    lam, mu = lame(E_MOD, NUE)
    u = _rand(disc, 2e-2, 2)
    mcoef = {"mass": 2.5, "fused": 137.5}[mode]
    got = psolid.hex8_force_ref(_batch(disc, disc.coords), _batch(disc, u),
                                lam, mu, "neohooke", mcoef=mcoef,
                                stiff=mode == "fused")
    Xe, ue = _jax_batches(jdisc, jdisc.coords, u)
    want = _as24(jsolid.consistent_mass_matvec(
        Xe, ue, jcells.get_cell("hex8"), mcoef))
    if mode == "fused":
        want = want + _as24(_jax_force(Xe, "neohooke")(ue))
    assert _rel(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("mesh", list(SHAPES))
@pytest.mark.parametrize("model", ["neohooke", "svk"])
@pytest.mark.parametrize("mcoef", [0.0, 137.5])
def test_tangent_twin_matches_reference(meshes, mesh, model, mcoef):
    disc, jdisc = meshes[mesh]
    lam, mu = lame(E_MOD, NUE)
    u, v = _rand(disc, 2e-2, 3), _rand(disc, 1e-2, 4)
    got = psolid.hex8_tangent_ref(_batch(disc, disc.coords), _batch(disc, u),
                                  _batch(disc, v), lam, mu, model, mcoef)
    Xe, ue, ve = _jax_batches(jdisc, jdisc.coords, u, v)
    _, want = jax.jvp(_jax_force(Xe, model), (ue,), (ve,))
    want = _as24(want) + mcoef * _as24(jsolid.consistent_mass_matvec(
        Xe, ve, jcells.get_cell("hex8"), 1.0))
    assert _rel(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("kernel, model", [("force", "neohooke"),
                                           ("tangent", "svk")])
def test_twins_match_pallas_interpret(meshes, kernel, model):
    """The twins (float64) against the TPU kernels in interpret mode
    (float32 inside, 12 elements padded to one tile of 512)."""
    disc, _ = meshes["3x2x2"]
    lam, mu = lame(E_MOD, NUE)
    u, v = _rand(disc, 2e-2, 5), _rand(disc, 1e-2, 6)
    X24, u24, v24 = (_batch(disc, a) for a in (disc.coords, u, v))
    j32 = [jnp.asarray(a.numpy(), jnp.float32) for a in (X24, u24, v24)]
    if kernel == "force":
        out = jspk._run_fwd(j32[0], j32[1], lam, mu, model=model,
                            interpret=True)
        got = psolid.hex8_force_ref(X24, u24, lam, mu, model)
    else:
        out = jspk._run_jvp(*j32, lam, mu, model=model, interpret=True)
        got = psolid.hex8_tangent_ref(X24, u24, v24, lam, mu, model)
    assert out.dtype == jnp.float32 and out.shape == (24, 12)
    assert _rel(got.numpy(), np.asarray(out, np.float64)) <= 1e-5


def test_cpu_wrappers_use_twins_and_count_nothing(meshes):
    disc, _ = meshes["3x2x2"]
    sk.reset_launches()
    X24 = _batch(disc, disc.coords)
    u24, v24 = _batch(disc, _rand(disc, 2e-2, 7)), _batch(disc,
                                                          _rand(disc, 1., 8))
    np.testing.assert_array_equal(
        sk.hex8_force(X24, u24, 1.0, 1.0, mcoef=2.0).numpy(),
        psolid.hex8_force_ref(X24, u24, 1.0, 1.0, mcoef=2.0).numpy())
    np.testing.assert_array_equal(
        sk.hex8_tangent(X24, u24, v24, 1.0, 1.0, "svk", 3.0).numpy(),
        psolid.hex8_tangent_ref(X24, u24, v24, 1.0, 1.0, "svk", 3.0).numpy())
    assert sk.launches == {"force": 0, "tangent": 0}


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_kernel_input_checks(bad):
    x = torch.zeros(24, 5)
    with pytest.raises(ValueError):
        sk._batch(torch.zeros(5, 24) if bad == "shape"
                  else x.to(torch.float16))
    assert sk._batch(x) == 5


# -- what the twins must satisfy by themselves (no reference needed) --------


def _rotation(angles):
    cx, cy, cz = np.cos(angles)
    sx, sy, sz = np.sin(angles)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


@pytest.mark.parametrize("mesh", list(SHAPES))
@pytest.mark.parametrize("model", ["neohooke", "svk"])
@pytest.mark.parametrize("motion", ["translation", "rotation"])
def test_rigid_motion_gives_no_force(meshes, mesh, model, motion):
    """Total-Lagrangian laws are objective: a rigid motion strains nothing
    (a rotation of 0.7, 0.4, 1.1 rad is far from small)."""
    disc, _ = meshes[mesh]
    lam, mu = lame(E_MOD, NUE)
    X = disc.coords
    if motion == "translation":
        u = np.broadcast_to([0.3, -1.2, 0.05], X.shape)
    else:
        u = X @ _rotation([0.7, 0.4, 1.1]).T - X
    fe = psolid.hex8_force_ref(_batch(disc, X), _batch(disc, u.reshape(-1)),
                               lam, mu, model)
    h = 1.0 / max(SHAPES[mesh])
    assert float(fe.abs().max()) <= 1e-11 * E_MOD * h * h


@pytest.mark.parametrize("mesh", list(SHAPES))
@pytest.mark.parametrize("model", ["neohooke", "svk"])
@pytest.mark.parametrize("mcoef", [0.0, 137.5])
def test_tangent_twin_is_symmetric(meshes, mesh, model, mcoef):
    """A hyperelastic tangent plus a mass is symmetric, element by element:
    what CG needs of the Newton operator."""
    disc, _ = meshes[mesh]
    lam, mu = lame(E_MOD, NUE)
    X24, u24 = _batch(disc, disc.coords), _batch(disc, _rand(disc, 2e-2, 20))
    x, y = _batch(disc, _rand(disc, 1.0, 21)), _batch(disc,
                                                      _rand(disc, 1.0, 22))
    Kx = psolid.hex8_tangent_ref(X24, u24, x, lam, mu, model, mcoef)
    Ky = psolid.hex8_tangent_ref(X24, u24, y, lam, mu, model, mcoef)
    lhs, rhs = (x * Ky).sum(dim=0), (Kx * y).sum(dim=0)  # per element
    assert float((lhs - rhs).abs().max()) <= 1e-12 * float(lhs.abs().max())


@pytest.mark.parametrize("mesh", list(SHAPES))
@pytest.mark.parametrize("model", ["neohooke", "svk"])
def test_tangent_twin_is_the_derivative_of_the_force(meshes, mesh, model):
    """The hand-propagated dual against a central difference of the force
    twin (step 1e-6: truncation 1e-12, roundoff 1e-10 of the force)."""
    disc, _ = meshes[mesh]
    lam, mu = lame(E_MOD, NUE)
    X24, u24 = _batch(disc, disc.coords), _batch(disc, _rand(disc, 2e-2, 23))
    v24 = _batch(disc, _rand(disc, 1e-2, 24))
    eps = 1e-6
    fd = (psolid.hex8_force_ref(X24, u24 + eps * v24, lam, mu, model)
          - psolid.hex8_force_ref(X24, u24 - eps * v24, lam, mu, model)) \
        / (2 * eps)
    got = psolid.hex8_tangent_ref(X24, u24, v24, lam, mu, model)
    assert _rel(got.numpy(), fd.numpy()) <= 1e-7


@pytest.mark.parametrize("mesh", list(SHAPES))
def test_mass_twin_conserves_mass(meshes, mesh):
    """The consistent mass applied to a unit translation sums to
    rho * volume in that direction and to nothing in the others."""
    disc, _ = meshes[mesh]
    ones = np.zeros(disc.coords.shape)
    ones[:, 1] = 1.0
    me = psolid.hex8_force_ref(_batch(disc, disc.coords),
                               _batch(disc, ones.reshape(-1)), 0.0, 0.0,
                               "svk", mcoef=2.5, stiff=False)
    per_comp = me.reshape(8, 3, -1).sum(dim=(0, 2)).numpy()
    np.testing.assert_allclose(per_comp, [0.0, 2.5, 0.0], atol=1e-13)


# -- dof map ----------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(SHAPES))
def test_incidence_table_matches_reference(meshes, mesh):
    disc, jdisc = meshes[mesh]
    ba, jba = disc.dofmap(3).blocks["hex8"], jdisc.dofmap(3).blocks["hex8"]
    assert ba.structured is None and jba.structured is None
    np.testing.assert_array_equal(ba.inc_clip, np.asarray(jba.inc_clip))
    np.testing.assert_array_equal(ba.inc_w, np.asarray(jba.inc_w))
    interior = ba.inc_w.sum(axis=1) == 8  # kmax of a hex box
    assert ba.inc_clip.shape[1] == 8 and 0 < interior.sum() < disc.n_nodes


@pytest.mark.parametrize("mesh", list(SHAPES))
def test_gather_matches_reference(meshes, mesh):
    disc, jdisc = meshes[mesh]
    u = _rand(disc, 1.0, 9)
    got = disc.dofmap(3).gather(torch.as_tensor(u), "hex8")
    want = jdisc.dofmap(3).gather(jnp.asarray(u), "hex8")  # (E, 8, 3)
    np.testing.assert_array_equal(got.numpy(), _as24(want))


@pytest.mark.parametrize("mesh", list(SHAPES))
def test_scatter_add_matches_reference_and_add_at(meshes, mesh):
    disc, jdisc = meshes[mesh]
    conn = np.asarray(disc.blocks["hex8"].conn)
    fe = np.random.default_rng(10).normal(size=(conn.shape[0], 24))
    got = disc.dofmap(3).scatter_add({"hex8": torch.as_tensor(fe.T.copy())})
    want = jdisc.dofmap(3).scatter_add({"hex8": jnp.asarray(fe)})
    assert _rel(got.numpy(), want) <= 1e-15  # 8 terms, another sum order
    edof = (conn[:, :, None] * 3 + np.arange(3)).reshape(-1)
    ref = np.zeros(disc.n_nodes * 3)
    np.add.at(ref, edof, fe.reshape(-1))
    assert _rel(got.numpy(), ref) <= 1e-15


@pytest.mark.parametrize("mesh", list(SHAPES))
def test_scatter_add_of_ones_counts_the_elements_of_a_node(meshes, mesh):
    disc, _ = meshes[mesh]
    conn = np.asarray(disc.blocks["hex8"].conn)
    got = disc.dofmap(3).scatter_add(
        {"hex8": torch.ones(24, conn.shape[0], dtype=torch.float64)})
    valence = np.bincount(conn.reshape(-1), minlength=disc.n_nodes)
    assert set(valence) <= {1, 2, 4, 8}  # corners, edges, faces, interior
    np.testing.assert_array_equal(got.numpy(), np.repeat(valence, 3))


def test_lattice_block_has_no_general_assembly():
    dm = gridgen.box(2, 2, 2).dofmap(3)
    assert dm.blocks["hex8"].inc_clip is None
    with pytest.raises(ValueError, match="lattice"):
        dm.gather(torch.zeros(dm.ndof), "hex8")


# -- field ------------------------------------------------------------------


def test_field_is_general_topology(problem):
    fp = problem.fp
    assert fp.lattice is None and fp.x is None
    (blk,) = fp.blocks
    assert blk.model == "neohooke" and blk.X.dtype == torch.float64
    assert blk.X.shape == (24, N_STEP ** 3)
    assert fp.free.shape == (fp.ndof,)
    v = torch.arange(fp.ndof, dtype=torch.float64)
    assert fp.to_lattice(v) is v and fp.from_lattice(v) is v


@pytest.mark.parametrize("op", ["internal_force", "mass_matvec",
                                "lumped_mass", "external_force", "tangent"])
def test_field_operators_match_reference(problem, op):
    fp, fj = problem.fp, problem.fj
    u, v = _rand(fp.disc, 5e-3, 11), _rand(fp.disc, 1e-2, 12)
    tu, tv = torch.as_tensor(u), torch.as_tensor(v)
    if op == "internal_force":
        got, want = fp.internal_force(tu), fj.internal_force(jnp.asarray(u))[0]
    elif op == "mass_matvec":
        got, want = fp.mass_matvec(tv), fj.mass_matvec(jnp.asarray(v))
    elif op == "lumped_mass":
        got, want = fp.lumped_mass(), fj.lumped_mass()
    elif op == "external_force":
        got, want = fp.external_force(0.3), fj.external_force(0.3)
    else:
        got = fp.tangent(tu, tv, 137.5)
        _, want = jax.jvp(lambda x: fj.internal_force(x)[0],
                          (jnp.asarray(u),), (jnp.asarray(v),))
        want = want + 137.5 / RHO * fj.mass_matvec(jnp.asarray(v))
    assert _rel(got.numpy(), want) <= RTOL


def test_field_masses_agree_with_each_other(problem):
    """The consistent mass of a unit translation is the lumped mass, and
    both hold rho * volume per direction."""
    fp = problem.fp
    ml = fp.lumped_mass()
    assert float(ml.sum()) == pytest.approx(3 * RHO * 1.0, rel=1e-12)
    ex = torch.zeros(fp.ndof, dtype=torch.float64)
    ex[0::3] = 1.0
    mv = fp.mass_matvec(ex)
    assert _rel(mv[0::3].numpy(), ml[0::3].numpy()) <= RTOL
    assert float(mv[1::3].abs().max()) <= 1e-15


def test_field_tangent_is_symmetric(problem):
    fp = problem.fp
    u, x, y = (torch.as_tensor(_rand(fp.disc, s, k))
               for s, k in ((5e-3, 30), (1.0, 31), (1.0, 32)))
    lhs = float(torch.dot(x, fp.tangent(u, y, 137.5)))
    rhs = float(torch.dot(fp.tangent(u, x, 137.5), y))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def _reference_linear_operator(fj, mass_shift):
    """The matrix that the reference's ``SolidField._build_amg`` assembles
    on the host, from its public element operators."""
    cell = jcells.get_cell("hex8")
    Xe = fj.block_X["hex8"]
    lin = JLinearElastic(youngs=E_MOD, nue=NUE)
    Ke = jsolid.element_stiffness(Xe, jnp.zeros_like(Xe), cell, lin,
                                  kinem="linear")
    ml = jsolid.lumped_mass(Xe, cell, RHO)
    Ke = Ke + mass_shift * jax.vmap(jnp.diag)(jnp.repeat(ml, 3, axis=1))
    edof = np.asarray(fj.dofmap.blocks["hex8"].edof)
    A0 = sp.coo_matrix(
        (np.asarray(Ke, np.float64).reshape(-1),
         (np.repeat(edof, 24, axis=1).reshape(-1),
          np.tile(edof, (1, 24)).reshape(-1))),
        shape=(fj.ndof, fj.ndof)).tocsr()
    free = np.asarray(fj.dbc.free_mask)
    D = sp.diags(free.astype(np.float64))
    return (D @ A0 @ D + sp.diags((~free).astype(np.float64))).tocsr()


def test_assembled_linear_operator_matches_reference(problem):
    timings = {}
    got = problem.fp.assemble_linear_operator(problem.shift, timings)
    want = _reference_linear_operator(problem.fj, problem.shift)
    assert set(timings) == {"element_stiffness", "coo_to_csr"}
    assert got.shape == want.shape == (1029, 1029)
    assert _rel(got.toarray(), want.toarray()) <= RTOL
    fixed = ~problem.fp.dbc.free_mask
    np.testing.assert_array_equal(got[fixed].toarray(),
                                  np.eye(1029)[fixed])


def test_initial_state_matches_reference(problem):
    """From a nonzero displacement, so that f_int and a0 are nonzero."""
    d = _rand(problem.fp.disc, 1e-3, 13)
    sp_ = ps.compute_initial_state(problem.fp, dict(ps.init_state(problem.fp),
                                                    d=torch.as_tensor(d)))
    sj = jps.compute_initial_state(problem.fj, dict(jps.init_state(problem.fj),
                                                    d=jnp.asarray(d)))
    for k in ("d", "fint", "fext"):
        assert _rel(sp_[k].numpy(), sj[k]) <= RTOL
    assert np.abs(np.asarray(sj["a"])).max() > 1.0
    assert _rel(sp_["a"].numpy(), sj["a"]) <= 1e-10


# -- preconditioner choice and the step -------------------------------------


@pytest.mark.parametrize("precond", ["gmg", "amg"])
def test_make_step_builds_sa_amg(problem, precond):
    """``gmg`` finds no lattice, warns and falls back to SA-AMG, as the
    reference does; ``amg`` builds the same hierarchy without a warning."""
    fp = problem.fp
    fp.params.precond = precond
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step = ps.make_step(fp, dt=DT)
    finally:
        fp.params.precond = "gmg"
    assert step.precond is fp._build_amg(problem.shift)
    assert [("SA-AMG" in str(w.message)) for w in caught] == \
        ([True] if precond == "gmg" else [])
    M = fp._build_amg(problem.shift)
    assert len(fp._amg_cache) == 1 and len(M.levels) == 2
    assert M.dtype == torch.float64 and M.device.type == "cpu"


def test_amg_refused_on_a_lattice():
    disc = gridgen.box(2, 2, 2)
    mat = make_material({"type": "neohooke", "youngs": E_MOD, "nue": NUE,
                         "density": RHO})
    params = ps.SolidParams(dyntype="genalpha", precond="amg")
    f = ps.SolidField(disc, {1: mat}, params, device="cpu")
    with pytest.raises(NotImplementedError, match="general topology"):
        ps.make_step(f, dt=DT)


def test_general_field_defaults_to_cuda(meshes, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _field(PORT, meshes["3x2x2"][0])


def test_step_matches_reference(problem):
    fj, fp = problem.fj, problem.fp
    sj = jps.compute_initial_state(fj, jps.init_state(fj))
    sp_ = ps.compute_initial_state(fp, ps.init_state(fp))
    with pytest.warns(UserWarning, match="SA-AMG"):
        step_j = jps.make_step(fj, dt=DT)
    with pytest.warns(UserWarning, match="SA-AMG"):
        step_p = ps.make_step(fp, dt=DT)
    for _ in range(2):
        sj, stj = step_j(sj)
        sp_, stp = step_p(sp_)
        assert stp["converged"] and bool(stj["converged"])
        assert abs(stp["iters"] - int(stj["iters"])) <= 1
        assert np.isfinite(stp["resnorm"])
    ref = convert.state_from_jax(sj, None)
    assert sp_["t"] == pytest.approx(ref["t"]) and sp_["step"] == ref["step"]
    assert sp_["d"].shape == (fp.ndof,)
    assert np.abs(ref["d"]).max() > 1e-4  # the load moved the box
    for k in ("d", "v", "a"):
        assert _rel(sp_[k].numpy(), ref[k]) <= 1e-7
