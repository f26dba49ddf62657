"""The port's smoothed-aggregation AMG against fourc_tpu's, on the CPU.

Both packages build their hierarchy from the same host matrix: the
linear-elastic operator with mass shift of the flagship problem on a
permuted, jittered 6^3 box (1,029 dofs, over the ``coarsest`` limit of 400,
so the hierarchy has two levels and a dense coarse factor of the second),
assembled by the port's ``SolidField.assemble_linear_operator``, which
tests/port/test_torch_unstructured.py holds to the reference's assembly.

- aggregation: identical aggregate ids (the port does each row's tests with
  numpy where the reference loops in Python; the visiting order is the same);
- hierarchy: every level's neighbour tables identical; blocks, Jacobi
  diagonal, lambda_max and the dense coarse factor to 1e-6 relative (the
  reference stores them in float32, the port here in float64);
- the ELL matvec against the scipy CSR product, 1e-12;
- one V-cycle of the port on the reference's hierarchy, carried over by
  ``convert.amg_from_jax``, in float32 as the reference runs it: 1e-5;
- the V-cycle is linear and symmetric (<x, M y> = <M x, y>), to 1e-5 in
  float32 and 1e-10 in float64: what CG needs of a preconditioner;
- what the hierarchy must satisfy by itself: the aggregates partition the
  graph, level operators are symmetric, the coarse operator is P^T A P, the
  dense factor inverts it, CG converges sooner with the V-cycle;
- ``save_amg`` / ``load_amg`` round trip, and loading a file that the
  reference wrote.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from fourc_tpu.linalg import amg as jamg
from fourc_tpu_torch import convert
from fourc_tpu_torch.core import conditions, functions, gridgen
from fourc_tpu_torch.linalg import amg, solvers
from fourc_tpu_torch.materials import make_material
from fourc_tpu_torch.physics import solid as ps

N, SHIFT = 6, 9930.0


def _permuted_box(n):
    """bench.py's permuted mesh (jitter, then random node renumbering)."""
    disc = gridgen.box(n, n, n)
    X = np.array(disc.coords)
    interior = np.all((X > 1e-12) & (X < 1.0 - 1e-12), axis=1)
    X[interior] += (np.random.RandomState(0).rand(int(interior.sum()), 3)
                    - 0.5) * (0.35 / n)
    perm = np.random.RandomState(1).permutation(disc.n_nodes).astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(disc.n_nodes, dtype=np.int32)
    disc.coords = X[perm]
    disc.structured_shape = None
    disc.blocks["hex8"].conn = inv[disc.blocks["hex8"].conn]
    for nm in disc.node_sets:
        disc.node_sets[nm] = inv[disc.node_sets[nm]]
    return disc


@pytest.fixture(scope="module")
def hier():
    """The host matrix, the reference's hierarchy and the port's (float64
    and float32)."""
    disc = _permuted_box(N)
    mat = make_material({"type": "neohooke", "youngs": 1.0e4, "nue": 0.3,
                         "density": 1.0})
    dbc = [conditions.DirichletBC(disc.node_sets["zmin"], [1, 1, 1],
                                  [0, 0, 0])]
    f = ps.SolidField(disc, {1: mat}, ps.SolidParams(), dirichlet=dbc,
                      functions=functions.FunctionManager(), device="cpu")
    A0 = f.assemble_linear_operator(SHIFT)
    return types.SimpleNamespace(
        A0=A0, free=f.dbc.free_mask,
        Mj=jamg.SmoothedAggregationAMG(A0, 3, f.dbc.free_mask),
        M64=amg.SmoothedAggregationAMG(A0, 3, device="cpu",
                                       dtype=torch.float64),
        M32=amg.SmoothedAggregationAMG(A0, 3, device="cpu",
                                       dtype=torch.float32))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _node_graph(A, ndpn=3):
    """The node-level strength graph both packages aggregate."""
    Ab = abs(A).tocsr()
    nn = A.shape[0] // ndpn
    rows = np.repeat(np.arange(A.shape[0]) // ndpn, np.diff(Ab.indptr))
    return sp.coo_matrix((Ab.data, (rows, Ab.indices // ndpn)),
                         shape=(nn, nn)).tocsr()


def _random_graph(seed, n=150):
    """A sparse symmetric graph with ties, zeros and isolated nodes."""
    rng = np.random.default_rng(seed)
    B = sp.random(n, n, density=0.04, random_state=seed, format="csr")
    B.data = np.round(B.data * 4) / 4  # equal weights and explicit zeros
    G = (B + B.T + sp.diags(rng.uniform(1, 2, n))).tolil()
    G[5, :] = 0
    G[:, 5] = 0
    return G.tocsr()


@pytest.mark.parametrize("graph", ["fine", "random0", "random1"])
@pytest.mark.parametrize("theta", [0.08, 0.5])
def test_aggregates_identical_to_reference(hier, graph, theta):
    G = (_node_graph(hier.A0) if graph == "fine"
         else _random_graph(int(graph[-1])))
    got, n_got = amg._aggregate(G, theta)
    want, n_want = jamg._aggregate(G, theta)
    assert n_got == n_want and 1 < n_got < G.shape[0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("graph", ["fine", "random0", "random1"])
@pytest.mark.parametrize("theta", [0.08, 0.5])
def test_aggregates_partition_the_graph(hier, graph, theta):
    """Every node has one aggregate, the ids are 0..n-1 with none unused,
    and every node of an aggregate of several nodes is joined to another of
    them by an edge."""
    G = (_node_graph(hier.A0) if graph == "fine"
         else _random_graph(int(graph[-1])))
    agg, n_agg = amg._aggregate(G, theta)
    assert agg.shape == (G.shape[0],)
    np.testing.assert_array_equal(np.unique(agg), np.arange(n_agg))
    sizes = np.bincount(agg)
    for i in range(G.shape[0]):
        if sizes[agg[i]] == 1:
            continue
        nbrs = G.indices[G.indptr[i]:G.indptr[i + 1]]
        assert any(j != i and agg[j] == agg[i] for j in nbrs)


def test_hierarchy_shape_matches_reference(hier):
    info = hier.M64.describe()
    assert len(hier.M64.levels) == len(hier.Mj.levels) == 2
    assert info["levels"][0]["nodes"] == (N + 1) ** 3
    assert info["levels"][0]["A"] == 27  # a hex box's node stencil
    assert hier.M64.levels[1]["P"] is None and hier.Mj.levels[1]["P"] is None
    nc = info["levels"][1]["nodes"]
    assert info["coarse_dofs"] == 3 * nc == hier.Mj._coarse_inv.shape[0]
    assert info["coarse_bytes"] == (3 * nc) ** 2 * 8
    assert set(hier.M64.timings) == {"ell_tables", "aggregation", "galerkin",
                                     "coarse_inverse"}


def _port(hier, dtype):
    """The port's hierarchy in float64, or in float32 as the main path and
    the reference keep it."""
    return hier.M64 if dtype == "float64" else hier.M32


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("op", ["A0", "P0", "R0", "A1"])
@pytest.mark.parametrize("what", ["nbr", "blk"])
def test_ell_tables_match_reference(hier, op, what, dtype):
    lev = _port(hier, dtype).levels[int(op[1])]
    got, want = lev[op[0]], hier.Mj.levels[int(op[1])][op[0]]
    assert got.n_cols == want.n_cols and got.ndpn == want.ndpn == 3
    if what == "nbr":
        assert got.nbr.dtype == torch.int64
        np.testing.assert_array_equal(got.nbr.numpy(), np.asarray(want.nbr))
    else:
        assert str(got.blk.dtype) == f"torch.{dtype}"
        assert _rel(got.blk.numpy(), want.blk) <= 1e-6


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("what", ["dinv0", "dinv1", "lmax0", "lmax1",
                                  "coarse_inv"])
def test_level_scalars_match_reference(hier, what, dtype):
    M = _port(hier, dtype)
    if what == "coarse_inv":
        assert _rel(M._coarse_inv.numpy(), hier.Mj._coarse_inv) <= 1e-6
        return
    lev, jlev = M.levels[int(what[-1])], hier.Mj.levels[int(what[-1])]
    if what.startswith("dinv"):
        assert _rel(lev["dinv"].numpy(), jlev["dinv"]) <= 1e-6
    else:
        assert lev["lmax"] == pytest.approx(jlev["lmax"], rel=1e-12)


def test_ell_matvec_matches_csr_product(hier):
    rng = np.random.default_rng(3)
    x = rng.normal(size=hier.A0.shape[0])
    op = hier.M64.levels[0]["A"]
    assert _rel(op.mv(torch.as_tensor(x)).numpy(), hier.A0 @ x) <= 1e-12
    # a rectangular operator with ragged rows, padding slots and empty rows
    B = sp.random(12, 21, density=0.2, random_state=4, format="lil")
    B[3:6, :] = 0
    B = B.tocsr()
    y = rng.normal(size=21)
    ell = amg._BlockELL.from_csr(B, 3, (4, 7), "cpu", torch.float64)
    assert ell.nbr.shape == (4, ell.width) and ell.blk.shape[2:] == (3, 3)
    assert _rel(ell.mv(torch.as_tensor(y)).numpy(), B @ y) <= 1e-12


def test_transfers_are_transposes(hier):
    """R is stored as its own table: it must be P^T."""
    lev = hier.M64.levels[0]
    rng = np.random.default_rng(5)
    xc = torch.as_tensor(rng.normal(size=3 * lev["P"].n_cols))
    xf = torch.as_tensor(rng.normal(size=3 * lev["R"].n_cols))
    lhs = float(torch.dot(lev["P"].mv(xc), xf))
    rhs = float(torch.dot(xc, lev["R"].mv(xf)))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


@pytest.mark.parametrize("level", [0, 1])
def test_level_operators_are_symmetric(hier, level):
    A = hier.M64.levels[level]["A"]
    rng = np.random.default_rng(11 + level)
    x, y = (torch.as_tensor(rng.normal(size=3 * A.n_cols)) for _ in range(2))
    lhs, rhs = float(torch.dot(x, A.mv(y))), float(torch.dot(A.mv(x), y))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_coarse_operator_is_the_galerkin_product(hier):
    """A_1 = P^T A_0 P, applied to a random coarse vector."""
    l0, l1 = hier.M64.levels
    xc = torch.as_tensor(np.random.default_rng(13).normal(
        size=3 * l1["A"].n_cols))
    want = l0["R"].mv(l0["A"].mv(l0["P"].mv(xc)))
    got = l1["A"].mv(xc)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-12


def test_coarse_factor_inverts_the_coarse_operator(hier):
    A1 = hier.M64.levels[1]["A"]
    r = torch.as_tensor(np.random.default_rng(14).normal(size=3 * A1.n_cols))
    back = A1.mv(hier.M64._coarse_inv @ r)
    assert float((back - r).abs().max() / r.abs().max()) <= 1e-9


def test_cg_needs_fewer_iterations_with_the_v_cycle(hier):
    """The point of the hierarchy: CG on the assembled operator converges
    several times sooner with the V-cycle than with Jacobi."""
    A = hier.M64.levels[0]["A"]
    b = torch.as_tensor(np.where(
        hier.free, np.random.default_rng(15).normal(size=hier.A0.shape[0]),
        0.0))
    dinv = hier.M64.levels[0]["dinv"]
    plain = solvers.cg(A.mv, b, M=lambda r: dinv * r, tol=1e-8)
    multi = solvers.cg(A.mv, b, M=hier.M64, tol=1e-8)
    assert plain.converged and multi.converged
    assert 3 * multi.iters <= plain.iters
    assert _rel(multi.x.numpy(), plain.x.numpy()) <= 1e-6


def test_v_cycle_matches_reference_on_its_hierarchy(hier):
    """The port's V-cycle on the reference's tables, float32 as there."""
    M = amg.amg_from_data(convert.amg_from_jax(hier.Mj), device="cpu",
                          dtype=torch.float32)
    r = np.random.default_rng(6).normal(size=hier.A0.shape[0])
    r = np.where(hier.free, r, 0.0)
    got = M(torch.as_tensor(r))
    assert got.dtype == torch.float64  # the caller's dtype comes back
    want = hier.Mj(jnp.asarray(r))
    assert _rel(got.numpy(), want) <= 1e-5


def test_own_v_cycle_matches_reference(hier):
    """The port's own hierarchy in float32 against the reference's."""
    r = np.random.default_rng(7).normal(size=hier.A0.shape[0])
    r = np.where(hier.free, r, 0.0)
    want = hier.Mj(jnp.asarray(r))
    assert _rel(hier.M32(torch.as_tensor(r)).numpy(), want) <= 1e-5
    assert _rel(hier.M64(torch.as_tensor(r)).numpy(), want) <= 1e-5


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-10)])
@pytest.mark.parametrize("prop", ["linear", "symmetric"])
def test_v_cycle_is_linear_and_symmetric(hier, dtype, tol, prop):
    M = hier.M32 if dtype == torch.float32 else hier.M64
    rng = np.random.default_rng(8)
    x, y = (torch.as_tensor(rng.normal(size=hier.A0.shape[0]), dtype=dtype)
            for _ in range(2))
    if prop == "linear":
        lhs, rhs = M(2.0 * x - 3.0 * y), 2.0 * M(x) - 3.0 * M(y)
        assert float((lhs - rhs).abs().max() / rhs.abs().max()) <= tol
    else:
        lhs, rhs = float(torch.dot(x, M(y))), float(torch.dot(M(x), y))
        scale = float(torch.linalg.vector_norm(x)
                      * torch.linalg.vector_norm(M(y)))
        assert abs(lhs - rhs) <= tol * scale


def test_v_cycle_reduces_the_error(hier):
    """One V-cycle as a stationary iteration contracts: ||I - M A|| < 1 on a
    random error, by a margin."""
    e = np.random.default_rng(9).normal(size=hier.A0.shape[0])
    r = torch.as_tensor(hier.A0 @ e)
    e1 = e - hier.M64(r).numpy()
    assert np.linalg.norm(e1) < 0.5 * np.linalg.norm(e)


def _same_hierarchy(got, want):
    assert len(got.levels) == len(want.levels)
    assert got.cheby_degree == want.cheby_degree and got.ndpn == want.ndpn
    np.testing.assert_array_equal(got._coarse_inv.numpy(),
                                  want._coarse_inv.numpy())
    for lg, lw in zip(got.levels, want.levels):
        assert lg["lmax"] == lw["lmax"]
        np.testing.assert_array_equal(lg["dinv"].numpy(), lw["dinv"].numpy())
        for nm in ("A", "P", "R"):
            assert (lg[nm] is None) == (lw[nm] is None)
            if lg[nm] is not None:
                assert lg[nm].n_cols == lw[nm].n_cols
                np.testing.assert_array_equal(lg[nm].nbr.numpy(),
                                              lw[nm].nbr.numpy())
                np.testing.assert_array_equal(lg[nm].blk.numpy(),
                                              lw[nm].blk.numpy())


def test_save_load_round_trip(hier, tmp_path):
    path = tmp_path / "amg.npz"
    amg.save_amg(hier.M64, path)
    M = amg.load_amg(path, device="cpu", dtype=torch.float64)
    _same_hierarchy(M, hier.M64)
    r = torch.as_tensor(np.random.default_rng(10).normal(
        size=hier.A0.shape[0]))
    np.testing.assert_array_equal(M(r).numpy(), hier.M64(r).numpy())


def test_loads_a_file_of_the_reference(hier, tmp_path):
    path = tmp_path / "ref.npz"
    jamg.save_amg(hier.Mj, path)
    _same_hierarchy(
        amg.load_amg(path, device="cpu"),
        amg.amg_from_data(convert.amg_from_jax(hier.Mj), device="cpu"))


def test_amg_defaults_to_cuda(hier, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        amg.SmoothedAggregationAMG(hier.A0, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        amg.amg_from_data(amg.amg_data(hier.M32))
