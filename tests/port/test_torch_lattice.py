"""Lattice layer: layout, stencil collapse and the three kernel twins against
fourc_tpu.ops.lattice, on the anisotropic 4x3x5 box of tests/test_lattice.py
(mixed-up axes show).

The JAX side runs its plain XLA references (stencil_matvec_ref,
neo_force_ref, neo_jvp_ref) in float64, as its own CPU tests do.  The
twins compute the same math in another summation order, so they are held
to max|got - want| <= 1e-12 * max|want|.  On the CPU the kernel wrappers of
ops/lattice_kernels.py route to the twins; the CUDA kernels themselves are
held to the twins on the card (tests/port/test_torch_gpu.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourc_tpu.core import gridgen as jgrid
from fourc_tpu.core.cells import get_cell as jget_cell
from fourc_tpu.materials import make_material as jmake
from fourc_tpu.ops import lattice as jlat
from fourc_tpu.ops import solid as jsolid
from fourc_tpu_torch import convert
from fourc_tpu_torch.core import gridgen
from fourc_tpu_torch.core.cells import get_cell
from fourc_tpu_torch.core.mesh import HEX8_OFFSETS
from fourc_tpu_torch.materials.elastic import lame
from fourc_tpu_torch.ops import common as gm
from fourc_tpu_torch.ops import cuda_build
from fourc_tpu_torch.ops import lattice as lat
from fourc_tpu_torch.ops import lattice_kernels as lk

RTOL = 1e-12
SHAPE, HI = (4, 3, 5), (1.2, 0.7, 2.0)
E_MOD, NUE = 500.0, 0.3


@pytest.fixture(scope="module")
def box():
    disc = gridgen.box(*SHAPE, hi=HI)
    spec = lat.detect_lattice(disc)
    jdisc = jgrid.box(*SHAPE, hi=HI)
    jspec = jlat.detect_lattice(jdisc)
    assert spec is not None and jspec is not None
    return disc, spec, jdisc, jspec


def _rand(spec, scale, seed):
    return np.random.default_rng(seed).normal(size=spec.ndof) * scale


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _ghost_is_zero(x):
    shell = x.clone()
    shell[:, 1:-1, 1:-1, 1:-1] = 0.0
    return not bool(shell.any())


def _lat_t(v, spec):
    return lat.to_lattice(torch.as_tensor(v), spec)


def test_detect_lattice_matches_reference(box):
    disc, spec, _, jspec = box
    assert spec.pshape == jspec.pshape
    np.testing.assert_allclose(spec.h, jspec.h, rtol=1e-15)
    disc.coords[3] += 0.01
    try:
        assert lat.detect_lattice(disc) is None
    finally:
        disc.coords[3] -= 0.01


@pytest.mark.parametrize("seed", [0, 1])
def test_layout_roundtrip_and_ghost_shell(box, seed):
    _, spec, _, jspec = box
    v = _rand(spec, 1.0, seed)
    x = _lat_t(v, spec)
    assert tuple(x.shape) == spec.lshape
    np.testing.assert_array_equal(lat.from_lattice(x, spec).numpy(), v)
    assert _ghost_is_zero(x)
    # same layout as the reference's padded lattice
    np.testing.assert_array_equal(
        x.numpy(), np.asarray(jlat.to_lattice(jnp.asarray(v), jspec)))
    np.testing.assert_array_equal(convert.lattice_from_jax(v, spec.pshape),
                                  x.numpy())
    np.testing.assert_array_equal(convert.flat_from_lattice(x.numpy()), v)


def test_uniform_geometry_matches_reference(box):
    _, spec, _, jspec = box
    G, wdet = lat.uniform_geometry(get_cell("hex8"), spec)
    jG, jw = jlat.uniform_geometry(jget_cell("hex8"), jspec)
    _close(G, jG, rtol=1e-15)
    _close(wdet, jw, rtol=1e-15)


def _sym_stencil(seed):
    B = np.random.default_rng(seed).normal(size=(24, 24))
    return lat.collapse_stencil(B + B.T)


@pytest.mark.parametrize("seed", [7, 8])
def test_stencil_twin_matches_reference(box, seed):
    _, spec, _, jspec = box
    K = _sym_stencil(seed)
    v = _rand(spec, 1.0, seed + 100)
    got = lat.stencil_matvec_ref(K, _lat_t(v, spec))
    want = jlat.stencil_matvec_ref(K, jlat.to_lattice(jnp.asarray(v), jspec),
                                   jspec)
    _close(got, want)
    assert _ghost_is_zero(got)


def test_assembled_27_point_stencil_matches_twin():
    """The interior form of the B3 kernel: S[d] = sum over the hex8 node
    pairs (a, b) with o(b) - o(a) = d of K[a, :, b, :]; on a node with all 8
    elements, y_p = sum_d S[d] v[p + d] is the twin's A v."""
    K = _sym_stencil(11)
    off = np.asarray(HEX8_OFFSETS)
    S = np.zeros((3, 3, 3, 3, 3))  # [dx+1, dy+1, dz+1, i, j]
    for a in range(8):
        for b in range(8):
            S[tuple(off[b] - off[a] + 1)] += K[a, :, b, :]
    nx, ny, nz = 5, 4, 6
    spec = lat.LatticeSpec(pshape=(nx + 1, ny + 1, nz + 1), h=(1.0,) * 3)
    v = _lat_t(_rand(spec, 1.0, 12), spec)
    want = lat.stencil_matvec_ref(torch.as_tensor(K), v).numpy()
    vn = v.numpy()
    got = np.zeros((3, nx - 1, ny - 1, nz - 1))
    for dx, dy, dz in np.ndindex(3, 3, 3):  # interior padded nodes 2..n
        got += np.einsum("ij,j...->i...", S[dx, dy, dz],
                         vn[:, 1 + dx:nx + dx, 1 + dy:ny + dy, 1 + dz:nz + dz])
    _close(got, want[:, 2:nx + 1, 2:ny + 1, 2:nz + 1], rtol=1e-13)


def _geom(spec):
    G, wdet = lat.uniform_geometry(get_cell("hex8"), spec)
    return G, wdet


@pytest.mark.parametrize("model", ["neohooke", "svk"])
@pytest.mark.parametrize("seed", [1, 2])
def test_force_twin_matches_reference(box, model, seed):
    _, spec, _, jspec = box
    G, wdet = _geom(spec)
    lam, mu = lame(E_MOD, NUE)
    u = _rand(spec, 5e-2, seed)
    got = lat.neo_force_ref(_lat_t(u, spec), G, wdet, lam, mu, model)
    jG, jw = jlat.uniform_geometry(jget_cell("hex8"), jspec)
    want = jlat.neo_force_ref(jlat.to_lattice(jnp.asarray(u), jspec), jspec,
                              jG, jw, lam, mu, model)
    _close(got, want)


@pytest.mark.parametrize("model", ["neohooke", "svk"])
def test_jvp_twin_matches_reference(box, model):
    _, spec, _, jspec = box
    G, wdet = _geom(spec)
    lam, mu = lame(E_MOD, NUE)
    u, v = _rand(spec, 5e-2, 1), _rand(spec, 1e-2, 2)
    got = lat.neo_jvp_ref(_lat_t(u, spec), _lat_t(v, spec), G, wdet, lam, mu,
                          model)
    jG, jw = jlat.uniform_geometry(jget_cell("hex8"), jspec)
    want = jlat.neo_jvp_ref(jlat.to_lattice(jnp.asarray(u), jspec),
                            jlat.to_lattice(jnp.asarray(v), jspec), jspec,
                            jG, jw, lam, mu, model)
    _close(got, want)


def _jax_mass_stencil(jdisc, rho):
    """Collapsed consistent-mass stencil, built as tests/test_lattice.py
    builds it."""
    cell = jget_cell("hex8")
    Xe1 = jnp.asarray(jdisc.coords[jdisc.blocks["hex8"].conn[:1]])
    cols = []
    for k in range(24):
        ve = jnp.zeros((1, 24)).at[:, k].set(1.0).reshape(1, 8, 3)
        cols.append(np.asarray(
            jsolid.consistent_mass_matvec(Xe1, ve, cell, rho)).reshape(24))
    return jlat.collapse_stencil(np.stack(cols, axis=1))


def test_fused_tangent_matches_reference(box):
    """K(u) v + c M v in one pass == jax.jvp of the reference force plus c
    times the collapsed consistent-mass stencil (tests/test_lattice.py
    test_pallas_fused_tangent_mass_interpret builds the same oracle)."""
    _, spec, jdisc, jspec = box
    rho, mass_coef = 2.0, 137.5
    jmat = jmake({"type": "neohooke", "youngs": E_MOD, "nue": NUE,
                  "density": rho})
    u, v = _rand(spec, 5e-2, 3), _rand(spec, 1e-2, 4)
    G, wdet = _geom(spec)
    lam, mu = lame(E_MOD, NUE)
    cell = get_cell("hex8")
    got = lk.neo_tangent(_lat_t(u, spec), _lat_t(v, spec),
                         torch.as_tensor(G), torch.as_tensor(wdet),
                         torch.as_tensor(cell.N), lam, mu, "neohooke",
                         mcoef=rho * mass_coef)
    ref_force = jlat.make_force_flat(jspec, jget_cell("hex8"), jmat)
    _, want_jv = jax.jvp(ref_force, (jnp.asarray(u),), (jnp.asarray(v),))
    Mv = jlat.stencil_matvec_flat(_jax_mass_stencil(jdisc, rho),
                                  jnp.asarray(v), jspec)
    want = np.asarray(want_jv) + mass_coef * np.asarray(Mv)
    _close(lat.from_lattice(got, spec), want)


def test_mass_stencil_matches_reference(box):
    """The field's consistent-mass stencil equals the reference's."""
    from fourc_tpu_torch.materials import make_material
    from fourc_tpu_torch.physics import solid as ps

    disc, _, jdisc, _ = box
    rho = 2.7
    mat = make_material({"type": "neohooke", "youngs": E_MOD, "nue": NUE,
                         "density": rho})
    f = ps.SolidField(disc, {1: mat}, ps.SolidParams(), device="cpu")
    _close(f.mass_stencil.numpy(), _jax_mass_stencil(jdisc, rho))


def test_cpu_wrappers_use_twins_and_count_nothing(box):
    _, spec, _, _ = box
    lk.reset_launches()
    v = _lat_t(_rand(spec, 1.0, 5), spec)
    K = torch.as_tensor(_sym_stencil(9))
    np.testing.assert_array_equal(lk.stencil_matvec(K, v).numpy(),
                                  lat.stencil_matvec_ref(K, v).numpy())
    G, wdet = (torch.as_tensor(x) for x in _geom(spec))
    f = lk.neo_force(v * 1e-2, G, wdet, 1.0, 1.0)
    np.testing.assert_array_equal(
        f.numpy(), lat.neo_force_ref(v * 1e-2, G, wdet, 1.0, 1.0).numpy())
    assert lk.launches == {"stencil": 0, "force": 0, "tangent": 0,
                           "force_gen": 0, "tangent_gen": 0}


def test_kernel_sources_present_and_build_needs_nvcc(monkeypatch):
    for name in (*cuda_build.SOURCES, cuda_build.HEADER):
        assert (cuda_build.CSRC / name).is_file()
    assert lk.SOURCE in cuda_build.SOURCES
    assert cuda_build.library_path(lk.SOURCE).name.startswith(
        "liblattice_kernels_")
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.find_nvcc()


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_kernel_input_checks(bad):
    x = torch.zeros(3, 5, 6, 7)
    if bad == "shape":
        with pytest.raises(ValueError):
            lk._dims(torch.zeros(2, 5, 6, 7))
    else:
        with pytest.raises(ValueError):
            lk._dims(x.to(torch.float16))
    assert lk._dims(x) == (2, 3, 4)


# The algebra of the B2 element pass (csrc/lattice_common.cuh: edge_node,
# load_edge_tables, grad_edges, accum_edges, edges_to_nodes, mass_table,
# tangent_neohooke_F), mirrored in float64 against the twin's own
# functions.  Edge e of axis j runs from node _EDGES[j][e][0] to
# _EDGES[j][e][1].
_EDGES = (((0, 1), (3, 2), (4, 5), (7, 6)), ((0, 3), (1, 2), (4, 7), (5, 6)),
          ((0, 4), (1, 5), (2, 6), (3, 7)))


def _edge_table(G):
    """Ge[g, j, e] = (G[g, a+, j] - G[g, a-, j]) / 2."""
    return torch.stack([torch.stack([0.5 * (G[:, ap, j] - G[:, am, j])
                                     for am, ap in _EDGES[j]], dim=-1)
                        for j in range(3)], dim=1)


def _edge_diff(xe):
    """(8, 3, ...) corner values -> (3, 4, 3, ...) edge differences."""
    return torch.stack([torch.stack([xe[ap] - xe[am] for am, ap in _EDGES[j]])
                        for j in range(3)])


def _edges_to_nodes(R):
    fe = torch.zeros((8,) + R.shape[2:], dtype=R.dtype)
    for j in range(3):
        for e, (am, ap) in enumerate(_EDGES[j]):
            fe[ap] += R[j, e]
            fe[am] -= R[j, e]
    return fe


def _tangent_neohooke_F(H, Hd, lam, mu):
    """Pd = mu Hd + r^2 (lam (K : Hd) K - (lam lnJ - mu) K Hd^T K), K =
    cof(I + H), r = 1 / det(I + H)."""
    trH = gm.tr3l(H)
    delta = (trH + 0.5 * (trH * trH - torch.einsum("ij...,ji...->...", H, H))
             + gm.det3l(H))
    lnJ = 0.5 * torch.log1p(delta * (2.0 + delta))
    K = gm.cof3l(H + gm.eye3l(H))
    r2 = 1.0 / (1.0 + delta) ** 2
    KHd = torch.einsum("ij...,ij...->...", K, Hd)
    M = torch.einsum("ik...,jk...,jl...->il...", K, Hd, K)
    return mu * Hd + lam * KHd * r2 * K - (lam * lnJ - mu) * r2 * M


def test_edge_gradient_and_accumulation_match_dense(box):
    """H = sum_a x_a G_a^T and fe_a = P G_a regrouped by the 12 edges."""
    _, spec, _, _ = box
    G = torch.as_tensor(_geom(spec)[0])
    Ge = _edge_table(G)
    dN = torch.as_tensor(get_cell("hex8").dN)
    for j in range(3):  # dN[a-] = -dN[a+] along every edge, to roundoff
        for am, ap in _EDGES[j]:
            assert (dN[:, am, j] + dN[:, ap, j]).abs().max() <= 5e-14
    rng = np.random.default_rng(21)
    xe = torch.as_tensor(rng.normal(size=(8, 3, 6)))
    P = torch.as_tensor(rng.normal(size=(3, 3, 6)))
    dx = _edge_diff(xe)
    for g in range(8):
        _close(torch.einsum("jei...,je->ij...", dx, Ge[g]),
               torch.einsum("ai...,aj->ij...", xe, G[g]), rtol=1e-13)
        _close(_edges_to_nodes(torch.einsum("ij...,je->jei...", P, Ge[g])),
               torch.einsum("ij...,aj->ai...", P, G[g]), rtol=1e-13)


def test_neohooke_tangent_deformation_gradient_form():
    """The deformation-gradient form equals the material form of the twin,
    on |H| <= 0.3 and on one H with det(I + H) < 0."""
    lam, mu = lame(E_MOD, NUE)
    rng = np.random.default_rng(22)
    H = rng.uniform(-0.3, 0.3, size=(3, 3, 16))
    H[:, :, -1] = np.diag([-1.6, 0.1, -0.2]) + 0.05 * H[:, :, -1]
    assert np.linalg.det(np.eye(3) + H[:, :, -1]) < 0
    H, Hd = torch.as_tensor(H), torch.as_tensor(rng.normal(size=(3, 3, 16)))
    _close(_tangent_neohooke_F(H, Hd, lam, mu),
           lat._tangent_stress(H, Hd, lam, mu, "neohooke"))


def test_element_mass_table_matches_mass_gp(box):
    """Me = sum_g wdet_g N_g N_g^T applied to v == sum_g _mass_gp."""
    _, spec, _, _ = box
    wdet = torch.as_tensor(_geom(spec)[1])
    N = torch.as_tensor(get_cell("hex8").N)
    ve = torch.as_tensor(np.random.default_rng(23).normal(size=(8, 3, 6)))
    Me = torch.einsum("g,ga,gb->ab", wdet, N, N)
    want = sum(lat._mass_gp(ve, N[g], 137.5 * wdet[g]) for g in range(8))
    _close(torch.einsum("ab,bk...->ak...", 137.5 * Me, ve), want, rtol=1e-13)


@pytest.mark.parametrize("model, mcoef", [("neohooke", 0.0),
                                          ("neohooke", 137.5), ("svk", 137.5)])
def test_edge_element_pass_matches_twin(box, model, mcoef):
    """The whole B2 element pass by edges on the 4x3x5 box == neo_jvp_ref."""
    _, spec, _, _ = box
    G, wdet = (torch.as_tensor(x) for x in _geom(spec))
    N = torch.as_tensor(get_cell("hex8").N)
    lam, mu = lame(E_MOD, NUE)
    u, v = _lat_t(_rand(spec, 5e-2, 24), spec), _lat_t(_rand(spec, 1.0, 25),
                                                        spec)
    Ge = _edge_table(G)
    du = _edge_diff(torch.stack(lat._corners(u)))
    ve = torch.stack(lat._corners(v))
    dv = _edge_diff(ve)
    R = torch.zeros_like(du)
    for g in range(8):
        H = torch.einsum("jei...,je->ij...", du, Ge[g])
        Hd = torch.einsum("jei...,je->ij...", dv, Ge[g])
        Pd = (_tangent_neohooke_F(H, Hd, lam, mu) if model == "neohooke"
              else lat._tangent_stress(H, Hd, lam, mu, model))
        R += torch.einsum("ij...,je->jei...", wdet[g] * Pd, Ge[g])
    Me = mcoef * torch.einsum("g,ga,gb->ab", wdet, N, N)
    fe = torch.einsum("ab,bk...->ak...", Me, ve) + _edges_to_nodes(R)
    want = lat.neo_jvp_ref(u, v, G, wdet, lam, mu, model, N=N, mcoef=mcoef)
    _close(lat._assemble(fe, u), want)


@pytest.mark.parametrize("scale", [4e-2, 1e-1])
def test_gpu_tangent_inputs_conditioning(scale):
    """The large-deformation inputs of test_torch_gpu.py's tangent test on
    its (9, 7, 12) box (same spacing, seed and draw order): at u = 4e-2,
    det F >= 0.2 and the float32 twin is within 1e-5 of the float64 one,
    so 1e-4 can hold a kernel; at 1e-1 elements invert, |det F| comes near
    0 and the float32 twin is off the float64 answer by more than 1e-4
    itself."""
    shape = (9, 7, 12)
    spec = lat.LatticeSpec(pshape=tuple(s + 1 for s in shape),
                           h=(0.3, 0.2, 0.4))
    rng = np.random.default_rng(4)
    u, v = (rng.normal(size=spec.ndof) * s for s in (scale, 1.0))
    G, wdet = _geom(spec)
    N = get_cell("hex8").N
    lam, mu = lame(500.0, 0.3)
    want = {}
    for dtype in (torch.float64, torch.float32):
        ul, vl = (lat.to_lattice(torch.as_tensor(x, dtype=dtype), spec)
                  for x in (u, v))
        want[dtype] = lat.neo_jvp_ref(ul, vl, G, wdet, lam, mu, "neohooke",
                                      N=N, mcoef=137.5).double()
    ue = torch.stack(lat._corners(_lat_t(u, spec)))
    detF = torch.stack([gm.det3l(H + gm.eye3l(H)) for H in (
        torch.einsum("ai...,aj->ij...", ue, torch.as_tensor(G[g]))
        for g in range(8))])
    ref = want[torch.float64]
    rel32 = float((want[torch.float32] - ref).abs().max() / ref.abs().max())
    if scale == 4e-2:
        assert float(detF.min()) >= 0.2 and rel32 <= 1e-5
    else:
        assert float(detF.min()) < 0 and float(detF.abs().min()) < 1e-2
        assert rel32 > 1e-4


# The algebra of the B5 element pass by edges (csrc/lattice_common.cuh:
# edge_table_entry on dN, tangent_gen_Pd, tangent_gen_gp,
# tangent_gen_edge_element, mass_gen, node_edge, and the reduction of
# tangent_gen_gp_kernel in lattice_kernels.cu), mirrored in float64 against
# the twin's own functions.
_HEX8_CUBE = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                       [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], float)
_GEN_CASES = {"linear": (None, "svk", 0.0),
              "neohooke": (3e-2, "neohooke", 0.0),
              "neohooke+mass": (3e-2, "neohooke", 137.5),
              "svk+mass": (3e-2, "svk", 137.5)}


def _jittered_elements(E, seed):
    """Corner coordinates (8, 3, E) of jittered boxes of edges 0.2-0.5."""
    rng = np.random.default_rng(seed)
    Xe = (_HEX8_CUBE[None] * rng.uniform(0.2, 0.5, size=(E, 1, 3))
          + rng.uniform(-0.04, 0.04, size=(E, 8, 3)))
    return torch.as_tensor(Xe.transpose(1, 2, 0).copy())


def _node_edge(a, j):
    """lattice_common.cuh node_edge: the edge of axis j through node a."""
    lo = a & 3
    if j == 2:
        return lo
    return 2 * (a >> 2) + ((lo if lo < 2 else 3 - lo) if j == 1 else
                           int(lo >= 2))


def _gen_gp(J, du, dv, Ge_g, w_g, lam, mu, model):
    """tangent_gen_gp: Q = (w / det J) Pd(H, Hhat(v) K^T) K, K = cof(J),
    H = Hhat(u) K^T / det J; returns (Q, det J)."""
    K = gm.cof3l(J)
    det = torch.einsum("j...,j...->...", J[0], K[0])
    Hd = torch.einsum("ik...,jk...->ij...",
                      torch.einsum("jei...,je->ij...", dv, Ge_g), K)
    if model is None:
        Pd = (lam * gm.tr3l(Hd) * gm.eye3l(Hd)
              + mu * (Hd + Hd.transpose(0, 1)))
    else:
        H = torch.einsum("ik...,jk...->ij...",
                         torch.einsum("jei...,je->ij...", du, Ge_g), K) / det
        Pd = (_tangent_neohooke_F(H, Hd, lam, mu) if model == "neohooke"
              else lat._tangent_stress(H, Hd, lam, mu, model))
    return (w_g / det) * gm.matmul3l(Pd, K), det


def test_node_edge_inverts_edge_node():
    for j in range(3):
        for a in range(8):
            side = int(HEX8_OFFSETS[a][j])
            assert _EDGES[j][_node_edge(a, j)][side] == a


def test_gen_edge_jacobian_gradients_and_accumulation_match_dense():
    """J, Hhat and sum_a Q dN_a by the 12 edges of the dN table, on a set of
    jittered elements, against the dense forms of _geom_gp."""
    dN = torch.as_tensor(get_cell("hex8").dN)
    Ge = _edge_table(dN)
    xe = _jittered_elements(6, 31)
    ve = torch.as_tensor(np.random.default_rng(32).normal(size=(8, 3, 6)))
    Q = torch.as_tensor(np.random.default_rng(33).normal(size=(3, 3, 6)))
    dx, dv = _edge_diff(xe), _edge_diff(ve)
    for g in range(8):
        _close(torch.einsum("jei...,je->ij...", dx, Ge[g]),
               torch.einsum("ai...,aj->ij...", xe, dN[g]), rtol=1e-13)
        _close(torch.einsum("jei...,je->ij...", dv, Ge[g]),
               torch.einsum("ai...,aj->ij...", ve, dN[g]), rtol=1e-13)
        _close(_edges_to_nodes(torch.einsum("ij...,je->jei...", Q, Ge[g])),
               torch.einsum("ij...,aj->ai...", Q, dN[g]), rtol=1e-13)


@pytest.mark.parametrize("model", [None, "neohooke", "svk"])
def test_gen_weighted_cofactor_form_matches_inverse(model):
    """(w / det J) Pd(H, det J Hd) cof(J) == wdet Pd(H, Hd) Jinv^T, with H
    and Hd the cartesian gradients H = Hhat Jinv (the twin's geometry), to
    1e-12: J by edges averages dN halves that differ by up to 3.7e-14."""
    cell = get_cell("hex8")
    dN, w = torch.as_tensor(cell.dN), torch.as_tensor(cell.gauss_weights)
    lam, mu = lame(E_MOD, NUE)
    xe = _jittered_elements(6, 34)
    rng = np.random.default_rng(35)
    ue, ve = (torch.as_tensor(rng.normal(size=(8, 3, 6)) * s)
              for s in (5e-2, 1.0))
    Ge = _edge_table(dN)
    dx, du, dv = _edge_diff(xe), _edge_diff(ue), _edge_diff(ve)
    for g in range(8):
        G, wdet = lat._geom_gp(xe, dN[g], w[g])
        H = None if model is None else torch.einsum("ai...,aj...->ij...",
                                                    ue, G)
        Hd = torch.einsum("ai...,aj...->ij...", ve, G)
        Pd = lat._tangent_stress(H, Hd, lam, mu, model or "svk")
        J = torch.einsum("ai...,aj->ij...", xe, dN[g])
        Jinv = gm.inv3l(J, gm.det3l(J))
        Q, det = _gen_gp(torch.einsum("jei...,je->ij...", dx, Ge[g]), du, dv,
                         Ge[g], w[g], lam, mu, model)
        _close(det * w[g], wdet)
        _close(Q, wdet * torch.einsum("ik...,jk...->ij...", Pd, Jinv))


def test_gen_mass_after_the_loop_matches_mass_gp():
    """mass_gen with the shift register c (c[7 - g] = det J_g) ==
    sum_g _mass_gp(ve, N_g, mcoef wdet_g)."""
    cell = get_cell("hex8")
    dN, w, N = (torch.as_tensor(t) for t in (cell.dN, cell.gauss_weights,
                                             cell.N))
    xe = _jittered_elements(6, 36)
    ve = torch.as_tensor(np.random.default_rng(37).normal(size=(8, 3, 6)))
    c = [torch.zeros(6)] * 8
    for g in range(8):
        c = [gm.det3l(torch.einsum("ai...,aj->ij...", xe, dN[g]))] + c[:7]
    got = sum(lat._mass_gp(ve, N[g], 137.5 * w[g] * c[7 - g])
              for g in range(8))
    want = sum(lat._mass_gp(ve, N[g], 137.5 * lat._geom_gp(xe, dN[g], w[g])[1])
               for g in range(8))
    _close(got, want, rtol=1e-13)


def test_gauss_point_mapping_reduction_matches_dense():
    """tangent_gen_gp_kernel's reduction: lane a sums
    fe[a][i] = sum_g sum_j Q_g[i][j] (2 o_j(a) - 1) Ge[g][j][node_edge(a, j)]
    over the Gauss points in order == sum_g Q_g dN_g^T."""
    dN = torch.as_tensor(get_cell("hex8").dN)
    Ge = _edge_table(dN)
    Q = torch.as_tensor(np.random.default_rng(38).normal(size=(8, 3, 3, 6)))
    fe = torch.zeros((8, 3, 6), dtype=Q.dtype)
    for a in range(8):
        for g in range(8):
            for j in range(3):
                sign = 2.0 * HEX8_OFFSETS[a][j] - 1.0
                fe[a] += Q[g, :, j] * sign * Ge[g, j, _node_edge(a, j)]
    _close(fe, torch.einsum("gij...,gaj->ai...", Q, dN), rtol=1e-13)


@pytest.mark.parametrize("case", list(_GEN_CASES))
def test_gen_edge_element_pass_matches_twin(case):
    """The whole B5 element pass by edges on a jittered 4x3x5 box, assembled,
    == neo_jvp_gen_ref."""
    scale, model, mcoef = _GEN_CASES[case]
    spec = lat.LatticeSpec(pshape=tuple(s + 1 for s in SHAPE), h=None)
    rng = np.random.default_rng(39)
    idx = np.stack(np.meshgrid(*[np.arange(p) for p in spec.pshape],
                               indexing="ij"), axis=-1)
    h = np.asarray(HI) / np.asarray(SHAPE)
    X = idx * h + (rng.random(idx.shape) - 0.5) * 0.3 * h
    x = _lat_t(X.reshape(-1), spec)
    u = None if scale is None else _lat_t(_rand(spec, scale, 40), spec)
    v = _lat_t(_rand(spec, 1.0, 41), spec)
    cell = get_cell("hex8")
    dN, w, N = (torch.as_tensor(t) for t in (cell.dN, cell.gauss_weights,
                                             cell.N))
    lam, mu = lame(E_MOD, NUE)
    Ge = _edge_table(dN)
    ve = torch.stack(lat._corners(v))
    dx, dv = _edge_diff(torch.stack(lat._corners(x))), _edge_diff(ve)
    du = None if u is None else _edge_diff(torch.stack(lat._corners(u)))
    R, c = torch.zeros_like(dv), [None] * 8
    for g in range(8):
        Q, det = _gen_gp(torch.einsum("jei...,je->ij...", dx, Ge[g]), du, dv,
                         Ge[g], w[g], lam, mu, None if u is None else model)
        R += torch.einsum("ij...,je->jei...", Q, Ge[g])
        c = [det] + c[:7]
    fe = _edges_to_nodes(R)
    if mcoef:
        fe += sum(lat._mass_gp(ve, N[g], mcoef * w[g] * c[7 - g])
                  for g in range(8))
    want = lat.neo_jvp_gen_ref(x, u, v, dN, w, N, lam, mu, model, mcoef)
    _close(lat._assemble(fe, v), want)


def test_gpu_tangent_gen_inputs_conditioning():
    """The large-deformation inputs of test_torch_gpu.py's general tangent
    test on its (9, 7, 12) box (same spacing, jitter, seeds and draw order):
    at u = 3e-2, det F >= 0.2 and the float32 twin is within 1e-5 of the
    float64 one, so 1e-4 can hold a kernel (at 4e-2 this box's smallest
    det F is 0.19)."""
    shape = (9, 7, 12)
    spec = lat.LatticeSpec(pshape=tuple(s + 1 for s in shape),
                           h=(0.3, 0.2, 0.4))
    idx = np.stack(np.meshgrid(*[np.arange(p) for p in spec.pshape],
                               indexing="ij"), axis=-1)
    h = np.asarray(spec.h)
    X = idx * h + (np.random.default_rng(9).random(idx.shape) - 0.5) * 0.3 * h
    rng = np.random.default_rng(8)
    u, v = (rng.normal(size=spec.ndof) * s for s in (3e-2, 1.0))
    cell = get_cell("hex8")
    lam, mu = lame(500.0, 0.3)
    want = {}
    for dtype in (torch.float64, torch.float32):
        x, ul, vl = (lat.to_lattice(torch.as_tensor(a, dtype=dtype), spec)
                     for a in (X.reshape(-1), u, v))
        tab = (torch.as_tensor(t, dtype=dtype) for t in (
            cell.dN, cell.gauss_weights, cell.N))
        want[dtype] = lat.neo_jvp_gen_ref(x, ul, vl, *tab, lam, mu,
                                          "neohooke", 137.5).double()
    xe = torch.stack(lat._corners(_lat_t(X.reshape(-1), spec)))
    ue = torch.stack(lat._corners(_lat_t(u, spec)))
    detF = torch.stack([gm.det3l(H + gm.eye3l(H)) for H in (
        torch.einsum("ai...,aj...->ij...", ue, lat._geom_gp(
            xe, torch.as_tensor(cell.dN[g]), 1.0)[0]) for g in range(8))])
    ref = want[torch.float64]
    rel32 = float((want[torch.float32] - ref).abs().max() / ref.abs().max())
    assert float(detF.min()) >= 0.2 and rel32 <= 1e-5
