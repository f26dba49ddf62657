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
from fourc_tpu_torch.ops import solid as sops

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


# The algebra of the force passes by edges (csrc/lattice_common.cuh:
# stress_neohooke_F, first_piola, force_gen_edge_element; B1's
# force_elem_kernel and B4's force_gen_edge_kernel in lattice_kernels.cu)
# and of the element-batch kernels by edges (solid_force_kernel and
# solid_tangent_kernel in solid_kernels.cu), mirrored in float64 against
# the twins' own functions; no JAX call.
def _neohooke_P_F(H, lam, mu):
    """stress_neohooke_F: P = mu H + r_F (mu (d2 I + H^T - cof H)
    + lam lnJ K_F), K_F = (1 + tr H) I - H^T + cof H, d2 = tr cof H + det H,
    r_F = 1 / (1 + tr H + d2)."""
    cH, I = gm.cof3l(H), gm.eye3l(H)
    trH, Ht = gm.tr3l(H), H.transpose(0, 1)
    d2 = gm.tr3l(cH) + torch.einsum("j...,j...->...", H[0], cH[0])
    delta = trH + d2
    lnJ = 0.5 * torch.log1p(delta * (2.0 + delta))
    KF = (1.0 + trH) * I - Ht + cH
    return mu * H + (mu * (d2 * I + Ht - cH) + lam * lnJ * KF) / (1.0 + delta)


def _first_piola(H, lam, mu, model):
    """first_piola: stress_neohooke_F, or P = F S of St. Venant-Kirchhoff."""
    if model == "neohooke":
        return _neohooke_P_F(H, lam, mu)
    S, _ = lat._svk_stress(lat._strain_A(H), lam, mu)
    return gm.matmul3l(H + gm.eye3l(H), S)


def _force_gen_gp(J, du, Ge_g, w_g, lam, mu, model):
    """force_gen_edge_element's Gauss point: Q = w P(H) K, K = cof(J),
    H = Hhat(u) K^T / det J (det J from K's first row); returns (Q, det J);
    model None is the mass-only mode (det3 of J alone, Q None)."""
    if model is None:
        return None, gm.det3l(J)
    K = gm.cof3l(J)
    det = torch.einsum("j...,j...->...", J[0], K[0])
    H = torch.einsum("ik...,jk...->ij...",
                     torch.einsum("jei...,je->ij...", du, Ge_g), K) / det
    P = _first_piola(H, lam, mu, model)
    return w_g * gm.matmul3l(P, K), det


def _force_gen_edges(xe, ue, dN, w, N, lam, mu, model, mcoef, stiff):
    """The whole B4 element pass by edges on corners (8, 3, ...): the Gauss
    loop into edge sums with the shift register of det J, then the mass
    on u's corners read again, then edges_to_nodes."""
    Ge = _edge_table(dN)
    dx, du = _edge_diff(xe), _edge_diff(ue)
    R, c = torch.zeros_like(dx), [None] * 8
    for g in range(8):
        Q, det = _force_gen_gp(torch.einsum("jei...,je->ij...", dx, Ge[g]),
                               du, Ge[g], w[g], lam, mu,
                               model if stiff else None)
        if stiff:
            R += torch.einsum("ij...,je->jei...", Q, Ge[g])
        c = [det] + c[:7]
    fe = _edges_to_nodes(R)
    if mcoef:
        fe += sum(lat._mass_gp(ue, N[g], mcoef * w[g] * c[7 - g])
                  for g in range(8))
    return fe


@pytest.mark.parametrize("model", ["neohooke", "svk"])
def test_gen_edge_force_gauss_point_matches_dense(model):
    """Each Gauss point's share sum_a Q dN_a of the edge form ==
    force_gen_elements restricted to that Gauss point, on jittered
    elements."""
    cell = get_cell("hex8")
    dN, w, N = (torch.as_tensor(t) for t in (cell.dN, cell.gauss_weights,
                                             cell.N))
    lam, mu = lame(E_MOD, NUE)
    xe = _jittered_elements(6, 51)
    ue = torch.as_tensor(np.random.default_rng(52).normal(size=(8, 3, 6))
                         * 5e-2)
    Ge = _edge_table(dN)
    dx, du = _edge_diff(xe), _edge_diff(ue)
    for g in range(8):
        Q, _ = _force_gen_gp(torch.einsum("jei...,je->ij...", dx, Ge[g]), du,
                             Ge[g], w[g], lam, mu, model)
        want = lat.force_gen_elements(xe, ue, dN[g:g + 1], w[g:g + 1],
                                      N[g:g + 1], lam, mu, model)
        _close(_edges_to_nodes(torch.einsum("ij...,je->jei...", Q, Ge[g])),
               want)


@pytest.mark.parametrize("stiff", [True, False])
def test_gen_force_mass_after_the_loop_matches_mass_gp(stiff):
    """The force's mass after the loop: c[7 - g] = det J_g from the force
    loop (K's first row, or det3 in the mass-only mode), applied to u's
    corners == sum_g _mass_gp(ue, N_g, mcoef wdet_g)."""
    cell = get_cell("hex8")
    dN, w, N = (torch.as_tensor(t) for t in (cell.dN, cell.gauss_weights,
                                             cell.N))
    xe = _jittered_elements(6, 53)
    ue = torch.as_tensor(np.random.default_rng(54).normal(size=(8, 3, 6)))
    Ge = _edge_table(dN)
    dx, du = _edge_diff(xe), _edge_diff(ue)
    c = [None] * 8
    for g in range(8):
        _, det = _force_gen_gp(torch.einsum("jei...,je->ij...", dx, Ge[g]),
                               du, Ge[g], w[g], 1.0, 1.0,
                               "svk" if stiff else None)
        c = [det] + c[:7]
    got = sum(lat._mass_gp(ue, N[g], 137.5 * w[g] * c[7 - g])
              for g in range(8))
    want = sum(lat._mass_gp(ue, N[g], 137.5 * lat._geom_gp(xe, dN[g],
                                                           w[g])[1])
               for g in range(8))
    _close(got, want, rtol=1e-13)


# mode -> (model, mcoef, stiff), as test_torch_gpu.py's GEN_FORCE
_GEN_FORCE = {"neohooke": ("neohooke", 0.0, True),
              "svk": ("svk", 0.0, True), "mass": ("svk", 2.5, False),
              "fused": ("neohooke", 137.5, True)}


@pytest.mark.parametrize("mode", list(_GEN_FORCE))
def test_gen_edge_force_pass_matches_twin(mode):
    """The whole B4 element pass by edges on a jittered 4x3x5 box,
    assembled, == neo_force_gen_ref; the box's corner node (0, 0, 0), which
    only element (0, 0, 0) holds, is pushed through that element, so
    det F < 0 at some of its Gauss points."""
    model, mcoef, stiff = _GEN_FORCE[mode]
    spec = lat.LatticeSpec(pshape=tuple(s + 1 for s in SHAPE), h=None)
    rng = np.random.default_rng(55)
    idx = np.stack(np.meshgrid(*[np.arange(p) for p in spec.pshape],
                               indexing="ij"), axis=-1)
    h = np.asarray(HI) / np.asarray(SHAPE)
    X = idx * h + (rng.random(idx.shape) - 0.5) * 0.3 * h
    U = rng.normal(size=idx.shape) * 3e-2
    U[0, 0, 0] = 1.4 * h
    x, u = (_lat_t(a.reshape(-1), spec) for a in (X, U))
    cell = get_cell("hex8")
    dN, w, N = (torch.as_tensor(t) for t in (cell.dN, cell.gauss_weights,
                                             cell.N))
    lam, mu = lame(E_MOD, NUE)
    xe, ue = torch.stack(lat._corners(x)), torch.stack(lat._corners(u))
    detF = torch.stack([gm.det3l(H + gm.eye3l(H)) for H in (
        torch.einsum("ai...,aj...->ij...", ue, lat._geom_gp(xe, dN[g],
                                                            1.0)[0])
        for g in range(8))])
    assert float(detF[:, 0, 0, 0].min()) < 0.0
    fe = _force_gen_edges(xe, ue, dN, w, N, lam, mu, model, mcoef, stiff)
    want = lat.neo_force_gen_ref(x, u, dN, w, N, lam, mu, model, mcoef, stiff)
    _close(lat._assemble(fe, u), want)


@pytest.mark.parametrize("model, push", [("neohooke", False), ("svk", False),
                                         ("neohooke", True)])
def test_force_edge_pass_matches_twin(box, model, push):
    """B1 by edges on the 4x3x5 box: the edge table of G, the edge
    differences of u, P(H) at every Gauss point into the edge sums with
    wdet, edges_to_nodes, assembled == neo_force_ref.  With ``push`` the
    box's corner node (0, 0, 0), which only element (0, 0, 0) holds, moves
    into that element, so det F < 0.5 at some of its Gauss points."""
    _, spec, _, _ = box
    G, wdet = (torch.as_tensor(x) for x in _geom(spec))
    lam, mu = lame(E_MOD, NUE)
    U = _rand(spec, 5e-2, 26)
    if push:
        U[:3] = 0.5 * np.asarray(HI) / np.asarray(SHAPE)
    u = _lat_t(U, spec)
    Ge = _edge_table(G)
    du = _edge_diff(torch.stack(lat._corners(u)))
    R = torch.zeros_like(du)
    detF = []
    for g in range(8):
        H = torch.einsum("jei...,je->ij...", du, Ge[g])
        detF.append(gm.det3l(H + gm.eye3l(H))[0, 0, 0])
        R += torch.einsum("ij...,je->jei...",
                          wdet[g] * _first_piola(H, lam, mu, model), Ge[g])
    assert (min(detF) < 0.5) == push
    want = lat.neo_force_ref(u, G, wdet, lam, mu, model)
    _close(lat._assemble(_edges_to_nodes(R), u), want)


def _permuted_batches(shape, seed):
    """(24, E) element batches X, u, v of a jittered box whose nodes are
    renumbered at random (general topology), as ops/solid.py's twins take
    them: row a*3+i = component i of local node a in the hex8 cell order."""
    disc = gridgen.box(*shape, hi=HI)
    rng = np.random.default_rng(seed)
    X = np.array(disc.coords)
    X += (rng.random(X.shape) - 0.5) * 0.3 * np.asarray(HI) / np.asarray(
        shape)
    perm = rng.permutation(disc.n_nodes)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(disc.n_nodes)
    conn = inv[disc.blocks["hex8"].conn]
    X = X[perm]

    def batch(nodal):
        return torch.as_tensor(nodal[conn].reshape(-1, 24).T.copy())

    return (batch(X), batch(rng.normal(size=X.shape) * 3e-2),
            batch(rng.normal(size=X.shape)))


@pytest.mark.parametrize("model, mcoef", [("neohooke", 0.0), ("svk", 0.0),
                                          ("neohooke", 137.5)])
def test_solid_tangent_edge_pass_matches_twin(model, mcoef):
    """B7 by edges: the columns of a (24, E) batch of a permuted box as
    corners (8, 3, E), their edge differences, B5's Gauss loop and the mass
    on v's column read again == hex8_tangent_ref."""
    X24, u24, v24 = _permuted_batches((3, 2, 2), 56)
    E = X24.shape[1]
    cell = get_cell("hex8")
    dN, w, N = (torch.as_tensor(t) for t in (cell.dN, cell.gauss_weights,
                                             cell.N))
    lam, mu = lame(E_MOD, NUE)
    Ge = _edge_table(dN)
    xe, ue, ve = (a.reshape(8, 3, E) for a in (X24, u24, v24))
    dx, du, dv = _edge_diff(xe), _edge_diff(ue), _edge_diff(ve)
    R, c = torch.zeros_like(dv), [None] * 8
    for g in range(8):
        Q, det = _gen_gp(torch.einsum("jei...,je->ij...", dx, Ge[g]), du, dv,
                         Ge[g], w[g], lam, mu, model)
        R += torch.einsum("ij...,je->jei...", Q, Ge[g])
        c = [det] + c[:7]
    fe = _edges_to_nodes(R)
    if mcoef:
        fe += sum(lat._mass_gp(ve, N[g], mcoef * w[g] * c[7 - g])
                  for g in range(8))
    want = sops.hex8_tangent_ref(X24, u24, v24, lam, mu, model, mcoef)
    _close(fe.reshape(24, E), want)


@pytest.mark.parametrize("mode", list(_GEN_FORCE))
def test_solid_force_edge_pass_matches_twin(mode):
    """B6 by edges: the columns of a (24, E) batch of a permuted box as
    corners (8, 3, E) through B4's pass by edges (the Gauss loop into edge
    sums, the mass on u's column read again) == hex8_force_ref."""
    model, mcoef, stiff = _GEN_FORCE[mode]
    X24, u24, _ = _permuted_batches((3, 2, 2), 58)
    E = X24.shape[1]
    cell = get_cell("hex8")
    dN, w, N = (torch.as_tensor(t) for t in (cell.dN, cell.gauss_weights,
                                             cell.N))
    lam, mu = lame(E_MOD, NUE)
    fe = _force_gen_edges(X24.reshape(8, 3, E), u24.reshape(8, 3, E), dN, w,
                          N, lam, mu, model, mcoef, stiff)
    want = sops.hex8_force_ref(X24, u24, lam, mu, model, mcoef, stiff)
    _close(fe.reshape(24, E), want)


def _naive_neohooke_P(H, lam, mu):
    """P = mu (F - F^-T) + lam log(det F) F^-T: the form that cancels."""
    F = H + gm.eye3l(H)
    det = gm.det3l(F)
    FinvT = gm.cof3l(F) / det
    return mu * (F - FinvT) + lam * torch.log(det) * FinvT


@pytest.mark.parametrize("size", [1e-6, 1e-3])
def test_neohooke_force_stress_has_no_cancellation(size):
    """In float32, over 200 random H of entries up to ``size``, the
    deformation-gradient form of B4 keeps its relative error against the
    reference's P = F S in float64 (on the same rounded H) at or below 1e-5;
    at 1e-6 the plain mu (F - F^-T) form is off by more than 1e-3."""
    lam, mu = lame(E_MOD, NUE)
    H32 = torch.as_tensor(np.random.default_rng(57).uniform(
        -size, size, size=(3, 3, 200)), dtype=torch.float32)
    H = H32.double()
    S, _ = lat._neo_stress(lat._strain_A(H), lam, mu)
    want = gm.matmul3l(H + gm.eye3l(H), S)

    def rel(P):
        return float((P.double() - want).abs().max() / want.abs().max())

    assert rel(_neohooke_P_F(H, lam, mu)) <= 1e-12
    assert rel(_neohooke_P_F(H32, lam, mu)) <= 1e-5
    if size == 1e-6:
        assert rel(_naive_neohooke_P(H32, lam, mu)) > 1e-3
