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
from fourc_tpu_torch.materials.elastic import lame
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
    for name in lk.SOURCES:
        assert (lk.CSRC / name).is_file()
    assert lk.library_path().name.startswith("liblattice_")
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc"):
        lk.find_nvcc()


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
