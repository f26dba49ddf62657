"""The whole slice against fourc_tpu: GMG hierarchy, initial state and the
gen-alpha step of the flagship problem on a 4^3 box, float64.

The JAX side is the reference's wide lattice step on the CPU
(FOURC_LATTICE=1, x64, plain XLA references), built like
tests/test_solid_wide.py builds it; the port runs its twins.  Both packages
get the same mesh, material, loads and Newton settings, and are compared
level by level:

- GMG level stencils to 1e-12 of max|K| (closed-form B^T D B against the
  reference's jvp columns), Jacobi inverse diagonals to 1e-12, lambda_max
  within 5% (the power iterations start from different random vectors),
  and one V-cycle with the reference's Chebyshev bounds to 1e-11;
- the transfers: interpolation and restriction equal the reference's and
  are exact adjoints;
- the consistent initial state to 1e-10 (the mass solve stops at 1e-10);
- two steps with Newton to tol_res 1e-10, lin_rtol 1e-12: max|d - d_jax| and
  max|v - v_jax| <= 1e-7 of max|d_jax| / max|v_jax|, Newton counts within 1.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourc_tpu.core import gridgen as jgrid
from fourc_tpu.core.conditions import DirichletBC as JDirichletBC
from fourc_tpu.core.conditions import NeumannBC as JNeumannBC
from fourc_tpu.core.functions import FunctionManager as JFunctionManager
from fourc_tpu.linalg import gmg as jgmg
from fourc_tpu.materials import make_material as jmake
from fourc_tpu.physics import solid as jps
from fourc_tpu.physics import solid_lattice as jsl
from fourc_tpu_torch import convert
from fourc_tpu_torch.core import gridgen
from fourc_tpu_torch.core.conditions import DirichletBC, NeumannBC
from fourc_tpu_torch.core.functions import FunctionManager
from fourc_tpu_torch.linalg import gmg
from fourc_tpu_torch.materials import make_material
from fourc_tpu_torch.physics import solid as ps
from fourc_tpu_torch.physics import solid_lattice as psl

N, DT = 4, 0.05
MAT = {"type": "neohooke", "youngs": 1.0e4, "nue": 0.3, "density": 1.0}


def _field(pkg, field_kw=(), **kw):
    """The flagship problem at n=4 in either package (same settings); kw go
    to SolidParams, field_kw to SolidField."""
    disc = pkg.gridgen.box(N, N, N)
    params = pkg.ps.SolidParams(
        kinem="nonlinear", dyntype="genalpha",
        genalpha=pkg.ps.GenAlphaParams(rho_inf=0.9), precond="gmg", **kw)
    params.newton.tol_res = 1e-10
    params.newton.lin_adaptive = False
    params.newton.lin_rtol = 1e-12
    fm = pkg.FunctionManager()
    fm.add(1, "sin(3.0*t)")
    dbc = [pkg.DirichletBC(disc.node_sets["zmin"], [1, 1, 1], [0, 0, 0])]
    neu = [pkg.NeumannBC(disc.face_sets["zmax"], [1, 0, 0], [80.0, 0, 0],
                         funct=[1, 0, 0])]
    return pkg.ps.SolidField(disc, {1: pkg.make_material(dict(MAT))}, params,
                             dirichlet=dbc, neumann=neu, functions=fm,
                             **dict(field_kw))


JAX = types.SimpleNamespace(
    gridgen=jgrid, ps=jps, FunctionManager=JFunctionManager,
    DirichletBC=JDirichletBC, NeumannBC=JNeumannBC, make_material=jmake)
PORT = types.SimpleNamespace(
    gridgen=gridgen, ps=ps, FunctionManager=FunctionManager,
    DirichletBC=DirichletBC, NeumannBC=NeumannBC, make_material=make_material)


@pytest.fixture(scope="module")
def flagship():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FOURC_LATTICE", "1")
        fj = _field(JAX, wide=True)
        fp = _field(PORT, field_kw={"device": "cpu"})
        ga = fj.params.genalpha
        shift = (1 - ga.alpha_m) / (ga.beta * DT * DT)
        yield types.SimpleNamespace(
            fj=fj, fp=fp, shift=shift, pshape=(N + 1,) * 3,
            Mj=jgmg.build_for_solid(fj, mass_shift=shift),
            Mp=gmg.build_for_solid(fp, mass_shift=shift),
            sj=jps.compute_initial_state(fj, jps.init_state(fj)),
            sp=ps.compute_initial_state(fp, ps.init_state(fp)))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def test_gmg_levels_and_stencils(flagship):
    ref = convert.gmg_levels_from_jax(flagship.Mj)
    assert len(flagship.Mp.levels) == len(ref) == 2
    for lv, rl in zip(flagship.Mp.levels, ref):
        assert _rel(lv.K.numpy(), rl["K"]) <= 1e-12
        np.testing.assert_array_equal(lv.free.numpy(), rl["free"])
        assert lv.degree == rl["degree"]


def test_gmg_jacobi_diagonals(flagship):
    ref = convert.gmg_levels_from_jax(flagship.Mj)
    for lv, rl in zip(flagship.Mp.levels, ref):
        assert _rel(torch.where(lv.free, lv.dinv, 0.0).numpy(),
                    np.where(rl["free"], rl["dinv"], 0.0)) <= 1e-12


@pytest.mark.parametrize("level", [0, 1])
def test_gmg_lmax_within_five_percent(flagship, level):
    ref = convert.gmg_levels_from_jax(flagship.Mj)[level]
    lv = flagship.Mp.levels[level]
    assert abs(lv.lmax - ref["lmax"]) <= 0.05 * ref["lmax"]
    assert lv.lmin == pytest.approx(lv.lmax / 30.0)
    assert lv.lmax <= 1.02 * lv.gersh_lmax


def test_v_cycle_matches_reference(flagship):
    """With the reference's Chebyshev bounds, one V-cycle agrees."""
    own = [(lv.lmax, lv.lmin) for lv in flagship.Mp.levels]
    for lv, rl in zip(flagship.Mp.levels,
                      convert.gmg_levels_from_jax(flagship.Mj)):
        lv.lmax, lv.lmin = rl["lmax"], rl["lmin"]
    try:
        r = np.random.default_rng(3).normal(size=flagship.fp.ndof)
        got = flagship.Mp(flagship.fp.to_lattice(torch.as_tensor(r)))
        want = flagship.Mj(jnp.asarray(r))
        assert _rel(flagship.fp.from_lattice(got).numpy(), want) <= 1e-11
    finally:
        for lv, (lmax, lmin) in zip(flagship.Mp.levels, own):
            lv.lmax, lv.lmin = lmax, lmin


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("m", [1, 4])
def test_transfers_match_reference_and_are_adjoint(axis, m):
    rng = np.random.default_rng(10 * axis + m)
    cshape = [3, 2, 4]
    cshape[axis] = m + 1
    fshape = list(cshape)
    fshape[axis] = 2 * m + 1
    c, f = rng.normal(size=cshape), rng.normal(size=fshape)
    P = gmg._interp_axis(torch.as_tensor(c), axis)
    R = gmg._restrict_axis(torch.as_tensor(f), axis)
    np.testing.assert_array_equal(P.numpy(),
                                  jgmg._interp_axis(jnp.asarray(c), axis))
    np.testing.assert_array_equal(R.numpy(),
                                  jgmg._restrict_axis(jnp.asarray(f), axis))
    lhs, rhs = float((P * torch.as_tensor(f)).sum()), float(
        (R * torch.as_tensor(c)).sum())
    assert abs(lhs - rhs) <= 1e-14 * max(abs(lhs), 1.0)


def test_external_force_matches_reference(flagship):
    for t in (0.0, 0.3):
        got = flagship.fp.from_lattice(flagship.fp.external_force(t))
        assert _rel(got.numpy(), flagship.fj.external_force(t)) <= 1e-12


def test_initial_state_matches_reference(flagship):
    sp, sj = flagship.sp, flagship.sj
    for k in ("d", "fint", "fext"):
        assert _rel(sp[k].numpy(), sj[k]) <= 1e-12
    assert _rel(sp["a"].numpy(), sj["a"]) <= 1e-10


def test_step_matches_reference(flagship):
    fj, fp = flagship.fj, flagship.fp
    sj, sp = flagship.sj, flagship.sp
    step_j = jsl.make_wide_genalpha_step(fj, DT, flagship.Mj)
    step_p = ps.make_step(fp, dt=DT)
    for _ in range(2):
        sj, stj = step_j(sj)
        sp, stp = step_p(sp)
        assert stp["converged"] and bool(stj["converged"])
        assert abs(stp["iters"] - int(stj["iters"])) <= 1
        assert np.isfinite(stp["resnorm"])
    ref = convert.state_from_jax(sj, flagship.pshape)
    assert sp["t"] == pytest.approx(ref["t"]) and sp["step"] == ref["step"]
    assert np.abs(ref["d"]).max() > 1e-4  # the load moved the box
    for k in ("d", "v"):
        assert _rel(sp[k].numpy(), ref[k]) <= 1e-7
    flat = psl.from_lattice_state(fp, sp)
    np.testing.assert_array_equal(flat["d"].numpy(),
                                  convert.flat_from_lattice(sp["d"].numpy()))


@pytest.mark.parametrize("change", ["rayleigh_statics", "rayleigh_ost",
                                    "chebyshev", "gmres_chebyshev",
                                    "bicgstab_chebyshev", "dyntype_unknown",
                                    "mass_unknown", "non_hex8"])
def test_unported_configurations_refuse(change):
    disc = gridgen.box(2, 2, 2)
    params = ps.SolidParams(dyntype="genalpha", precond="gmg")
    if change == "non_hex8":  # a tet4 block must not be read as hex8
        disc.blocks["hex8"].cell = "tet4"
    elif change.startswith("rayleigh_"):
        params.rayleigh_alpha = 0.1
        params.dyntype = {"rayleigh_statics": "statics",
                          "rayleigh_ost": "onesteptheta"}[change]
    elif change.endswith("chebyshev"):  # under CG, GMRES and BiCGStab
        params.precond = "chebyshev"
        params.newton.lin_method = change.split("_")[0] if "_" in change \
            else "cg"
    elif change == "dyntype_unknown":
        params.dyntype = "adamsbashforth2"
    else:
        params.mass = "diagonal"
    with pytest.raises(NotImplementedError):
        f = ps.SolidField(disc, {1: make_material(dict(MAT))}, params,
                          device="cpu")
        ps.make_step(f, dt=DT)
