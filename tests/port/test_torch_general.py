"""Slice 2, the jittered box (general geometry on lattice topology), against
fourc_tpu, float64.

Boxes are jittered as tests/test_lattice_general.py jitters them: interior
nodes moved by up to +-0.15 h from ``np.random.RandomState(3)``, and
``structured_shape = None``, so the lattice is recognised from connectivity
alone.  Both packages get the same mesh, material, loads and Newton
settings.  The JAX side:

- the twins of B4 and B5 against the reference's general element path:
  ``ops/solid._internal_force_einsum`` and ``consistent_mass_matvec``
  assembled with numpy, and ``jax.jvp`` of that force, to 1e-12 of the
  largest entry (float64 roundoff of a few dozen terms);
- one case each against the Pallas kernels ``_force_wide_gen`` and
  ``_jvp_wide_gen`` in interpret mode (float32 inside), to 1e-5 relative;
- the GMG levels, the initial state and two gen-alpha steps against the
  reference's flat step on the same box (``FOURC_LATTICE=0``): its wide
  general step calls the Pallas kernels without an interpret flag and so
  cannot run on the CPU.  Its non-uniform GMG levels hold the exact
  per-element linear stiffness, the operator B5 applies at u = 0; its
  Chebyshev bounds come from a power iteration where the port takes the
  Gershgorin bound (as the reference's wide path does), so the Gershgorin
  bounds are compared exactly and the V-cycle runs with the reference's
  bounds copied in.  Steps: Newton to tol_res 1e-10 with lin_rtol 1e-12;
  d and v within 1e-7 relative, Newton counts within 1.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend import core as jcore

from fourc_tpu.core import cells as jcells
from fourc_tpu.core import gridgen as jgrid
from fourc_tpu.core import mesh as jmesh
from fourc_tpu.core.conditions import DirichletBC as JDirichletBC
from fourc_tpu.core.conditions import NeumannBC as JNeumannBC
from fourc_tpu.core.functions import FunctionManager as JFunctionManager
from fourc_tpu.linalg import gmg as jgmg
from fourc_tpu.materials import make_material as jmake
from fourc_tpu.ops import lattice as jlat
from fourc_tpu.ops import lattice_pallas as jlp
from fourc_tpu.ops import solid as jsolid
from fourc_tpu.physics import solid as jps
from fourc_tpu_torch import convert
from fourc_tpu_torch.core import cells, gridgen, mesh
from fourc_tpu_torch.core.conditions import DirichletBC, NeumannBC
from fourc_tpu_torch.core.functions import FunctionManager
from fourc_tpu_torch.linalg import gmg
from fourc_tpu_torch.materials import make_material
from fourc_tpu_torch.materials.elastic import lame
from fourc_tpu_torch.materials.small_strain import LinearElastic
from fourc_tpu_torch.ops import lattice as lat
from fourc_tpu_torch.ops import lattice_kernels as lk
from fourc_tpu_torch.ops import solid as psolid
from fourc_tpu_torch.physics import solid as ps

RTOL = 1e-12
N_STEP, DT = 4, 0.05
E_MOD, NUE, RHO = 1.0e4, 0.3, 1.0
MTYPE = {"neohooke": "neohooke", "svk": "stvenantkirchhoff"}
HEX8 = cells.get_cell("hex8")


def _jitter(disc, n, amp=0.3):
    X = np.array(disc.coords)
    rng = np.random.RandomState(3)
    interior = np.all((X > 1e-12) & (X < 1.0 - 1e-12), axis=1)
    X[interior] += (rng.rand(int(interior.sum()), 3) - 0.5) * (amp / n)
    disc.coords = X
    disc.structured_shape = None
    return disc


def _boxes(n):
    """The same jittered n^3 box in both packages: (port, JAX)."""
    return _jitter(gridgen.box(n, n, n), n), _jitter(jgrid.box(n, n, n), n)


def _field(pkg, disc, field_kw=()):
    """The flagship problem on a given mesh in either package."""
    params = pkg.ps.SolidParams(
        kinem="nonlinear", dyntype="genalpha",
        genalpha=pkg.ps.GenAlphaParams(rho_inf=0.9), precond="gmg")
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
def box():
    """Small box (3^3) for the operators, the step problem (4^3) in both
    packages with the reference on its flat path."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FOURC_LATTICE", "0")
        disc3, jdisc3 = _boxes(3)
        disc4, jdisc4 = _boxes(N_STEP)
        fj = _field(JAX, jdisc4)
        fp = _field(PORT, disc4, {"device": "cpu"})
        ga = fj.params.genalpha
        shift = (1 - ga.alpha_m) / (ga.beta * DT * DT)
        spec3 = lat.general_lattice(disc3.dofmap(3))
        yield types.SimpleNamespace(
            disc3=disc3, jdisc3=jdisc3, spec3=spec3,
            x3=lat.coord_lattice(disc3.coords, spec3, torch.float64, "cpu"),
            tables=tuple(torch.as_tensor(np.asarray(t)) for t in (
                HEX8.dN, HEX8.gauss_weights, HEX8.N)),
            fj=fj, fp=fp, shift=shift, pshape=(N_STEP + 1,) * 3,
            Mj=jgmg.build_for_solid(fj, mass_shift=shift),
            Mp=gmg.build_for_solid(fp, mass_shift=shift, device="cpu"),
            sj=jps.compute_initial_state(fj, jps.init_state(fj)),
            sp=ps.compute_initial_state(fp, ps.init_state(fp)))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _rand(disc, scale, seed):
    return np.random.default_rng(seed).normal(size=disc.n_nodes * 3) * scale


def _jax_elements(jdisc):
    conn = np.asarray(jdisc.blocks["hex8"].conn)
    return conn, jnp.asarray(jdisc.coords)[conn]


def _jax_assemble(jdisc, fe):
    conn = np.asarray(jdisc.blocks["hex8"].conn)
    edof = (conn[:, :, None] * 3 + np.arange(3)).reshape(-1)
    return jnp.zeros(jdisc.n_nodes * 3, fe.dtype).at[edof].add(
        fe.reshape(-1))


def _jax_force(jdisc, model):
    """u -> assembled general element force of the reference (einsum)."""
    conn, Xe = _jax_elements(jdisc)
    mat = jmake({"type": MTYPE[model], "youngs": E_MOD, "nue": NUE,
                 "density": RHO})
    cell = jcells.get_cell("hex8")

    def force(u):
        fe, _ = jsolid._internal_force_einsum(Xe, u.reshape(-1, 3)[conn],
                                              cell, mat)
        return _jax_assemble(jdisc, fe)

    return force


def _jax_mass(jdisc, v, rho):
    conn, Xe = _jax_elements(jdisc)
    me = jsolid.consistent_mass_matvec(Xe, jnp.asarray(v).reshape(-1, 3)[conn],
                                       jcells.get_cell("hex8"), rho)
    return _jax_assemble(jdisc, me)


def _lt(v, spec):
    return lat.to_lattice(torch.as_tensor(v), spec)


def _flat(x, spec):
    return lat.from_lattice(x, spec).numpy()


# -- host layer -------------------------------------------------------------


@pytest.mark.parametrize("n", [(3, 3, 3), (2, 3, 4)])
@pytest.mark.parametrize("ids", ["canonical", "permuted"])
def test_conn_lattice_detection_matches_reference(n, ids):
    disc, jdisc = gridgen.box(*n), jgrid.box(*n)
    for d in (disc, jdisc):
        d.structured_shape = None
    if ids == "permuted":
        perm = np.random.default_rng(1).permutation(disc.n_nodes)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(disc.n_nodes)
        for d in (disc, jdisc):
            d.blocks["hex8"].conn = inv[np.asarray(d.blocks["hex8"].conn)]
    got = mesh._detect_conn_lattice(disc, disc.blocks["hex8"])
    want = jmesh._detect_conn_lattice(jdisc, jdisc.blocks["hex8"])
    if ids == "permuted":
        assert got is None and want is None
        with pytest.raises(NotImplementedError):
            disc.dofmap(3)
        return
    assert got["shape"] == want["shape"] == n
    assert got["pshape"] == want["pshape"]
    assert lat.general_lattice(disc.dofmap(3)).pshape == want["pshape"]


def test_coord_lattice_and_element_corners(box):
    spec = box.spec3
    X = torch.as_tensor(box.disc3.coords)
    np.testing.assert_array_equal(_flat(box.x3, spec),
                                  box.disc3.coords.ravel())
    Xe = lat.element_corners(X.reshape(spec.pshape + (3,)), spec.nshape)
    np.testing.assert_array_equal(Xe.numpy(), _jax_elements(box.jdisc3)[1])
    np.testing.assert_array_equal(
        convert.lattice_coords_from_elements(Xe.numpy(), spec.nshape),
        X.reshape(spec.pshape + (3,)).numpy())


def test_element_setup_quantities_match_reference(box):
    """Chunked per-element lumped mass, stiffness diagonal and absolute row
    sums (chunks of 5 elements) against the closed-form element stiffness,
    itself held to the reference in test_torch_host.py."""
    _, Xe = _jax_elements(box.jdisc3)
    Xe = np.array(Xe)
    cell = cells.get_cell("hex8")
    lam, mu = lame(E_MOD, NUE)
    Ke = psolid.element_stiffness(Xe, cell, LinearElastic(youngs=E_MOD,
                                                          nue=NUE))
    diag, rowabs = psolid.element_stiffness_rows(torch.as_tensor(Xe), cell,
                                                 lam, mu, chunk=5)
    assert _rel(diag.numpy(), np.diagonal(Ke, axis1=1, axis2=2)) <= RTOL
    assert _rel(rowabs.numpy(), np.abs(Ke).sum(axis=2)) <= RTOL
    ml = psolid.element_lumped_mass(torch.as_tensor(Xe), cell, 2.5, chunk=5)
    assert _rel(ml.numpy(), jsolid.lumped_mass(jnp.asarray(Xe),
                                               jcells.get_cell("hex8"),
                                               2.5)) <= RTOL


# -- B4 / B5 twins ----------------------------------------------------------


@pytest.mark.parametrize("model", ["neohooke", "svk"])
@pytest.mark.parametrize("mode", ["force", "mass", "fused"])
def test_force_gen_twin_matches_reference(box, model, mode):
    spec = box.spec3
    lam, mu = lame(E_MOD, NUE)
    u = _rand(box.disc3, 2e-2, 1)
    mcoef = {"force": 0.0, "mass": 2.5, "fused": 137.5}[mode]
    got = lat.neo_force_gen_ref(box.x3, _lt(u, spec), *box.tables, lam, mu,
                                model, mcoef=mcoef, stiff=mode != "mass")
    want = np.zeros(u.shape)
    if mode != "mass":
        want += np.asarray(_jax_force(box.jdisc3, model)(jnp.asarray(u)))
    if mcoef:
        want += np.asarray(_jax_mass(box.jdisc3, u, mcoef))
    assert _rel(_flat(got, spec), want) <= RTOL


@pytest.mark.parametrize("model", ["neohooke", "svk"])
@pytest.mark.parametrize("mcoef", [0.0, 137.5])
def test_jvp_gen_twin_matches_reference(box, model, mcoef):
    spec = box.spec3
    lam, mu = lame(E_MOD, NUE)
    u, v = _rand(box.disc3, 2e-2, 2), _rand(box.disc3, 1e-2, 3)
    got = lat.neo_jvp_gen_ref(box.x3, _lt(u, spec), _lt(v, spec),
                              *box.tables, lam, mu, model, mcoef=mcoef)
    _, want = jax.jvp(_jax_force(box.jdisc3, model), (jnp.asarray(u),),
                      (jnp.asarray(v),))
    want = np.asarray(want) + mcoef * np.asarray(_jax_mass(box.jdisc3, v, 1.0))
    assert _rel(_flat(got, spec), want) <= RTOL


def test_jvp_gen_linear_mode_matches_reference(box):
    """u=None (the GMG level operator): the tangent at u = 0 of either law."""
    spec = box.spec3
    lam, mu = lame(E_MOD, NUE)
    v = _rand(box.disc3, 1e-2, 4)
    got = lat.neo_jvp_gen_ref(box.x3, None, _lt(v, spec), *box.tables, lam,
                              mu, "neohooke")
    u0 = jnp.zeros(v.shape)
    for model in ("neohooke", "svk"):
        _, want = jax.jvp(_jax_force(box.jdisc3, model), (u0,),
                          (jnp.asarray(v),))
        assert _rel(_flat(got, spec), want) <= RTOL


def _interpret_eager(fn, *args):
    """Run fn, whose pallas_call has ``interpret=True``, with every Pallas
    kernel evaluated op by op through pallas_call_hlo_interpret (the
    function the interpret-mode lowering calls) instead of compiling the
    whole unrolled kernel, which takes minutes on a CPU.

    pallas_call_hlo_interpret is private to JAX; this was written against
    JAX 0.9.0.  It is imported here, not with the module, so that a JAX
    that moves it fails only the tests that use it."""
    from jax._src.pallas import hlo_interpreter

    def run(jaxpr, consts, vals):
        env = dict(zip(jaxpr.constvars, consts))
        env.update(zip(jaxpr.invars, vals))

        def read(v):
            return v.val if isinstance(v, jcore.Literal) else env[v]

        for eqn in jaxpr.eqns:
            ins = [read(v) for v in eqn.invars]
            if eqn.primitive.name == "pallas_call":
                params = dict(eqn.params)
                assert params.pop("interpret")
                outs = hlo_interpreter.pallas_call_hlo_interpret(*ins,
                                                                 **params)
            elif eqn.primitive.name in ("pjit", "jit"):
                sub = eqn.params["jaxpr"]
                outs = run(sub.jaxpr, sub.consts, ins)
            else:
                outs = eqn.primitive.bind(*ins, **eqn.params)
                if not eqn.primitive.multiple_results:
                    outs = [outs]
            env.update(zip(eqn.outvars, outs))
        return [read(v) for v in jaxpr.outvars]

    closed = jax.make_jaxpr(fn)(*args)
    with jax.disable_jit():
        return run(closed.jaxpr, closed.consts, args)[0]


@pytest.mark.parametrize("kernel", ["force_gen", "tangent_gen"])
def test_gen_twins_match_pallas_interpret(box, kernel):
    """The twins (float64) against the TPU kernels in interpret mode
    (float32 inside), Neo-Hooke, the consistent mass fused."""
    spec = box.spec3
    jspec = jlat.LatticeSpec(pshape=spec.pshape, h=(1.0, 1.0, 1.0))
    lam, mu = lame(E_MOD, NUE)
    mcoef = 137.5
    u, v = _rand(box.disc3, 2e-2, 5), _rand(box.disc3, 1e-2, 6)
    x3 = jnp.transpose(jnp.asarray(box.disc3.coords, jnp.float32).reshape(
        spec.pshape + (3,)), (3, 0, 1, 2))
    xw = jlp.widen_real(x3, jspec)
    uw, vw = jlp.prep(jnp.asarray(u), jspec), jlp.prep(jnp.asarray(v), jspec)
    if kernel == "force_gen":
        out = _interpret_eager(lambda x, a: jlp._force_wide_gen(
            x, a, jspec, lam, mu, "neohooke", mcoef=mcoef, interpret=True),
            xw, uw)
        got = lat.neo_force_gen_ref(box.x3, _lt(u, spec), *box.tables, lam,
                                    mu, "neohooke", mcoef=mcoef)
    else:
        out = _interpret_eager(lambda x, a, b: jlp._jvp_wide_gen(
            x, a, b, jspec, lam, mu, "neohooke", mcoef=mcoef,
            interpret=True), xw, uw, vw)
        got = lat.neo_jvp_gen_ref(box.x3, _lt(u, spec), _lt(v, spec),
                                  *box.tables, lam, mu, "neohooke",
                                  mcoef=mcoef)
    assert out.dtype == jnp.float32
    want = np.asarray(jlp.unprep(out, jspec), np.float64)
    assert _rel(_flat(got, spec), want) <= 1e-5


def test_cpu_gen_wrappers_use_twins_and_count_nothing(box):
    spec = box.spec3
    lk.reset_launches()
    u = _lt(_rand(box.disc3, 2e-2, 7), spec)
    got = lk.neo_force_gen(box.x3, u, *box.tables, 1.0, 1.0, mcoef=2.0)
    np.testing.assert_array_equal(got.numpy(), lat.neo_force_gen_ref(
        box.x3, u, *box.tables, 1.0, 1.0, mcoef=2.0).numpy())
    got = lk.neo_tangent_gen(box.x3, None, u, *box.tables, 1.0, 1.0, "svk")
    np.testing.assert_array_equal(got.numpy(), lat.neo_jvp_gen_ref(
        box.x3, None, u, *box.tables, 1.0, 1.0, "svk").numpy())
    assert set(lk.launches.values()) == {0}


# -- field, GMG, step -------------------------------------------------------


def test_entry_points_default_to_cuda(box, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _field(PORT, box.disc3)
    with pytest.raises(RuntimeError, match="CUDA"):
        gmg.build_for_solid(box.fp)
    with pytest.raises(RuntimeError, match="CUDA"):
        gmg.StructuredGMG(box.disc3, 3, np.ones(box.disc3.n_nodes * 3, bool),
                          1.0, 1.0)


def test_general_field_operators_match_reference(box):
    fp, fj = box.fp, box.fj
    assert fp.x is not None and not hasattr(fp, "Xe1")
    assert fp.lattice.pshape == box.pshape and fp.lattice.h is None
    v = _rand(fp.disc, 1e-2, 8)
    assert _rel(fp.from_lattice(fp.mass_matvec(fp.to_lattice(
        torch.as_tensor(v)))).numpy(), fj.mass_matvec(jnp.asarray(v))) <= RTOL
    assert _rel(fp.from_lattice(fp.lumped_mass()).numpy(),
                fj.lumped_mass()) <= RTOL
    got = fp.from_lattice(fp.internal_force(fp.to_lattice(torch.as_tensor(
        v)))).numpy()
    assert _rel(got, fj.internal_force(jnp.asarray(v))[0]) <= RTOL


def test_gmg_general_levels_match_reference(box):
    ref = convert.gmg_levels_from_jax(box.Mj)
    assert len(box.Mp.levels) == len(ref) == 2
    for lv, rl in zip(box.Mp.levels, ref):
        assert not lv.uniform and rl["K"] is None
        np.testing.assert_array_equal(lv.free.numpy(), rl["free"])
        np.testing.assert_array_equal(
            lv.x.numpy(), convert.lattice_from_jax(rl["coords"].reshape(-1),
                                                   rl["coords"].shape[:3]))
        assert _rel(torch.where(lv.free, lv.dinv, 0.0).numpy(),
                    np.where(rl["free"], rl["dinv"], 0.0)) <= RTOL
        assert lv.gersh_lmax == pytest.approx(rl["gersh_lmax"], rel=RTOL)
        assert lv.lmax == pytest.approx(1.02 * lv.gersh_lmax, rel=1e-15)
        assert lv.degree == rl["degree"]


def test_gmg_general_v_cycle_matches_reference(box):
    """With the reference's Chebyshev bounds, one V-cycle agrees."""
    own = [(lv.lmax, lv.lmin) for lv in box.Mp.levels]
    for lv, rl in zip(box.Mp.levels, convert.gmg_levels_from_jax(box.Mj)):
        lv.lmax, lv.lmin = rl["lmax"], rl["lmin"]
    try:
        r = np.random.default_rng(9).normal(size=box.fp.ndof)
        got = box.Mp(box.fp.to_lattice(torch.as_tensor(r)))
        want = box.Mj(jnp.asarray(r))
        assert _rel(box.fp.from_lattice(got).numpy(), want) <= 1e-11
    finally:
        for lv, (lmax, lmin) in zip(box.Mp.levels, own):
            lv.lmax, lv.lmin = lmax, lmin


def test_general_initial_state_matches_reference(box):
    """From a nonzero displacement, so that f_int and a0 are nonzero."""
    d = _rand(box.fp.disc, 1e-3, 10)
    sp = ps.compute_initial_state(box.fp, dict(ps.init_state(box.fp),
                                               d=torch.as_tensor(d)))
    sj = jps.compute_initial_state(box.fj, dict(jps.init_state(box.fj),
                                                d=jnp.asarray(d)))
    for k in ("d", "fint", "fext"):
        assert _rel(sp[k].numpy(), sj[k]) <= RTOL
    assert np.abs(np.asarray(sj["a"])).max() > 1.0
    assert _rel(sp["a"].numpy(), sj["a"]) <= 1e-10


def test_general_step_matches_reference(box):
    sj, sp = box.sj, box.sp
    step_j = jps.make_step(box.fj, dt=DT)
    step_p = ps.make_step(box.fp, dt=DT)
    for _ in range(2):
        sj, stj = step_j(sj)
        sp, stp = step_p(sp)
        assert stp["converged"] and bool(stj["converged"])
        assert abs(stp["iters"] - int(stj["iters"])) <= 1
    ref = convert.state_from_jax(sj, box.pshape)
    assert sp["t"] == pytest.approx(ref["t"]) and sp["step"] == ref["step"]
    assert np.abs(ref["d"]).max() > 1e-4  # the load moved the box
    for k in ("d", "v"):
        assert _rel(sp[k].numpy(), ref[k]) <= 1e-7
