"""Slice 6a: 2D geometry, the incompressible fluid field and fluid on a
moving mesh, on the CPU in float64.

Held against the JAX package eagerly (no jit, no time step), on meshes of
at most 4x4 quad4 or 2x2x2 hex8 cells: the quad4 and line2 tables (1e-15),
the rectangle generator (exactly), 2D isoparametric gradients and line2
edge measures, the stabilization parameters with and without dt where the
velocity vanishes at some Gauss points, the element residual plain and
with a body force, grid velocity, Smagorinsky, dynamic Cs^2 and
multifractal inputs (1e-12), its derivative along a random direction
against ``jax.jvp`` (1e-10), the lumped mass, the field's Jacobi diagonal,
the LES closures and the Windkessel residual from a state carried over by
``convert.fluid_state_from_jax``.  The fluid_ale deck's values were
recorded from the reference CLI and the port is held to them at 1e-10.
"""

import numpy as np
import pytest
import torch
import yaml

from fourc_tpu_torch import convert
from fourc_tpu_torch.core import gridgen
from fourc_tpu_torch.core.cells import get_cell
from fourc_tpu_torch.io import deck as deck_mod
from fourc_tpu_torch.ops import common as gm
from fourc_tpu_torch.ops import fluid as ops
from fourc_tpu_torch.ops import turbulence as tops
from fourc_tpu_torch.ops.solid import element_geometry
from fourc_tpu_torch.physics import driver
from fourc_tpu_torch.physics import fluid as pf
from fourc_tpu_torch.physics import fluid_driver

RTOL, JVP_TOL = 1e-12, 1e-10


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / (scale if scale else 1.0))


def _last(a):
    """A reference array (E, ...) -> the port's layout (..., E)."""
    return torch.as_tensor(np.ascontiguousarray(np.moveaxis(
        np.asarray(a, np.float64), 0, -1)))


def _first(t):
    """The port's (..., E) -> the reference's (E, ...)."""
    return np.moveaxis(t.detach().numpy(), -1, 0)


def _patch(dim, seed=0):
    """A jittered 3x3 quad4 rectangle or 2x2x2 hex8 box: (mesh, cell
    name, element coordinates (E, nen, d))."""
    rng = np.random.default_rng(seed)
    d = gridgen.rectangle(3, 3) if dim == 2 else gridgen.box(2, 2, 2)
    name = "quad4" if dim == 2 else "hex8"
    X = d.coords + rng.uniform(-0.06, 0.06, d.coords.shape)
    return d, name, X[d.blocks[name].conn]


def _geometry(Xe, name):
    X = torch.as_tensor(np.ascontiguousarray(Xe.reshape(Xe.shape[0], -1).T))
    G, wdet = element_geometry(X, get_cell(name))
    return G, wdet, torch.as_tensor(np.asarray(get_cell(name).N))


# -- 2D geometry -------------------------------------------------------------


@pytest.mark.parametrize("name", ["quad4", "line2"])
def test_cell_tables_match_reference(name):
    from fourc_tpu.core.cells import get_cell as jcell

    got, want = get_cell(name), jcell(name)
    assert (got.dim, got.nen, got.ngp) == (want.dim, want.nen, want.ngp)
    for attr in ("N", "dN", "gauss_weights", "gauss_points"):
        np.testing.assert_allclose(getattr(got, attr),
                                   np.asarray(getattr(want, attr)),
                                   rtol=0, atol=1e-15)


@pytest.mark.parametrize("shape", [(3, 3, (0, 0), (1, 1)),
                                   (6, 3, (0, 0), (2, 1)),
                                   (8, 8, (0, 0), (4, 1)),
                                   (5, 7, (-1.0, 0.5), (2.0, 3.0))])
def test_rectangle_matches_reference(shape):
    from fourc_tpu.core import gridgen as jgridgen

    nx, ny, lo, hi = shape
    got = gridgen.rectangle(nx, ny, lo, hi, name="fluid")
    want = jgridgen.rectangle(nx, ny, lo, hi, name="fluid")
    np.testing.assert_array_equal(got.coords, np.asarray(want.coords))
    np.testing.assert_array_equal(got.blocks["quad4"].conn,
                                  want.blocks["quad4"].conn)
    assert got.node_sets.keys() == want.node_sets.keys()
    for nm, ids in got.node_sets.items():
        np.testing.assert_array_equal(ids, want.node_sets[nm])
    assert got.face_sets.keys() == want.face_sets.keys()
    for nm, (fb,) in got.face_sets.items():
        (wb,) = want.face_sets[nm]
        assert fb.cell == wb.cell == "line2"
        np.testing.assert_array_equal(fb.conn, wb.conn)


@pytest.mark.parametrize("cell", ["quad8", "quad9", "tri3"])
def test_rectangle_refuses_other_cells_by_name(cell):
    with pytest.raises(NotImplementedError, match=f"{cell}.*not ported"):
        gridgen.rectangle(2, 2, cell=cell)


def test_2d_gradients_and_edges_match_reference():
    from fourc_tpu.core.cells import get_cell as jcell
    from fourc_tpu.ops import common as jgm

    d, name, Xe = _patch(2)
    Gw, dJw = jgm.iso_gradients(Xe, jcell(name).dN)
    G, dJ = gm.iso_gradients(Xe, get_cell(name).dN)
    assert _rel(G, Gw) <= RTOL and _rel(dJ, dJw) <= RTOL
    Gt, wdet, _ = _geometry(Xe, name)
    assert _rel(_first(Gt).transpose(0, 3, 1, 2), Gw) <= RTOL
    assert _rel(_first(wdet), jgm.weighted(dJw, jcell(name).gauss_weights)) \
        <= RTOL
    X = d.coords + 0.0
    X[5] += (0.03, -0.02)
    for nm, (fb,) in d.face_sets.items():
        Xf = X[fb.conn]
        dA, n = gm.surface_measure(Xf, get_cell("line2").dN)
        dAw, nw = jgm.surface_measure(Xf, jcell("line2").dN)
        assert _rel(dA, dAw) <= RTOL and _rel(n, nw) <= RTOL, nm


# -- fluid element operators -------------------------------------------------


def _inputs(dim, seed=1):
    d, name, Xe = _patch(dim, seed)
    rng = np.random.default_rng(seed)
    E, nen, _ = Xe.shape
    ngp = get_cell(name).ngp
    ue = rng.normal(size=(E, nen, dim))
    ue[0] = 0.0  # Gauss points where the velocity is 0
    return dict(
        d=d, name=name, Xe=Xe, ue=ue, pe=rng.normal(size=(E, nen)),
        ude=rng.normal(size=(E, nen, dim)),
        gv=0.3 * rng.normal(size=(E, nen, dim)),
        body=rng.normal(size=(E, ngp, dim)),
        hat=rng.normal(size=(E, nen, dim)),
        B=rng.uniform(0.1, 1.0, size=E), cs2=rng.uniform(0.01, 0.05, size=E),
        du=rng.normal(size=(E, nen, dim)), dp=rng.normal(size=(E, nen)),
        dud=rng.normal(size=(E, nen, dim)))


CASES = {
    "plain": {},
    "stationary": {"dt": None},
    "ale_smagorinsky_body": {"dt": 0.1, "grid_vel": True,
                             "smagorinsky_cs": 0.17, "body": True},
    "dynamic_cs2_mfs": {"dt": 0.1, "cs2": True, "mfs": True},
    "no_stabilization": {"dt": 0.1, "stab": False},
}


def _kwargs(case, inp):
    spec = CASES[case]
    jkw, tkw = {}, {}
    jkw["dt"] = tkw["dt"] = spec.get("dt", 0.05)
    if "stab" in spec:  # the reference's three switches, all alike
        tkw["stab"] = spec["stab"]
        for key in ("supg", "pspg", "graddiv"):
            jkw[key] = spec["stab"]
    if spec.get("grid_vel"):
        jkw["grid_vel"], tkw["grid_vel"] = inp["gv"], _last(inp["gv"])
    if spec.get("smagorinsky_cs"):
        jkw["smagorinsky_cs"] = tkw["smagorinsky_cs"] = spec["smagorinsky_cs"]
    if spec.get("body"):
        jkw["body_gp"] = inp["body"]
        tkw["body"] = torch.as_tensor(np.ascontiguousarray(
            np.transpose(inp["body"], (2, 1, 0))))
    if spec.get("cs2"):
        jkw["cs2_gp"], tkw["cs2"] = inp["cs2"], torch.as_tensor(inp["cs2"])
    if spec.get("mfs"):
        jkw["mfs_B"], tkw["mfs_B"] = inp["B"], torch.as_tensor(inp["B"])
        jkw["mfs_ue_hat"], tkw["mfs_ue_hat"] = inp["hat"], _last(inp["hat"])
    return jkw, tkw


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("with_dt", [False, True])
def test_stab_params_match_reference(dim, with_dt):
    import jax.numpy as jnp
    from fourc_tpu.core.cells import get_cell as jcell
    from fourc_tpu.ops import common as jgm
    from fourc_tpu.ops import fluid as jops

    inp = _inputs(dim)
    cell = jcell(inp["name"])
    Gw, dJ = jgm.iso_gradients(jnp.asarray(inp["Xe"]), cell.dN)
    wdw = jgm.weighted(dJ, cell.gauss_weights)
    uw = jnp.einsum("ga,eai->egi", jnp.asarray(cell.N), inp["ue"])
    dt = 0.05 if with_dt else None
    tm_w, tc_w = jops.stab_params(uw, 0.01, 1.3, Gw, wdw, dim, dt)
    G, wdet, N = _geometry(inp["Xe"], inp["name"])
    tm, tc = ops.stab_params(ops.interp_vec(N, _last(inp["ue"])), 0.01, 1.3,
                             G, wdet, dt)
    assert _rel(_first(tm), tm_w) <= RTOL
    assert _rel(_first(tc), tc_w) <= RTOL
    # u = 0 in element 0: |u| is the smoothed norm's 1e-15 there
    assert float(tc[:, 0].abs().max()) < 1e-20


def _reference_residual(inp, jkw, mu, rho):
    import jax.numpy as jnp
    from fourc_tpu.core.cells import get_cell as jcell
    from fourc_tpu.ops import fluid as jops

    args = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in jkw.items()}

    def f(ue, pe, ude):
        return jops.residual(jnp.asarray(inp["Xe"]), ue, pe, ude,
                             jcell(inp["name"]), mu=mu, rho=rho, **args)

    return f


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_residual_and_its_derivative_match_reference(dim, case):
    import jax
    import jax.numpy as jnp

    inp = _inputs(dim)
    jkw, tkw = _kwargs(case, inp)
    f = _reference_residual(inp, jkw, 0.01, 1.3)
    prim = tuple(jnp.asarray(inp[k]) for k in ("ue", "pe", "ude"))
    tang = tuple(jnp.asarray(inp[k]) for k in ("du", "dp", "dud"))
    (fm_w, fc_w), (dfm_w, dfc_w) = jax.jit(
        lambda p, t: jax.jvp(f, p, t))(prim, tang)
    G, wdet, N = _geometry(inp["Xe"], inp["name"])
    fm, fc, tangent = ops.linearize(G, wdet, N, _last(inp["ue"]),
                                    _last(inp["pe"]), _last(inp["ude"]),
                                    0.01, 1.3, **tkw)
    assert _rel(_first(fm), fm_w) <= RTOL
    assert _rel(_first(fc), fc_w) <= RTOL
    dfm, dfc = tangent(_last(inp["du"]), _last(inp["dp"]),
                       _last(inp["dud"]))
    assert _rel(_first(dfm), dfm_w) <= JVP_TOL
    assert _rel(_first(dfc), dfc_w) <= JVP_TOL
    # the kept tangent is forward mode's through the port's own residual
    _, (dfm_t, dfc_t) = torch.func.jvp(
        lambda u, p, ud: ops.residual(G, wdet, N, u, p, ud, 0.01, 1.3,
                                      **tkw),
        tuple(_last(inp[k]) for k in ("ue", "pe", "ude")),
        tuple(_last(inp[k]) for k in ("du", "dp", "dud")))
    assert _rel(dfm.numpy(), dfm_t.numpy()) <= 1e-14
    assert _rel(dfc.numpy(), dfc_t.numpy()) <= 1e-14


def test_residual_refuses_low_mach_inputs():
    inp = _inputs(2)
    G, wdet, N = _geometry(inp["Xe"], inp["name"])
    args = (G, wdet, N, _last(inp["ue"]), _last(inp["pe"]),
            _last(inp["ude"]), 0.01, 1.0)
    for key in ("rho_gp", "cont_src_gp"):
        with pytest.raises(NotImplementedError, match="low-Mach"):
            ops.residual(*args, **{key: wdet})


def test_float32_guards_keep_the_residual_and_tangent_finite():
    """In float32 the 1e-300 guards round to 0: where the velocity is 0
    the streamlength is inf and ``where`` must take V^(1/d)."""
    inp = _inputs(3)
    G, wdet, N = (t.float() for t in _geometry(inp["Xe"], inp["name"]))
    ue = torch.zeros_like(_last(inp["ue"])).float()
    fm, fc, tangent = ops.linearize(G, wdet, N, ue,
                                    _last(inp["pe"]).float(), ue, 0.01, 1.0,
                                    dt=0.01)
    dfm, dfc = tangent(_last(inp["du"]).float(), _last(inp["dp"]).float(),
                       _last(inp["dud"]).float())
    for t in (fm, fc, dfm, dfc):
        assert bool(torch.isfinite(t).all())


@pytest.mark.parametrize("dim", [2, 3])
def test_lumped_mass_matches_reference(dim):
    from fourc_tpu.core.cells import get_cell as jcell
    from fourc_tpu.ops import fluid as jops

    inp = _inputs(dim)
    _, wdet, N = _geometry(inp["Xe"], inp["name"])
    assert _rel(_first(ops.velocity_lumped_mass(wdet, N, 1.3)),
                jops.velocity_lumped_mass(inp["Xe"], jcell(inp["name"]),
                                          1.3)) <= RTOL


@pytest.mark.parametrize("dim", [2, 3])
def test_les_closures_match_reference(dim):
    import jax
    import jax.numpy as jnp
    from fourc_tpu.core.cells import get_cell as jcell
    from fourc_tpu.ops import turbulence as jtops

    inp = _inputs(dim)
    d, name = inp["d"], inp["name"]
    conn = d.blocks[name].conn
    ue = inp["ue"] + 0.5
    @jax.jit
    def closures(Xe, ue):
        return (jtops.dynamic_cs2(Xe, ue, jcell(name), jnp.asarray(conn),
                                  d.n_nodes),
                jtops.mfs_fields(Xe, ue, jcell(name), jnp.asarray(conn),
                                 d.n_nodes, nu=2e-3, csgs=0.25))

    cs2_w, (B_w, hat_w) = closures(jnp.asarray(inp["Xe"]), jnp.asarray(ue))
    G, wdet, N = _geometry(inp["Xe"], name)
    patches = tops.PatchFilter(d.dofmap(1, lattice=False).blocks[name],
                               d.n_nodes)
    cs2 = tops.dynamic_cs2(G, wdet, N, _last(ue), patches)
    B, hat = tops.mfs_fields(G, wdet, N, _last(ue), patches, 2e-3, csgs=0.25)
    assert float(cs2_w[0]) > 0.0
    assert _rel(cs2.numpy(), cs2_w) <= RTOL
    assert _rel(B.numpy(), B_w) <= RTOL and float(B.min()) > 0.0
    assert _rel(hat.numpy(), hat_w) <= RTOL


# -- the field ---------------------------------------------------------------

CHANNEL = """
problem: {type: fluid}
fluid_dynamic: {dynamictype: genalpha, timestep: 0.5, numstep: 2,
                rho_inf: 0.7, maxiter: 25, tolres: 1e-10, toldisp: 1e-12,
                normcombi: or}
solver: {method: gmres, precond: jacobi, maxiter: 2000, gmres_restart: 120}
materials:
  1: {type: newtonianfluid, viscosity: 0.01, density: 1.0}
functions:
  1: "1.0 - exp(-5.0*t)"
  2: "0.3*x*t"
geometry:
  generator: {kind: rectangle, nx: 4, ny: 2, cell: quad4, mat: 1,
              lo: [0, 0], hi: [2, 1], name: fluid}
conditions:
  dirichlet:
    - {nodes: xmin, onoff: [1,1,0], val: [0.5,0,0], funct: [1,0,0]}
    - {nodes: ymin, onoff: [0,1,0], val: [0,0,0]}
    - {nodes: ymax, onoff: [0,1,0], val: [0,0,0]}
  neumann:
    - {faces: ymax, onoff: [1, 0, 0], val: [0.2, 0, 0], funct: [2, 0, 0]}
  body_force:
    - {val: [0.1, -0.3], funct: [2, 0]}
  windkessel_outflow:
    - {faces: xmax, r1: 2.0, r2: 8.0, c: 0.5, p0: 0.3}
"""


def _channel_pair(turbulence=None):
    """The channel deck as a JAX and a port FluidField on the CPU, and a
    random state carried over by ``convert.fluid_state_from_jax``."""
    import jax.numpy as jnp
    from fourc_tpu.io import deck as jdeck
    from fourc_tpu.physics import fluid_driver as jfd

    data = yaml.safe_load(CHANNEL)
    if turbulence:
        data["fluid_dynamic"].update(turbulence)
    jf = jfd.build_field(jdeck.load(data))
    f = fluid_driver.build_field(deck_mod.load(data), device="cpu")
    rng = np.random.default_rng(3)
    n = f.ndof
    jstate = {"x": jnp.asarray(rng.normal(size=n)),
              "xdot": jnp.asarray(rng.normal(size=n)),
              "x_nm1": jnp.asarray(rng.normal(size=n)),
              "pwk": jnp.asarray([0.7]), "t": jnp.asarray(0.5),
              "step": jnp.asarray(1)}
    st = convert.fluid_state_from_jax(jstate)
    state = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
             for k, v in st.items()}
    return jf, f, jstate, state


@pytest.mark.parametrize("turbulence", [None, {"turbulence_model":
                                               "smagorinsky",
                                               "smagorinsky_cs": 0.17},
                                        {"turbulence_model":
                                         "dynamic_smagorinsky"},
                                        {"turbulence_model":
                                         "multifractal"}],
                         ids=["laminar", "smagorinsky", "dynamic", "mfs"])
def test_field_residual_matches_reference(turbulence):
    """The assembled residual with a traction, a body force and the
    Windkessel outflow, and its derivative (the Windkessel's too)."""
    import jax
    import jax.numpy as jnp

    jf, f, js, s = _channel_pair(turbulence)
    t, dt = 0.75, 0.5
    v = np.random.default_rng(4).normal(size=f.ndof)

    def jres(x):
        return (jf.residual_transient(x, js["xdot"], t, dt=dt)
                + jf.windkessel_residual(x, js["pwk"], dt))

    rw, drw = jax.jit(lambda x, v: jax.jvp(jres, (x,), (v,)))(
        js["x"], jnp.asarray(v))
    r, apply = f.linearize(s["x"], s["xdot"], t, dt=dt)
    r = r + f.windkessel_residual(s["x"], s["pwk"], dt)
    dr = apply(torch.as_tensor(v), torch.zeros(f.ndof, dtype=torch.float64))
    dr = dr + f.windkessel_tangent(torch.as_tensor(v), dt)
    assert _rel(r.numpy(), rw) <= RTOL
    assert _rel(dr.numpy(), drw) <= JVP_TOL
    assert _rel(f.windkessel_update(s["x"], s["pwk"], dt).numpy(),
                jf.windkessel_update(js["x"], js["pwk"], dt)) <= RTOL
    assert _rel(f.windkessel_residual(s["x"], s["pwk"], None).numpy(),
                jf.windkessel_residual(js["x"], js["pwk"], None)) <= RTOL


@pytest.mark.parametrize("dt", [None, 0.1])
def test_preconditioner_diagonal_matches_reference(dt):
    import jax.numpy as jnp

    jf, f, _, _ = _channel_pair()
    kw = {} if dt is None else {"dt_factor": 1.0 / dt, "dt": dt}
    ones = np.ones(f.ndof)
    assert _rel(f.build_preconditioner(**kw)(torch.as_tensor(ones)).numpy(),
                jf.build_preconditioner(**kw)(jnp.asarray(ones))) <= RTOL


def test_init_state_matches_reference():
    from fourc_tpu.io import deck as jdeck
    from fourc_tpu.physics import fluid as jpf
    from fourc_tpu.physics import fluid_driver as jfd

    data = yaml.safe_load(CHANNEL)
    data["functions"][3] = ["sin(x)*y", "x - y"]
    data["fluid_dynamic"]["initialfield_funct"] = 3
    js = jpf.init_state(jfd.build_field(jdeck.load(data)))
    s = pf.init_state(fluid_driver.build_field(deck_mod.load(data),
                                               device="cpu"))
    for k in ("x", "xdot", "x_nm1", "pwk"):
        assert _rel(s[k].numpy(), js[k]) <= RTOL, k


def test_velz_of_a_2d_fluid_raises():
    f = fluid_driver.build_field(deck_mod.load(CHANNEL), device="cpu")
    view = fluid_driver.FluidFieldView(f)
    state = pf.init_state(f)
    assert view.node_value(state, "velx", 0) == 0.0
    with pytest.raises(KeyError, match="velz"):
        view.node_value(state, "velz", 0)


# -- fluid on a moving mesh --------------------------------------------------

# a lid-driven 4x4 cavity whose bottom wall bulges (the mesh follows
# 0.05 sin(pi x) t there, the fluid the wall's velocity); its values below
# were printed by the reference CLI (python -m fourc_tpu.app.main <deck>
# --platform cpu) at commit 18bd9523552dbd9599b7bf107f534d0c99aefaa3,
# 3 steps, 20 Newton iterations
FLUID_ALE = """
problem: {type: fluid_ale}
fluid_dynamic: {dynamictype: onesteptheta, theta: 1.0, numstep: 3,
                timestep: 0.1, maxiter: 20, tolres: 1e-10, toldisp: 1e-12,
                normcombi: or}
solver: {method: gmres, precond: jacobi, maxiter: 1000, gmres_restart: 80}
materials:
  1: {type: newtonianfluid, viscosity: 0.05, density: 1.0}
functions:
  1: "0.05*sin(3.14159265*x)*t"
  2: "0.05*sin(3.14159265*x)"
geometry:
  generator: {kind: rectangle, nx: 4, ny: 4, cell: quad4, mat: 1,
              lo: [0, 0], hi: [1, 1], name: fluid}
conditions:
  dirichlet:
    - {nodes: ymax, onoff: [1, 1, 0], val: [1.0, 0, 0]}
    - {nodes: xmin, onoff: [1, 1, 0], val: [0, 0, 0]}
    - {nodes: xmax, onoff: [1, 1, 0], val: [0, 0, 0]}
    - {nodes: ymin, onoff: [1, 1, 0], val: [0, 1.0, 0], funct: [0, 2, 0]}
    - {nodes: [0], onoff: [0, 0, 1], val: [0, 0, 0]}
  ale_dirichlet:
    - {nodes: xmin, onoff: [1, 1], val: [0, 0]}
    - {nodes: xmax, onoff: [1, 1], val: [0, 0]}
    - {nodes: ymax, onoff: [1, 1], val: [0, 0]}
    - {nodes: ymin, onoff: [1, 1], val: [0, 1.0], funct: [0, 1]}
"""
FLUID_ALE_VALUES = [  # (node, quantity, the reference CLI's value)
    (12, "velx", -0.2510352829629399),
    (12, "vely", 0.0122740288785103),
    (7, "velx", -0.08788332055473974),
    (7, "pressure", 0.8197109964930183),
    (18, "pressure", 1.063461256276345),
    (6, "mdispy", 0.004602692408649649),
    (12, "mdispy", 0.002756563080718677),
]


def test_fluid_ale_deck_matches_the_reference_cli():
    res = driver.run(FLUID_ALE, device="cpu")
    assert res.stats["fluid_ale"]["newton_iters"] == 20
    view, state = res.fields["fluid_ale"], res.states["fluid_ale"]
    for node, q, want in FLUID_ALE_VALUES:
        got = view.node_value(state, q, node)
        assert abs(got - want) <= 1e-10 * max(abs(want), 1.0), (node, q)
    assert view.node_value(state, "mdispx", 6) == 0.0


def test_fluid_ale_refuses_other_integrators_by_name():
    data = yaml.safe_load(FLUID_ALE)
    data["fluid_dynamic"]["dynamictype"] = "bdf2"
    with pytest.raises(NotImplementedError, match="fluid_ale under "
                       "dynamictype 'bdf2'"):
        driver.run(data, device="cpu")
