"""CUDA kernels against their twins on the card (skipped without a GPU).

Run on a machine with a CUDA device from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/port/test_torch_gpu.py -q

(``--noconftest`` because tests/conftest.py imports JAX, which the GPU
machine need not have; this file imports only the port.)  Tolerances: the
kernels and the twins sum in different orders, so float64 results agree to
1e-10 relative and float32 results to 1e-4 (8 Gauss points times 8
elements of float32 roundoff).
"""

import numpy as np
import pytest
import torch

from fourc_tpu_torch.core import cells
from fourc_tpu_torch.materials.elastic import lame
from fourc_tpu_torch.ops import lattice as lat
from fourc_tpu_torch.ops import lattice_kernels as lk
from fourc_tpu_torch.ops import solid as sops
from fourc_tpu_torch.ops import solid_kernels as sk

pytestmark = pytest.mark.gpu

TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
SHAPES = [(4, 3, 5), (9, 7, 12)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed):
    spec = lat.LatticeSpec(pshape=tuple(s + 1 for s in shape),
                           h=(0.3, 0.2, 0.4))
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=device).contiguous()

    def field(scale):
        return lat.to_lattice(t(rng.normal(size=spec.ndof) * scale), spec)

    G, wdet = lat.uniform_geometry(cells.get_cell("hex8"), spec)
    return spec, t, field, t(G), t(wdet), t(cells.get_cell("hex8").N)


def _rel(got, want):
    assert torch.isfinite(got).all() and torch.isfinite(want).all()
    return float((got - want).abs().max() / want.abs().max())


# No interior node at all; then boxes whose ny - 1 interior rows along y
# fill the last of the kernel's 4-row groups with 4, 1, 2 and 3 rows.
STENCIL_SHAPES = [(1, 1, 1), (2, 3, 1), (5, 9, 3), (5, 10, 3), (9, 7, 12),
                  (16, 16, 16)]
STENCIL_CASES = ([(shape, "random") for shape in STENCIL_SHAPES]
                 + [((9, 7, 12), "mass")])


def _mass_stencil(shape, dtype, device):
    """The consistent-mass stencil of a SolidField on the box of _inputs."""
    from fourc_tpu_torch.core import gridgen
    from fourc_tpu_torch.materials import make_material
    from fourc_tpu_torch.physics import solid as ps

    mat = make_material({"type": "neohooke", "youngs": 500.0, "nue": 0.3,
                         "density": 2.7})
    hi = tuple(n * h for n, h in zip(shape, (0.3, 0.2, 0.4)))
    f = ps.SolidField(gridgen.box(*shape, hi=hi), {1: mat}, ps.SolidParams(),
                      device=device, dtype=dtype)
    return f.mass_stencil


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape, stencil", STENCIL_CASES)
def test_stencil_kernel_matches_twin(cuda, dtype, shape, stencil):
    _, t, field, *_ = _inputs(shape, dtype, cuda, 1)
    if stencil == "mass":
        K = _mass_stencil(shape, dtype, cuda)
    else:
        B = np.random.default_rng(2).normal(size=(24, 24))
        K = t(lat.collapse_stencil(B + B.T))
    v = field(1.0)
    lk.reset_launches()
    got = lk.stencil_matvec(K, v)
    assert lk.launches["stencil"] == 1
    assert _rel(got, lat.stencil_matvec_ref(K, v)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("model", ["neohooke", "svk"])
def test_force_kernel_matches_twin(cuda, dtype, shape, model):
    _, _, field, G, wdet, _ = _inputs(shape, dtype, cuda, 3)
    lam, mu = lame(500.0, 0.3)
    u = field(1e-2)
    got = lk.neo_force(u, G, wdet, lam, mu, model)
    assert _rel(got, lat.neo_force_ref(u, G, wdet, lam, mu, model)) \
        <= TOL[dtype]


# u of 4e-2 keeps det F >= 0.2 on (9, 7, 12); at 1e-1 elements invert and
# |det F| comes near 0 there, where the float32 twin is itself off the
# float64 answer by more than 1e-4, so no kernel can be held to it
# (test_torch_lattice.py::test_gpu_tangent_inputs_conditioning).
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(1, 1, 1)] + SHAPES)
@pytest.mark.parametrize("mcoef", [0.0, 137.5])
@pytest.mark.parametrize("model, scale", [("neohooke", 1e-2),
                                          ("neohooke", 4e-2), ("svk", 1e-2)])
def test_tangent_kernel_matches_twin(cuda, dtype, shape, mcoef, model, scale):
    _, _, field, G, wdet, N = _inputs(shape, dtype, cuda, 4)
    lam, mu = lame(500.0, 0.3)
    u, v = field(scale), field(1.0)
    lk.reset_launches()
    got = lk.neo_tangent(u, v, G, wdet, N, lam, mu, model, mcoef)
    assert lk.launches["tangent"] == 1
    want = lat.neo_jvp_ref(u, v, G, wdet, lam, mu, model, N=N, mcoef=mcoef)
    assert _rel(got, want) <= TOL[dtype]


def _coords(spec, t, seed):
    """Coordinate lattice of the spec's box with every node jittered by up
    to +-0.15 h per axis (general geometry, positive Jacobians)."""
    idx = np.stack(np.meshgrid(*[np.arange(p) for p in spec.pshape],
                               indexing="ij"), axis=-1)
    h = np.asarray(spec.h)
    X = idx * h + (np.random.default_rng(seed).random(idx.shape) - 0.5) \
        * 0.3 * h
    return lat.to_lattice(t(X.reshape(-1)), spec)


GEN_FORCE = {"neohooke": ("neohooke", 0.0, True), "svk": ("svk", 0.0, True),
             "mass": ("svk", 2.5, False), "fused": ("neohooke", 137.5, True)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", list(GEN_FORCE))
def test_force_gen_kernel_matches_twin(cuda, dtype, shape, mode):
    spec, t, field, *_, N = _inputs(shape, dtype, cuda, 6)
    x = _coords(spec, t, 7)
    tab = (t(cells.get_cell("hex8").dN),
           t(cells.get_cell("hex8").gauss_weights), N)
    model, mcoef, stiff = GEN_FORCE[mode]
    lam, mu = lame(500.0, 0.3)
    u = field(1e-2)
    lk.reset_launches()
    got = lk.neo_force_gen(x, u, *tab, lam, mu, model, mcoef, stiff)
    assert lk.launches["force_gen"] == 1
    want = lat.neo_force_gen_ref(x, u, *tab, lam, mu, model, mcoef, stiff)
    assert _rel(got, want) <= TOL[dtype]


# mode -> (u scale, None for the linear mode; model; mcoef).  u of 3e-2
# keeps det F >= 0.2 on (9, 7, 12); at 4e-2 it falls to 0.19
# (test_torch_lattice.py::test_gpu_tangent_gen_inputs_conditioning).
GEN_TANGENT = {"neohooke": (1e-2, "neohooke", 0.0),
               "fused": (1e-2, "neohooke", 137.5),
               "linear": (None, "svk", 0.0), "svk": (1e-2, "svk", 0.0),
               "svk_fused": (1e-2, "svk", 137.5),
               "neohooke_large": (3e-2, "neohooke", 137.5)}


GP_SWITCH_PER_SM = 72  # lattice_kernels.cu kGpSwitchPerSm


def _switch_shape(side):
    """A box of 1 x GP_SWITCH_PER_SM x SMs elements, the count from which
    B5's linear mode leaves the Gauss-point mapping, or one row of
    GP_SWITCH_PER_SM elements fewer."""
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    return (1, GP_SWITCH_PER_SM, sm - (side == "below switch"))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize(
    "mode,shape",
    [(m, s) for m in GEN_TANGENT for s in [(1, 1, 1)] + SHAPES]
    # only the linear mode reaches the switch between the mappings
    + [("linear", "below switch"), ("linear", "above switch")])
def test_tangent_gen_kernel_matches_twin(cuda, dtype, shape, mode):
    if isinstance(shape, str):
        shape = _switch_shape(shape)
    spec, t, field, *_, N = _inputs(shape, dtype, cuda, 8)
    x = _coords(spec, t, 9)
    tab = (t(cells.get_cell("hex8").dN),
           t(cells.get_cell("hex8").gauss_weights), N)
    lam, mu = lame(500.0, 0.3)
    scale, model, mcoef = GEN_TANGENT[mode]
    u = None if scale is None else field(scale)
    v = field(1.0)
    lk.reset_launches()
    got = lk.neo_tangent_gen(x, u, v, *tab, lam, mu, model, mcoef)
    assert lk.launches["tangent_gen"] == 1
    want = lat.neo_jvp_gen_ref(x, u, v, *tab, lam, mu, model, mcoef)
    assert _rel(got, want) <= TOL[dtype]


def _batches(E, dtype, device, seed):
    """Element batches (24, E) of jittered unit cubes at random offsets:
    coordinates, a small displacement and a direction."""
    rng = np.random.default_rng(seed)
    base = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], float)
    Xe = (base[None] * rng.uniform(0.2, 0.5, size=(E, 1, 3))
          + rng.uniform(-0.02, 0.02, size=(E, 8, 3))
          + rng.uniform(0, 3, size=(E, 1, 3)))

    def t(x):
        return torch.as_tensor(x.reshape(E, 24).T.copy(), dtype=dtype,
                               device=device)

    return (t(Xe), t(rng.normal(size=(E, 8, 3)) * 5e-3),
            t(rng.normal(size=(E, 8, 3))))


# E = 1 and sizes off the block size of 128 exercise the masked tail
BATCHES = [1, 130, 1000]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("E", BATCHES)
@pytest.mark.parametrize("mode", list(GEN_FORCE))
def test_solid_force_kernel_matches_twin(cuda, dtype, E, mode):
    X, u, _ = _batches(E, dtype, cuda, 10)
    model, mcoef, stiff = GEN_FORCE[mode]
    lam, mu = lame(500.0, 0.3)
    sk.reset_launches()
    got = sk.hex8_force(X, u, lam, mu, model, mcoef, stiff)
    assert sk.launches == {"force": 1, "tangent": 0}
    want = sops.hex8_force_ref(X, u, lam, mu, model, mcoef, stiff)
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("E", BATCHES)
@pytest.mark.parametrize("model, mcoef", [("neohooke", 0.0),
                                          ("neohooke", 137.5), ("svk", 0.0),
                                          ("svk", 137.5)])
def test_solid_tangent_kernel_matches_twin(cuda, dtype, E, model, mcoef):
    X, u, v = _batches(E, dtype, cuda, 11)
    lam, mu = lame(500.0, 0.3)
    sk.reset_launches()
    got = sk.hex8_tangent(X, u, v, lam, mu, model, mcoef)
    assert sk.launches == {"force": 0, "tangent": 1}
    want = sops.hex8_tangent_ref(X, u, v, lam, mu, model, mcoef)
    assert _rel(got, want) <= TOL[dtype]


def test_solid_kernel_rejects_bad_batches(cuda):
    X, u, v = _batches(5, torch.float64, cuda, 12)
    with pytest.raises(ValueError):
        sk.hex8_force(X, u.cpu(), 1.0, 1.0)
    with pytest.raises(ValueError):
        sk.hex8_tangent(X, u, v.to(torch.float32), 1.0, 1.0)
    with pytest.raises(ValueError):
        sk.hex8_force(X.T.contiguous().T, u, 1.0, 1.0)  # not contiguous


def test_kernel_rejects_mixed_devices(cuda):
    _, _, field, G, wdet, _ = _inputs(SHAPES[0], torch.float64, cuda, 5)
    with pytest.raises(ValueError):
        lk.neo_force(field(1e-2), G.cpu(), wdet, 1.0, 1.0)


# the element route (plain PyTorch, no kernel): the same ops on the card
# and on the CPU
ROUTE_MATERIALS = {
    "neohooke": {"type": "neohooke", "youngs": 500.0, "nue": 0.3,
                 "density": 2.7},
    "elasthyper": {"type": "elasthyper", "density": 2.7, "summands": [
        {"type": "coupneohooke", "youngs": 500.0, "nue": 0.25}]},
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mname", list(ROUTE_MATERIALS))
@pytest.mark.parametrize("cell", ["hex8", "tet4", "wedge6"])
def test_element_route_on_the_card_matches_the_cpu(cuda, dtype, mname,
                                                   cell):
    from fourc_tpu_torch.core import gridgen
    from fourc_tpu_torch.materials import make_material

    disc = gridgen.box(3, 2, 2, cell=cell)
    rng = np.random.default_rng(21)
    conn = disc.blocks[cell].conn
    c = cells.get_cell(cell)
    X = disc.coords + rng.uniform(-0.05, 0.05, disc.coords.shape)
    mat = make_material(dict(ROUTE_MATERIALS[mname]))
    nodal = {"X": X, "u": rng.normal(size=X.shape) * 0.05,
             "v": rng.normal(size=X.shape)}
    out = {}
    for device, dt in ((cuda, dtype), ("cpu", torch.float64)):
        X64, u, v = (torch.as_tensor(nodal[k][conn].reshape(len(conn), -1).T
                                     .copy(), device=device)
                     for k in ("X", "u", "v"))
        G, wdet = (t.to(dt) for t in sops.element_geometry(X64, c))
        N = torch.as_tensor(c.N, dtype=dt, device=device)
        u, v = u.to(dt), v.to(dt)
        out[device] = (sops.element_force(G, wdet, u, mat),
                       sops.element_tangent(G, wdet, u, v, mat, 137.5, N))
    for got, want in zip(out[cuda], out["cpu"]):
        assert _rel(got.cpu().double(), want) <= TOL[dtype]


# slice 4c: D^2f (plain PyTorch on every device), block-Jacobi from B7's
# probes and one step of each new integrator, on the card against the CPU


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("model", ["neohooke", "svk"])
def test_force_hessian_on_the_card_matches_the_cpu(cuda, dtype, model):
    lam, mu = lame(500.0, 0.3)
    out = {}
    for device, dt in ((cuda, dtype), ("cpu", torch.float64)):
        spec, _, field, G, wdet, _ = _inputs(SHAPES[1], dt, device, 31)
        u, w, dv = field(5e-2), field(1e-2), field(1e-2)
        out[device] = lat.neo_force_hessian_at(u, w, G, wdet, lam, mu,
                                               model)(dv)
    assert _rel(out[cuda].cpu().double(), out["cpu"]) <= TOL[dtype]


def _slice4c_field(device, shape=(6, 4, 5), **changes):
    """A clamped 6 x 4 x 5 (or ``shape``) Neo-Hooke box under a sinusoidal
    shear traction, float64, with ``changes`` to its SolidParams."""
    from fourc_tpu_torch.core import conditions, functions, gridgen
    from fourc_tpu_torch.materials import make_material
    from fourc_tpu_torch.physics import solid as ps

    disc = gridgen.box(*shape)
    params = ps.SolidParams(dyntype="genalpha", precond="gmg",
                            genalpha=ps.GenAlphaParams(rho_inf=0.9))
    params.newton.tol_res = 1e-9
    for key, val in changes.items():
        setattr(params, key, val)
    fm = functions.FunctionManager()
    fm.add(1, "sin(50.0*t)")
    mat = make_material({"type": "neohooke", "youngs": 1.0e4, "nue": 0.3,
                         "density": 1.0})
    return ps.SolidField(
        disc, {1: mat}, params,
        dirichlet=[conditions.DirichletBC(disc.node_sets["zmin"], [1, 1, 1],
                                          [0, 0, 0])],
        neumann=[conditions.NeumannBC(disc.face_sets["zmax"], [1, 0, 0],
                                      [400.0, 0, 0], funct=[1, 0, 0])],
        functions=fm, device=device, dtype=torch.float64)


@pytest.mark.parametrize("kind", ["jacobi", "block_jacobi"])
def test_block_jacobi_from_b7_probes_matches_the_cpu(cuda, kind):
    out = {}
    rng = np.random.default_rng(41)
    ndof = 7 * 5 * 6 * 3
    u_np, r_np = rng.normal(size=ndof) * 0.05, rng.normal(size=ndof)
    for device in (cuda, "cpu"):
        f = _slice4c_field(device, precond=kind)
        u, r = (f.to_lattice(torch.as_tensor(x, device=device))
                for x in (u_np, r_np))
        sk.reset_launches()
        out[device] = f.build_preconditioner(u, 250.0)(r)
        if device == cuda:
            assert sk.launches["tangent"] == 24
    assert _rel(out[cuda].cpu(), out["cpu"]) <= TOL[torch.float64]


@pytest.mark.parametrize("case", ["statics", "onesteptheta", "explicit",
                                  "rayleigh_lumped", "block_jacobi"])
def test_slice4c_step_on_the_card_matches_the_cpu(cuda, case):
    from fourc_tpu_torch.physics import solid as ps

    changes = {"statics": {"dyntype": "statics"},
               "onesteptheta": {"dyntype": "onesteptheta", "theta": 0.66},
               "explicit": {"dyntype": "explicit", "mass": "lumped"},
               "rayleigh_lumped": {"rayleigh_alpha": 0.3,
                                   "rayleigh_beta": 0.002,
                                   "mass": "lumped"},
               "block_jacobi": {"precond": "block_jacobi"}}[case]
    dt = 1e-4 if case == "explicit" else 0.02
    out = {}
    for device in (cuda, "cpu"):
        f = _slice4c_field(device, **changes)
        state = ps.compute_initial_state(f, ps.init_state(f))
        step = ps.make_step(f, dt=dt)
        for _ in range(2):
            state, stats = step(state)
            assert stats["converged"]
        out[device] = state
    for k in ("d",) if case == "statics" else ("d", "v", "a"):  # v = a = 0
        assert _rel(out[cuda][k].cpu(), out["cpu"][k]) <= TOL[torch.float64]


# slice 4d: F-bar and EAS (plain PyTorch on every device), GMRES and
# BiCGStab, body forces, nodal stresses and D^2f off the uniform lattice,
# on the card against the CPU


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("tech", sops.TECHS)
def test_tech_on_the_card_matches_the_cpu(cuda, dtype, tech):
    from fourc_tpu_torch.core import gridgen
    from fourc_tpu_torch.materials import make_material

    disc = gridgen.box(3, 2, 2)
    rng = np.random.default_rng(23)
    conn = disc.blocks["hex8"].conn
    c = cells.get_cell("hex8")
    X = disc.coords + rng.uniform(-0.05, 0.05, disc.coords.shape)
    mat = make_material(dict(ROUTE_MATERIALS["neohooke"]))
    nodal = {"X": X, "u": rng.normal(size=X.shape) * 0.05,
             "v": rng.normal(size=X.shape)}
    out = {}
    for device, dt in ((cuda, dtype), ("cpu", torch.float64)):
        X64, u, v = (torch.as_tensor(nodal[k][conn].reshape(len(conn), -1).T
                                     .copy(), device=device)
                     for k in ("X", "u", "v"))
        G, wdet = (t.to(dt) for t in sops.element_geometry(X64, c))
        geo = (sops.origin_geometry(X64, c)[0] if tech == "fbar"
               else sops.eas_modes(X64, c)).to(dt)
        N = torch.as_tensor(c.N, dtype=dt, device=device)
        u, v = u.to(dt), v.to(dt)
        out[device] = (sops.tech_force(tech, G, wdet, geo, u, mat),
                       sops.tech_tangent(tech, G, wdet, geo, u, v, mat,
                                         137.5, N))
    for got, want in zip(out[cuda], out["cpu"]):
        assert _rel(got.cpu().double(), want) <= TOL[dtype]


@pytest.mark.parametrize("case", ["fbar_gmres", "eas_cg", "fbar_bicgstab",
                                  "k_damp_general_topology",
                                  "body_force"])
def test_slice4d_step_on_the_card_matches_the_cpu(cuda, case):
    """Two float64 steps of a 3 x 2 x 2 box of the slice-4c problem under a
    tech and a Krylov method (SA-AMG, general topology), with k_damp under
    linear kinematics, or with a body force; then the nodal stresses."""
    from fourc_tpu_torch.core.conditions import BodyForce
    from fourc_tpu_torch.physics import solid as ps

    tech, method = {"fbar_gmres": ("fbar", "gmres"),
                    "eas_cg": ("eas_mild", "cg"),
                    "fbar_bicgstab": ("fbar", "bicgstab")}.get(
                        case, ("none", "cg"))
    out = {}
    for device in (cuda, "cpu"):
        changes = {"tech": tech, "precond": "amg"}
        if case == "k_damp_general_topology":
            changes.update(rayleigh_alpha=0.3, rayleigh_beta=0.002,
                           kinem="linear")
        f = _slice4c_field(device, (3, 2, 2), **changes)
        f.params.newton.lin_method = method
        if case == "body_force":
            f = _slice4c_field(device, (3, 2, 2), precond="amg",
                               kinem="linear")
            f.body_forces = [BodyForce(val=[0.0, 30.0, -50.0],
                                       funct=[0, 1, 0])]
            f._body_data = [f._body_block(k) for k in f.block_mat]
        state = ps.compute_initial_state(f, ps.init_state(f))
        step = ps.make_step(f, dt=0.02)
        for _ in range(2):
            state, stats = step(state)
            assert stats["converged"]
        out[device] = (state["d"], state["v"], f.nodal_stresses(state["d"]))
    for got, want in zip(out[cuda], out["cpu"]):
        assert _rel(got.cpu(), want) <= TOL[torch.float64]


# slice 4f: the other plasticity laws, and the functions and sums that
# round alike on every device
PLASTICITY_LAWS = {
    "plasticdruckerprager": ({"youngs": 1000.0, "nue": 0.3,
                              "cohesion": 10.0, "eta": 0.4,
                              "isohard": 20.0}, None),
    "plasticlemaitre": ({"youngs": 1000.0, "nue": 0.3, "yield_stress": 10.0,
                         "isohard": 60.0, "s0": 0.02, "s_exp": 1.5}, None),
    "plasticgtn": ({"youngs": 1000.0, "nue": 0.3, "yield_stress": 12.0,
                    "isohard": 40.0, "f0": 0.02, "fn": 0.04, "en": 0.1,
                    "sn": 0.05}, None),
    "superelastic_sma": ({"youngs": 1000.0, "nue": 0.3, "eps_l": 0.05,
                          "s_as_s": 20.0, "s_as_f": 30.0, "s_sa_s": 15.0,
                          "s_sa_f": 8.0}, None),
    "robinson": ({"youngs": 1000.0, "nue": 0.3, "k0": 5.0, "hard": 50.0,
                  "recov": 0.1}, 0.5),
    "viscoplastic_perzyna": ({"youngs": 1000.0, "nue": 0.3,
                              "yield_stress": 5.0, "eta": 2.0,
                              "m_exp": 1.5}, 0.5),
    "crystal_plasticity": ({"youngs": 1000.0, "nue": 0.3, "g0": 4.0,
                            "gdot0": 1e-2, "rate_m": 0.2, "h0": 10.0,
                            "g_sat": 12.0}, 0.25),
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", list(PLASTICITY_LAWS))
def test_plasticity_law_on_the_card_is_the_cpus_bitwise(cuda, dtype, name):
    """Stress, new history and the stress's forward derivative of one
    seeded batch: in float64 the card's bits are the CPU's (the laws add,
    multiply, divide by tensors and take ``sqrt_rn`` and the ``*_ieee``
    functions only; the float64 decks rely on it), in float32 within the
    float32 tolerance."""
    from fourc_tpu_torch.materials import make_material

    params, dt = PLASTICITY_LAWS[name]
    mat = make_material({"type": name, **params})
    nh = mat.history_shape[0]
    rng = np.random.default_rng(9)
    n = 600
    H = rng.normal(size=(3, 3, n)) * np.geomspace(1e-4, 0.08, n)
    if name == "crystal_plasticity":
        F = np.eye(3)[:, :, None] + H
        arg = np.einsum("kin,kjn->ijn", F, F)
        h = np.tile(np.r_[np.eye(3).reshape(9), 4.0][:, None], (1, n))
        h[:9, n // 2:] += rng.normal(size=(9, n - n // 2)) * 0.01
    else:
        arg = 0.5 * (H + H.transpose(1, 0, 2))
        h = rng.normal(size=(nh, n)) * 1e-3
        h[9:] = np.abs(h[9:]) * 10.0
    darg = rng.normal(size=arg.shape)
    darg = 0.5 * (darg + darg.transpose(1, 0, 2))
    out = {}
    for device in ("cpu", cuda):
        def t(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        fn = (mat.evaluate if name == "crystal_plasticity"
              else mat.evaluate_small)
        (s, hn), (ds, _) = torch.func.jvp(lambda x: fn(x, t(h), dt),
                                          (t(arg),), (t(darg),))
        out[device] = [x.cpu() for x in (s, hn, ds)]
    for got, want in zip(out[cuda], out["cpu"]):
        assert torch.isfinite(want).all()
        if dtype == torch.float64:
            assert torch.equal(got, want)
        else:
            assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ieee_functions_and_tree_sums_are_the_cpus_bitwise(cuda, dtype):
    """exp, cosh, sinh, log, pow and the fixed-order sums and norm of
    GMRES give the CPU's bits on the card; so does a GMRES solve with an
    elementwise operator."""
    from fourc_tpu_torch.linalg import solvers
    from fourc_tpu_torch.ops import common as gm

    rng = np.random.default_rng(2)
    x = rng.uniform(-60.0, 60.0, size=100_003)
    pos = np.exp(rng.uniform(-80.0, 80.0, size=100_003))
    V = rng.normal(size=(7, 100_003))
    out = {}
    for device in ("cpu", cuda):
        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        diag = t(np.linspace(2.0, 5.0, V.shape[1]))

        def op(v):
            return diag * v + 0.5 * (torch.roll(v, 1) + torch.roll(v, -1))

        res = solvers.gmres(op, t(V[0]), tol=1e-6 if dtype == torch.float32
                            else 1e-12, restart=20)
        vals = [gm.exp_ieee(t(x)), *gm.cosh_sinh_ieee(t(x)),
                gm.log_ieee(t(pos)), gm.pow_ieee(t(pos[:1000] * 0 + 2.5),
                                                 1.7),
                gm.pow_ieee(t(x), 5.0), solvers.tree_sum(t(V), 1),
                solvers.tree_sum(t(V), 0), solvers.norm_rn(t(V)), res.x]
        out[device] = [v.cpu() for v in vals] + [res.iters]
    for got, want in zip(out[cuda], out["cpu"]):
        assert (torch.equal(got, want) if torch.is_tensor(want)
                else got == want)


# slice 4g: the growth, mixture and muscle laws; law -> (parameters, the
# step's dt, whether the CPU's bits are the card's: the laws whose stress
# takes torch.log1p (NeoHooke's and ElastHyper's closed forms) round it
# the card's way)
BIOLOGY_LAWS = {
    "growth_iso": ({"youngs": 100.0, "nue": 0.3, "k_growth": 0.5,
                    "m_target": 1.0}, 0.5, False),
    "muscle_active": ({"youngs": 200.0, "nue": 0.3, "smax": 30.0,
                       "tau": 0.75, "fiber": [1.0, 0.2, 0.0]}, 0.25, False),
    "growthremodel_cm": ({"youngs_elastin": 80.0, "nue": 0.3,
                          "k_fiber": 40.0, "sigma_h": 5.0, "k_sigma": 0.4,
                          "k_remodel": 0.4, "prestretch": 1.05}, 0.5, True),
    "mixture_rule": ({"rule": "growthremodel", "constituents": [
        {"kind": "solid", "frac": 0.4, "prestretch": [1.05, 1.0, 1.0],
         "material": {"type": "elasthyper", "summands": [
             {"type": "couplogneohooke", "youngs": 60.0, "nue": 0.3}]}},
        {"kind": "remodelfiber", "frac": 0.3, "k1": 20.0, "k2": 1.5,
         "a": [1.0, 0.3, 0.0], "lambda_pre": 1.08, "k_sig": 0.5,
         "decay_time": 4.0, "impl": True},
        {"kind": "remodelfiber", "frac": 0.3, "k1": 20.0, "k2": 1.5,
         "a": [1.0, -0.3, 0.0], "lambda_pre": 1.08, "k_sig": 0.5,
         "decay_time": 4.0}]}, 0.5, False),
    "muscle_blemker": ({"g1": 0.5, "g2": 0.5, "p1": 0.05, "p2": 6.6,
                        "sigma_max": 40.0, "lambda_ofl": 1.2,
                        "lambda_star": 1.4, "alpha": 1.0, "beta": 2.0,
                        "t_act_start": 0.3, "youngs": 200.0, "nue": 0.3},
                       0.25, True),
    "anisoactivestress": ({"youngs": 150.0, "nue": 0.3, "sigma0": 20.0,
                           "u_expr": "4*(t <= 0.5) - 4*(t > 0.5)",
                           "lambda_lower": 0.9, "lambda_upper": 1.2},
                          0.125, True),
}


@pytest.mark.parametrize("name", list(BIOLOGY_LAWS))
def test_biology_law_on_the_card_matches_the_cpu(cuda, name):
    """Stress, new history and the stress's forward derivative of one
    seeded float64 batch (C = I on a tenth of it): the card's bits are the
    CPU's where the law takes only additions, products, divisions by
    tensors, ``sqrt_rn`` and the ``*_ieee`` functions, else within
    1e-13."""
    from fourc_tpu_torch.materials import make_material

    params, dt, bitwise = BIOLOGY_LAWS[name]
    mat = make_material({"type": name, **params})
    rng = np.random.default_rng(11)
    n = 600
    F = np.eye(3)[:, :, None] + rng.normal(size=(3, 3, n)) * np.geomspace(
        1e-3, 0.3, n)
    F[:, :, : n // 10] = np.eye(3)[:, :, None]
    C = np.einsum("kin,kjn->ijn", F, F)
    h0 = mat.init_history(n).numpy().T
    h = np.where(h0 == 0.0, rng.uniform(0.0, 1.0, size=h0.shape),
                 h0 * rng.uniform(0.8, 1.2, size=h0.shape))
    dC = rng.normal(size=C.shape)
    dC = 0.5 * (dC + dC.transpose(1, 0, 2))
    out = {}
    for device in ("cpu", cuda):
        def t(x):
            return torch.as_tensor(x, dtype=torch.float64, device=device)

        (s, hn), (ds, _) = torch.func.jvp(
            lambda x: mat.evaluate(x, t(h), dt), (t(C),), (t(dC),))
        out[device] = [x.cpu() for x in (s, hn, ds)]
    for got, want in zip(out[cuda], out["cpu"]):
        assert torch.isfinite(want).all()
        if bitwise:
            assert torch.equal(got, want)
        else:
            assert _rel(got, want) <= 1e-13


# slice 5a: deck -> (anchors met, anchors, the reference CLI's Newton
# iterations; 4C's form's for the MULF decks), as tests/port/test_torch_deck.py
FIELD_DECKS = {"decks/ref_converted/thermo_bar_dbc_genalpha.yaml": (3, 3, 100),
               "decks/thermo_fin_cooling.yaml": (2, 2, 97),
               "decks/ref_converted/scatra_3d_straight_convection.yaml":
                   (2, 2, 1),
               "decks/tsi_heated_bar.yaml": (3, 3, 70),
               "decks/tsi_partitioned_bar.yaml": (3, 3, 2044),
               "decks/ref_converted/solid_ele_hex8_standard_mulf.yaml":
                   (12, 12, 42),
               "decks/mulf_prestress.yaml": (0, 3, 0),
               # slice 6a: the fluid, ALE and 2D scatra decks (the port's
               # Newton iterations, tests/port/test_torch_deck.py)
               "decks/fluid_cavity_stationary.yaml": (3, 3, 12),
               "decks/fluid_poiseuille_ost.yaml": (3, 3, 134),
               "decks/fluid_smagorinsky_decay.yaml": (3, 3, 18),
               "decks/fluid_mfs_decay.yaml": (3, 3, 33),
               "decks/windkessel_channel.yaml": (2, 2, 144),
               "decks/ale_patch_motion.yaml": (3, 3, 0),
               "decks/scatra_supg_skewflow.yaml": (2, 2, 6),
               "decks/scatra_gaussian_diffusion.yaml": (2, 2, 48),
               "decks/scatra_anisotropic_diffusion.yaml": (1, 1, 30)}


def _states(run):
    """Every tensor of a state after every step (the history's by block)."""
    out = []

    def cb(_, st, __):
        row = {}
        for k, v in st.items():
            if torch.is_tensor(v):
                row[k] = v.detach().cpu().clone()
            elif isinstance(v, dict):
                row.update({f"{k} {kk}": vv.detach().cpu().clone()
                            for kk, vv in v.items()})
        out.append(row)

    return out, cb


@pytest.mark.parametrize("path", list(FIELD_DECKS))
def test_field_deck_on_the_card_matches_the_cpu(cuda, path):
    """The seven decks of slice 5a and the nine of slice 6a: the card's
    state after every step within 1e-11 of the CPU run's largest entry,
    the anchors and the Newton iterations of FIELD_DECKS on both."""
    import os

    from fourc_tpu_torch.io.result_test import run_result_tests
    from fourc_tpu_torch.physics import driver

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    met, n, newton = FIELD_DECKS[path]
    runs = {}
    for device in ("cuda", "cpu"):
        states, cb = _states(None)
        res = driver.run(os.path.join(root, path), callbacks=[cb],
                         device=device)
        runs[device] = states
        tests = run_result_tests(res.deck.result_tests, res)
        assert sum(t.ok for t in tests) == met and len(tests) == n
        assert res.stats[next(iter(res.stats))]["newton_iters"] == newton
    assert len(runs["cuda"]) == len(runs["cpu"])
    for k in runs["cpu"][0]:
        scale = max(float(c[k].abs().max()) for c in runs["cpu"]) or 1.0
        for g, c in zip(runs["cuda"], runs["cpu"]):
            assert float((g[k] - c[k]).abs().max()) / scale <= 1e-11, k


def test_tsi_permuted_converges_and_launches_b6(cuda):
    """tsi_permuted at n=12 (chip_smoke phase 15 (b)): two monolithic steps
    converge in float32, the temperatures rise, B6 carries the mass (and
    no other kernel runs)."""
    import chip_smoke as c

    from fourc_tpu_torch.physics import tsi_driver as td

    f = c.tsi_problem(12, "cuda", torch.float32)
    state = td.init_state(f)
    step = td.make_step(f, c.TSI_DT)
    lk.reset_launches()
    sk.reset_launches()
    for _ in range(2):
        state, stats = step(state)
        assert stats["converged"]
    assert sk.launches["force"] > 0 and sk.launches["tangent"] == 0
    assert not any(lk.launches.values())
    assert float((state["T"] - c.TSI_LAW["inittemp"]).max()) > 0
    assert torch.isfinite(state["d"]).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fluid_residual_and_jacobian_on_the_card_match_the_cpu(cuda, dtype):
    """The fluid residual and its Jacobian action on a 4x4x4 hex8 box
    (cavity3d_ost's field, a random state): the card's are the CPU's
    (float64 to 1e-13 of the largest entry, float32 to 1e-5)."""
    import chip_smoke as c

    from fourc_tpu_torch.physics import fluid as pf

    out = {}
    for device in (cuda, "cpu"):
        f = c.cavity3d_problem(4, device, dtype)
        gen = torch.Generator().manual_seed(0)
        x, xdot, v = (torch.randn(f.ndof, generator=gen, dtype=dtype)
                      .to(device) for _ in range(3))
        r, apply = f.linearize(x, xdot, 0.1, dt=c.CAVITY_DT)
        out[device] = [t.cpu() for t in (
            r, apply(v, pf.zero_pressure_rate(f, v * 100.0)))]
    for got, want in zip(out[cuda], out["cpu"]):
        assert _rel(got, want) <= (1e-13 if dtype == torch.float64 else 1e-5)


def test_cavity3d_ost_converges_on_the_card(cuda):
    """cavity3d_ost at n=12 (chip_smoke phase 16 (b)): three float32
    one-step-theta steps converge (Newton under its cap, no GMRES solve at
    maxiter), the velocity stays bounded by the lid's and no kernel of
    B1-B7 runs."""
    import chip_smoke as c

    from fourc_tpu_torch.physics import fluid as pf

    f = c.cavity3d_problem(12, cuda, torch.float32)
    state = pf.init_state(f)
    step = pf.make_step(f, c.CAVITY_DT)
    lk.reset_launches()
    sk.reset_launches()
    calls = []
    with c._gmres_calls(calls):
        for _ in range(3):
            state, stats = step(state)
            assert stats["converged"]
            assert stats["iters"] < f.params.newton.max_iter
    assert all(ok and it < f.params.newton.lin_maxiter for it, ok in calls)
    u, _ = f.split(state["x"])
    assert torch.isfinite(state["x"]).all()
    assert 0.0 < float(u.abs().max()) <= 1.0 + 1e-6
    assert not any(lk.launches.values()) and not any(sk.launches.values())
