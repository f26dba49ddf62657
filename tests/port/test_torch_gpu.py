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
                                          ("neohooke", 137.5), ("svk", 0.0)])
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
