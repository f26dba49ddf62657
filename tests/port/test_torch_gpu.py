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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_stencil_kernel_matches_twin(cuda, dtype, shape):
    _, t, field, *_ = _inputs(shape, dtype, cuda, 1)
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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mcoef", [0.0, 137.5])
def test_tangent_kernel_matches_twin(cuda, dtype, shape, mcoef):
    _, _, field, G, wdet, N = _inputs(shape, dtype, cuda, 4)
    lam, mu = lame(500.0, 0.3)
    u, v = field(1e-2), field(1.0)
    got = lk.neo_tangent(u, v, G, wdet, N, lam, mu, "neohooke", mcoef)
    want = lat.neo_jvp_ref(u, v, G, wdet, lam, mu, "neohooke", N=N,
                           mcoef=mcoef)
    assert _rel(got, want) <= TOL[dtype]


def test_kernel_rejects_mixed_devices(cuda):
    _, _, field, G, wdet, _ = _inputs(SHAPES[0], torch.float64, cuda, 5)
    with pytest.raises(ValueError):
        lk.neo_force(field(1e-2), G.cpu(), wdet, 1.0, 1.0)
