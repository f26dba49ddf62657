"""Slice 6a: ALE mesh motion on the CPU in float64.

``AleField.solve`` is held against the JAX package's from a random
interface displacement (one call each, its CG compiled once): ``laplace``
on a jittered 4x4 rectangle and a 3x3x3 box, ``elastic`` on the box, at
1e-10 of the largest displacement.  On the port alone: the linear patch
test of tests/test_ale_driver.py with both methods (a linear motion of the
boundary is reproduced in the interior), the ALE deck's refusals and its
state converter.
"""

import numpy as np
import pytest
import torch
import yaml

from fourc_tpu_torch import convert
from fourc_tpu_torch.core import gridgen
from fourc_tpu_torch.io import deck as deck_mod
from fourc_tpu_torch.physics import driver
from fourc_tpu_torch.physics.ale import AleField

SOLVE_TOL = 1e-10


def _mesh(kind):
    rng = np.random.default_rng(7)
    if kind == "rectangle":
        d = gridgen.rectangle(4, 4, name="ale")
        X = d.coords
        interior = ((X > 1e-12) & (X < 1 - 1e-12)).all(axis=1)
        d.coords = X + interior[:, None] * rng.uniform(-0.05, 0.05, X.shape)
    else:
        d = gridgen.box(3, 3, 3, name="ale")
    X = d.coords
    lo, hi = X.min(axis=0), X.max(axis=0)
    boundary = np.nonzero(((X < lo + 1e-12) | (X > hi - 1e-12))
                          .any(axis=1))[0]
    disp = 0.05 * rng.normal(size=(len(boundary), d.dim))
    return d, boundary, disp


@pytest.mark.parametrize("kind,method", [("rectangle", "laplace"),
                                         ("box", "laplace"),
                                         ("box", "elastic")])
def test_solve_matches_reference(kind, method):
    import jax.numpy as jnp
    from fourc_tpu.physics.ale import AleField as JAleField

    from fourc_tpu.core import gridgen as jgridgen

    d, boundary, disp = _mesh(kind)
    jd = (jgridgen.rectangle(4, 4, name="ale") if kind == "rectangle"
          else jgridgen.box(3, 3, 3, name="ale"))
    jd.coords = d.coords
    want = np.asarray(JAleField(jd, boundary, np.zeros(0, np.int32),
                                method=method).solve(
        jnp.asarray(disp), tol=1e-13, maxiter=500))
    f = AleField(d, boundary, (), method=method, device="cpu")
    got = f.solve(torch.as_tensor(disp), tol=1e-13, maxiter=500).numpy()
    assert np.abs(got - want).max() <= SOLVE_TOL * np.abs(want).max()
    assert f.last_iters > 0


def test_elastic_on_a_2d_mesh_is_refused_by_name():
    d, boundary, _ = _mesh("rectangle")
    with pytest.raises(NotImplementedError, match="'elastic' on a 2D mesh"):
        AleField(d, boundary, (), method="elastic", device="cpu")


# the linear patch test of tests/test_ale_driver.py
DECK = """
problem: {type: ale}
ale_dynamic:
  method: %(method)s
  timestep: 0.5
  numstep: 2
  tolres: 1e-12
  maxiter: 600
functions:
  1: "t*(0.08*x + 0.02*y)"
geometry:
  generator: {kind: box, nx: 3, ny: 3, nz: 3, cell: hex8, mat: 1, name: ale}
materials:
  1: {type: stvenantkirchhoff, youngs: 1.0, nue: 0.0, density: 1.0}
conditions:
  dirichlet:
    - {nodes: xmin, onoff: [1, 1, 1], val: [1, 0, 0], funct: [1, 0, 0]}
    - {nodes: xmax, onoff: [1, 1, 1], val: [1, 0, 0], funct: [1, 0, 0]}
    - {nodes: ymin, onoff: [1, 1, 1], val: [1, 0, 0], funct: [1, 0, 0]}
    - {nodes: ymax, onoff: [1, 1, 1], val: [1, 0, 0], funct: [1, 0, 0]}
    - {nodes: zmin, onoff: [1, 1, 1], val: [1, 0, 0], funct: [1, 0, 0]}
    - {nodes: zmax, onoff: [1, 1, 1], val: [1, 0, 0], funct: [1, 0, 0]}
"""


@pytest.mark.parametrize("method", ["laplace", "elastic"])
def test_ale_linear_patch(method):
    """A linear boundary motion is reproduced in the interior by both
    smoothers (a linear field is harmonic, and its constant strain leaves
    no elastic residual on the uniform mesh)."""
    res = driver.run(DECK % {"method": method}, device="cpu")
    d = res.states["ale"]["d"].numpy()
    X = res.fields["ale"].f.disc.coords
    want = 1.0 * (0.08 * X[:, 0] + 0.02 * X[:, 1])  # t = 1.0
    assert np.abs(d[:, 0] - want).max() < 1e-7
    assert np.abs(d[:, 1:]).max() < 1e-8
    v = res.states["ale"]["v"].numpy()
    assert np.abs(v[:, 0] - want).max() < 1e-7  # the ramp's rate


def test_ale_requires_full_onoff():
    bad = (DECK % {"method": "laplace"}).replace("onoff: [1, 1, 1]",
                                                 "onoff: [1, 0, 0]")
    with pytest.raises(ValueError, match="all mesh-displacement"):
        driver.run(bad, device="cpu")


def test_elastic_ale_deck_in_2d_is_refused_before_the_field():
    data = yaml.safe_load(DECK % {"method": "elastic"})
    data["geometry"]["generator"] = {"kind": "rectangle", "nx": 3, "ny": 3,
                                     "cell": "quad4", "mat": 1,
                                     "name": "ale"}
    data["conditions"]["dirichlet"] = [
        {"nodes": s, "onoff": [1, 1], "val": [1, 0], "funct": [1, 0]}
        for s in ("xmin", "xmax", "ymin", "ymax")]
    with pytest.raises(NotImplementedError,
                       match="ALE method 'elastic' on a 2D mesh"):
        driver.run(deck_mod.load(data), device="cpu")


def test_ale_state_from_jax():
    rng = np.random.default_rng(0)
    st = {"d": rng.normal(size=(5, 2)), "v": rng.normal(size=(5, 2)),
          "t": np.asarray(0.4), "step": np.asarray(2)}
    out = convert.ale_state_from_jax(st)
    np.testing.assert_array_equal(out["d"], st["d"])
    np.testing.assert_array_equal(out["v"], st["v"])
    assert (out["t"], out["step"]) == (0.4, 2)
