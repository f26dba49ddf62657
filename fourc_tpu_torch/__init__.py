"""PyTorch/CUDA port of fourc_tpu for NVIDIA Hopper.

The JAX package ``fourc_tpu`` is the reference; every module here keeps its
counterpart's name (``fourc_tpu_torch/ops/lattice.py`` <->
``fourc_tpu/ops/lattice.py``).  This package imports torch and numpy only.

Slice 1 covers the flagship problem: a uniform hex8 Neo-Hooke box, gen-alpha
in time, Newton-Krylov with CG and a geometric-multigrid preconditioner, all
in the padded lattice layout.  The three lattice kernels are hand-written
CUDA (``csrc/``), bound with ctypes in ``ops/lattice_kernels.py``.
Slices 2 and 3 add general geometry and general topology (four more
kernels); slice 4b adds tet4 and wedge6 cells, ElastHyper, several blocks,
the direct solve and the plain PyTorch element route for the blocks that
no kernel carries.  Decks run through ``python -m fourc_tpu_torch.app.main <deck.yaml>``
(``io/deck.py`` -> ``physics/driver.py`` -> ``physics/structure_driver.py``).
"""
