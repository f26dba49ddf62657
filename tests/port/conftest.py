"""Port tests: one torch thread per worker (the suite runs under xdist).

The repository's tests/conftest.py already pins JAX to the CPU with x64,
which is how the JAX side of every comparison here runs.
"""

import torch

torch.set_num_threads(1)
