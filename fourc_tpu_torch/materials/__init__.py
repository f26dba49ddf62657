"""Material library: the laws the lattice slice uses."""

from fourc_tpu_torch.materials import elastic, small_strain  # noqa: F401
from fourc_tpu_torch.materials.base import (MATERIAL_REGISTRY,  # noqa: F401
                                            Material, make_material)
