"""Material library: the laws the ported problems use."""

from fourc_tpu_torch.materials import (elastic, elasthyper,  # noqa: F401
                                       fluid, growth, mixture, muscle,
                                       plasticity, scatra, small_strain,
                                       thermal, viscoelastic)
from fourc_tpu_torch.materials.base import (MATERIAL_REGISTRY,  # noqa: F401
                                            HistoryMaterial, Material,
                                            elastic_moduli, make_material)
