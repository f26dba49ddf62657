"""Material library: the laws the ported problems use."""

from fourc_tpu_torch.materials import (elastic, elasthyper,  # noqa: F401
                                       plasticity, small_strain,
                                       viscoelastic)
from fourc_tpu_torch.materials.base import (MATERIAL_REGISTRY,  # noqa: F401
                                            HistoryMaterial, Material,
                                            make_material)
