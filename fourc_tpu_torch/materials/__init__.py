"""Material library: the laws the ported problems use."""

from fourc_tpu_torch.materials import (elastic, elasthyper,  # noqa: F401
                                       small_strain)
from fourc_tpu_torch.materials.base import (MATERIAL_REGISTRY,  # noqa: F401
                                            Material, make_material)
