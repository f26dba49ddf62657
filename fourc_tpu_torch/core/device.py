"""The device an entry point runs on.

The port's entry points (``SolidField``, ``StructuredGMG``; objects built
from a field, such as ``gmg.build_for_solid``'s hierarchy, take its device)
run on the CUDA card unless the caller asks for the CPU, where the kernel
wrappers take their plain PyTorch twins.  There is
no silent fallback: asking for CUDA without a CUDA device raises.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU with the "
            "kernels' plain PyTorch twins")
    return dev
