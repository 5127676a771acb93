"""Device policy: the GPU unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a GPU raises rather
    than running on the CPU; ``"cpu"`` selects the plain torch versions of
    the kernels (what the CPU tests use)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on the GPU by default and no "
                           "CUDA device is available; pass device='cpu' to "
                           "run the plain torch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
