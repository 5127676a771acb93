"""PyTorch/CUDA port of the adaptive-pushdown engine (``repro``).

The data plane runs on device tensors; the filter and aggregation work of
the pushed plans and of the residual group-bys runs through hand-written
CUDA kernels (``repro_torch.kernels``). Entry points run on the GPU unless
the caller passes ``device="cpu"``, which selects the kernels' plain torch
versions.
"""
from repro_torch.device import resolve_device  # noqa: F401
