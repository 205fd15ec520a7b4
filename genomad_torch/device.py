"""Device selection for the port's entry points.

Entry points run on the card. The CPU is used only when the caller asks for
it (``device="cpu"``), and then every kernel is replaced by its plain PyTorch
version. A run that asks for no device on a machine without CUDA raises
instead of quietly falling back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when the resolved device is CUDA and no
    card is present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available. genomad_torch runs on an NVIDIA GPU; pass "
            "device='cpu' explicitly to run the plain PyTorch path."
        )
    return device


def disable_tf32() -> None:
    """f32 parity runs: make float32 matmuls and convolutions full float32
    (the analog of the Precision.HIGHEST the JAX kernels force)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
