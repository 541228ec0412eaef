"""Device resolution shared by the port's entry points.

Every entry point (``ServeEngine``, ``GPT`` construction through the
engine, the kernel wrappers' callers) runs on the card unless the caller
asks for the CPU: ``device=None`` means ``"cuda"``, and a machine
without CUDA raises instead of quietly running the plain versions.
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; a CUDA request without CUDA raises; an
    explicit ``"cpu"`` is always honoured (the CPU tests pass it)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


__all__ = ["resolve_device"]
