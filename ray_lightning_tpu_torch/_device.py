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
    explicit ``"cpu"`` is always honoured (the CPU tests pass it), and
    so is ``"meta"`` (a module made without storage, whose parameters
    are then pointed at existing tensors: the speculative draft)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def worker_device(use_gpu: bool, local_rank: int, cpu_threads: float,
                  owner: str, cpu_hint: str) -> torch.device:
    """An actor's device (``RayPlugin``'s and ``Server``'s workers): its
    local GPU ``local_rank``, made current, or the CPU with
    ``cpu_threads`` torch threads.  A GPU worker without CUDA, or
    without a card of its own, raises naming ``owner`` (and
    ``cpu_hint``, the way to ask for CPU workers): it never falls back
    to the CPU."""
    if not use_gpu:
        torch.set_num_threads(max(1, int(cpu_threads)))
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{owner}: CUDA is not available in this worker; pass "
            f"{cpu_hint} for CPU workers")
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(
            f"local rank {local_rank} but this worker sees "
            f"{torch.cuda.device_count()} GPUs")
    device = torch.device("cuda", local_rank)
    torch.cuda.set_device(device)
    return device


__all__ = ["resolve_device", "worker_device"]
