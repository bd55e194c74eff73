"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. A CUDA request without a usable GPU raises — the port never
    carries on on the CPU behind the caller's back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    if dev.type == "cuda" and dev.index is None:
        # tensors report cuda:N; compare like with like
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
