"""Device choice and float32 policy shared by every entry point."""
from __future__ import annotations

import torch


def full_fp32() -> None:
    """True float32 products everywhere: no TF32 in matmuls or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Without CUDA only an explicit ``"cpu"`` is
    accepted: an entry point never drops to the CPU on its own."""
    full_fp32()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
