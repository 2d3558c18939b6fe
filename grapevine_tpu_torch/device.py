"""Device resolution for the port's entry points.

Entry points take ``device=None``, which means the CUDA card. Without a
CUDA device they raise: the port never drops to the CPU silently. The
CPU runs only where a caller asks for it (``device="cpu"``), as the
tests do, and then every kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raises when a CUDA device is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
