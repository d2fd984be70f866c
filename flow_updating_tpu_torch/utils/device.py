"""Device selection for the port's entry points.

Every entry point (``NodeKernel``, ``Engine``, the CLI) runs on the CUDA
card unless its caller asks for the CPU.  Without a card that request
has to be explicit: :func:`resolve_device` raises instead of quietly
running the plain tensor code on the host.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card (``cuda``); anything else is taken as
    given.  A CUDA device without an available card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default — pass device='cpu' (CLI: --device cpu) to run the "
            "plain tensor versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (use 'cuda' or 'cpu')")
    return dev
