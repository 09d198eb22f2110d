"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card; a named device is taken as given.

    Entry points run on the card unless the caller asks for another
    device (the CPU tests pass ``device="cpu"``). Without a card and
    without a named device this raises: the port never falls back to
    the CPU in silence."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (CLI: "
                "--device cpu) to run the plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
