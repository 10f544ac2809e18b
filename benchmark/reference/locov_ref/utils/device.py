"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: entry points run on ``cuda`` unless the
    caller asks for the CPU. A CUDA device without a GPU present raises;
    there is no fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def is_amax_key(key: str) -> bool:
    """Whether a ``state_dict`` key is a calibrated max-abs buffer of the
    static int8 scheme."""
    return key.endswith(("_amax.amax", "pooled_amax", "roialign_amax"))
