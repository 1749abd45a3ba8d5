"""Device resolution for every entry point: the card unless told otherwise.

The port runs on ``cuda`` by default.  ``device="cpu"`` is an explicit
request (the CPU tests make it); with no card and no explicit CPU device
an entry point raises instead of quietly running somewhere slower.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "stark_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

