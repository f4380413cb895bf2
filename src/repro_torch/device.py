"""Where the port's entry points run: on ``cuda`` unless the caller asks
for another device. Without a card and without a device they raise;
they never fall back to the CPU on their own."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
