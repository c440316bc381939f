"""Device selection for the port's entry points.

Entry points take a ``device`` and default to ``"cuda"``. A CUDA device
with no GPU present raises: the port never carries on on the CPU unless
the caller asks for it (the CPU tests pass ``device="cpu"``).
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA GPU is available; "
            f"pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
