"""Device selection for the port's entry points.

The port runs on CUDA unless the caller asks for the CPU. A request for
CUDA on a machine without a CUDA device is an error, never a silent move
to the CPU: every number the port reports names the device it ran on.
"""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """torch.device for a config's `device` key; raises when CUDA is asked
    for and absent."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={name!r} was requested but torch.cuda.is_available() "
            "is False; pass device='cpu' (INI key `device = cpu` or "
            "--device=cpu) to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    return device
