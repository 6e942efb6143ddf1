"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
device given and no CUDA available they raise instead of quietly running on
the CPU (tests pass `device="cpu"` explicitly).
"""

from __future__ import annotations

import torch

from .ops.precision import set_full_f32


def resolve_device(device=None) -> torch.device:
    """`None` -> the CUDA device (raises when there is none); otherwise
    `torch.device(device)`. Selecting a CUDA device also switches TF32 off
    for matmuls and convolutions (ops/precision.py)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "port on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        set_full_f32()
    return dev
