"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
device given and no CUDA available they raise instead of quietly running on
the CPU (tests pass `device="cpu"` explicitly).
"""

from __future__ import annotations

import numpy as np
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


def upload(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A host array or a tensor as `dtype` on `device`. Host arrays bound
    for a card go through pinned memory, so the copy does not make the host
    wait for the work already queued on the stream."""
    if torch.is_tensor(a):
        return a.to(device, dtype)
    t = torch.from_numpy(np.require(a, requirements=("C", "W"))).to(dtype)
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)
