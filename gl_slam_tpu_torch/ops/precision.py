"""Full-f32 arithmetic for the geometry and solver path.

The JAX package wraps its geometry entry points in
`jax.default_matmul_precision("float32")` because the TPU's default f32
matmul runs in bf16 (gl_slam_tpu/ops/precision.py). The card's counterpart
is TF32: PyTorch leaves f32 matmuls in full f32 by default, but cuDNN runs
f32 convolutions in TF32 (about three decimal digits) unless told not to.
Pixel-scale and metre-scale geometry must not lose those digits, so the port
switches TF32 off for both, explicitly, when an entry point selects a CUDA
device (`device.resolve_device` calls `set_full_f32`). The models keep their
own dtype (bf16 on the card), which TF32 does not touch.
"""

from __future__ import annotations

import torch


def set_full_f32() -> None:
    """Disable TF32 for f32 matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
