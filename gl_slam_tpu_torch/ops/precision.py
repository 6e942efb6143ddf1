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

import functools

import torch


def set_full_f32() -> None:
    """Disable TF32 for f32 matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def f32(fn):
    """Decorator: run `fn` with TF32 off for matmuls and convolutions (the
    counterpart of the JAX decorator that traces under full-float32 matmul
    precision), restoring the previous settings after. The port's entry
    points switch TF32 off for the whole process when they select the card,
    so this is for code that runs outside them. Sets `__f32_precision__`
    on the wrapper, as the JAX decorator does."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32,
                 torch.get_float32_matmul_precision())
        set_full_f32()
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved[0]
            torch.backends.cudnn.allow_tf32 = saved[1]
            torch.set_float32_matmul_precision(saved[2])
    wrapped.__f32_precision__ = True
    return wrapped
