"""gl_slam_tpu_torch — the PyTorch/CUDA port of gl_slam_tpu.

A second package beside the JAX reference: the same chunked learned tracker
(`slam/chunk_driver.ChunkedPipeline`), per-frame pipeline
(`slam/pipeline.TrackingPipeline`) and front-end trainers
(`train/frontend_train.py`), written in PyTorch, with the Pallas
kernels (fused masked attention, fused dual-softmax assignment, NMS)
rewritten by hand in CUDA C++ for Hopper (`csrc/`). Module paths mirror the
JAX package so each counterpart is easy to find. The package imports
nothing of `gl_slam_tpu` and no JAX.
"""

from .config import SLAMConfig, default_config, tiny_test_config
from .device import resolve_device

__version__ = "0.1.0"
__all__ = ["SLAMConfig", "default_config", "tiny_test_config",
           "resolve_device"]
