"""The port stands alone and runs on the card unless told otherwise.

gl_slam_tpu_torch/ and chip_smoke.py must import no JAX, no Flax and
nothing of the JAX package (the card's machine has neither), and the
port's entry points must refuse to fall back to the CPU silently.
"""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gl_slam_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "gl_slam_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_scan_sees_the_package():
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    assert "chip_smoke.py" in names
    assert os.path.join("gl_slam_tpu_torch", "slam", "fused.py") in names


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_cuda(no_cuda):
    from gl_slam_tpu_torch.device import resolve_device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_entry_points_default_to_the_card(no_cuda):
    from gl_slam_tpu_torch.config import micro_config
    from gl_slam_tpu_torch.slam.chunk_driver import ChunkedPipeline
    from gl_slam_tpu_torch.train import e2e
    with pytest.raises(RuntimeError, match="no CUDA device"):
        e2e.load_tiny_frontend(os.path.join(ROOT, "checkpoints"))
    cfg = micro_config(48, 64, 32, 64)
    cfg = cfg.replace(runtime=dataclasses.replace(
        cfg.runtime, run_full_ba=False, loop_closing=False))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ChunkedPipeline(cfg, np.eye(3), None, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        e2e.run_learned_e2e(None, None, None, cfg, 4)
