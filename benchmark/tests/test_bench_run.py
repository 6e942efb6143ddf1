"""run.py's refusals, on a machine without a card."""

import json
import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
ARGS = ["--workload", "strict.fleet64", "--seed", str(2**31 + 11),
        "--seconds", "1", "--trace", "0"]


def last_json(out):
    lines = out.strip().splitlines()
    try:
        return json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        return None


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert last_json(p.stdout) is None
    assert "cuda" in p.stderr.lower()


def test_only_the_benchmark_files_is_refused(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300, env=env)
    assert p.returncode != 0
    assert last_json(p.stdout) is None
    assert "gl_slam_tpu_torch" in p.stderr


@pytest.mark.cuda
def test_renderer_on_the_card_equals_the_cpu():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from benchmark import scene
    sc = scene.loop_scene(3, 360, 170, 376, 1241)
    frames = [0, 90, 359]
    a = scene.render_frames_torch(sc, frames, 2048, torch.device("cuda"))
    b = scene.render_frames_torch(sc, frames, 2048, torch.device("cpu"))
    torch.testing.assert_close(a.cpu(), b, rtol=0, atol=2e-6)
