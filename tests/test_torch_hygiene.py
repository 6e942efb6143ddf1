"""The port stands alone and runs on the card unless told otherwise.

gl_slam_tpu_torch/ (its native runtime included), chip_smoke.py, the
port's scripts (scripts/*_torch.py) and examples (examples/*_torch.py)
must import no JAX, no Flax and nothing of the JAX package (the card's
machine has neither), the native runtime must build from the port's own
sources, and the port's entry points must refuse to fall back to the CPU
silently.
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
    scripts = os.path.join(ROOT, "scripts")
    files += [os.path.join(scripts, n) for n in sorted(os.listdir(scripts))
              if n.endswith("_torch.py")]
    examples = os.path.join(ROOT, "examples")
    files += [os.path.join(examples, n)
              for n in sorted(os.listdir(examples)) if n.endswith("_torch.py")]
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
    assert os.path.join("gl_slam_tpu_torch", "slam", "loopclose.py") in names
    for module in ("cli.py", "metrics.py", "tracing.py",
                   os.path.join("io", "kitti.py"),
                   os.path.join("io", "euroc.py"),
                   os.path.join("viz", "viewer.py"),
                   os.path.join("slam", "pipeline.py"),
                   os.path.join("models", "classical.py")):
        assert os.path.join("gl_slam_tpu_torch", module) in names
    for script in ("eval_flagship_torch.py", "eval_loopclose_torch.py",
                   "longrun_learned_torch.py",
                   "train_frontend_torch.py",
                   "train_pair_subpix_tiny_torch.py"):
        assert os.path.join("scripts", script) in names
    assert os.path.join("gl_slam_tpu_torch", "train",
                        "frontend_train.py") in names
    assert os.path.join("gl_slam_tpu_torch", "runtime",
                        "native_lib.py") in names
    assert os.path.join("scripts", "eval_native_loader_torch.py") in names
    for example in ("run_synthetic_torch.py", "run_images_torch.py"):
        assert os.path.join("examples", example) in names


def test_native_runtime_reads_only_its_own_sources():
    """native_lib builds from gl_slam_tpu_torch/runtime/native/ into
    gl_slam_tpu_torch/runtime/build/ and names no path of the JAX
    package; its C++ sources include no file of it either."""
    from gl_slam_tpu_torch.runtime import native_lib
    here = os.path.realpath(os.path.join(ROOT, "gl_slam_tpu_torch",
                                         "runtime"))
    assert os.path.realpath(native_lib._SRC) == os.path.join(here, "native")
    assert os.path.realpath(native_lib.BUILD_DIR) == os.path.join(here,
                                                                  "build")
    for name in ("loader", "covis"):
        lib = os.path.realpath(native_lib.library_path(name))
        assert lib.startswith(os.path.join(here, "build") + os.sep)
        src = os.path.join(here, "native", native_lib._LIBS[name][0])
        assert os.path.exists(src)
        assert "gl_slam_tpu/" not in open(src).read()
    tree = ast.parse(open(os.path.join(here, "native_lib.py")).read())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and ast.get_docstring(n) is not None}
    strings = [n.value for n in ast.walk(tree)
               if isinstance(n, ast.Constant) and isinstance(n.value, str)
               and id(n) not in docs]
    assert not any("gl_slam_tpu" in s and "gl_slam_tpu_torch" not in s
                   and ("/" in s or os.sep in s) for s in strings)
    assert "gl_slam_tpu_torch/runtime/build/" in open(
        os.path.join(ROOT, ".gitignore")).read()


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


def test_eval_entry_points_default_to_the_card(no_cuda):
    from gl_slam_tpu_torch.train import evals
    ckpt = os.path.join(ROOT, "checkpoints")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evals.flagship_eval(ckpt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evals.loopclose_ab(ckpt)
    assert evals.device_line("cpu") == "cpu"
    # the command line without --device
    from gl_slam_tpu_torch import cli
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", "--frontend", "superpoint", "--weights", ckpt,
                  "--out", os.path.join(ROOT, "chiprun_out", "unused")])


def test_per_frame_entry_points_default_to_the_card(no_cuda, tmp_path):
    """TrackingPipeline and the command line's per-frame routes (the
    default oracle route included) without a device raise, before they
    write anything."""
    from gl_slam_tpu_torch import cli
    from gl_slam_tpu_torch.config import micro_config
    from gl_slam_tpu_torch.slam.pipeline import TrackingPipeline
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrackingPipeline(micro_config(48, 64, 32, 64), np.eye(3))
    ckpt = os.path.join(ROOT, "checkpoints")
    for extra in ((), ("--frontend", "harris"),
                  ("--frontend", "superpoint", "--per-frame",
                   "--weights", ckpt)):
        out = tmp_path / "out"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["run", "--out", str(out), *extra])
        assert not out.exists()


def test_extractor_matcher_and_examples_default_to_the_card(no_cuda):
    """SuperPointExtractor, LightGlueMatcher, SubpixRefiner and both
    examples without a device raise; the examples take --device cpu."""
    from gl_slam_tpu_torch.models.lightglue import LightGlueMatcher
    from gl_slam_tpu_torch.models.subpix import SubpixRefiner
    from gl_slam_tpu_torch.models.superpoint import SuperPointExtractor
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SuperPointExtractor(48, 64, descriptor_dim=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LightGlueMatcher(48, 64, input_dim=16, dim=16, heads=2, layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SubpixRefiner(desc_dim=16)
    for example in ("run_synthetic_torch.py", "run_images_torch.py"):
        mod = _load_module(os.path.join(ROOT, "examples", example))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(["--frames", "4"])


def test_examples_run_on_the_cpu(capsys):
    mod = _load_module(os.path.join(ROOT, "examples",
                                    "run_synthetic_torch.py"))
    assert mod.main(["--frames", "6", "--kpts", "128", "--device",
                     "cpu"]) == 0
    out = capsys.readouterr().out
    assert "ATE-RMSE" in out and "over 6 frames" in out


def test_native_loader_eval_refuses_without_the_loader(monkeypatch,
                                                        tmp_path):
    """The eval is evidence for the native loader: without it, it stops
    before rendering or writing anything."""
    from gl_slam_tpu_torch.runtime import native_lib
    monkeypatch.setattr(native_lib, "available", lambda: False)
    mod = _load_script("eval_native_loader_torch.py")
    out = tmp_path / "r.json"
    with pytest.raises(SystemExit, match="native PNG loader"):
        mod.main(["--out", str(out), "--tree", str(tmp_path / "tree"),
                  "--device", "cpu"])
    assert not out.exists() and not (tmp_path / "tree").exists()


def test_trainers_default_to_the_card(no_cuda):
    """The four trainers without a device raise before they render or
    train anything; with device="cpu" they run (test_torch_train_*.py)."""
    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.models.lightglue import LightGlueNet
    from gl_slam_tpu_torch.models.subpix import PairSubpixHead, SubpixHead
    from gl_slam_tpu_torch.models.superpoint import SuperPointNet
    from gl_slam_tpu_torch.train import frontend_train as ft
    scene = synthetic.make_scene(num_landmarks=50, num_frames=4, height=32,
                                 width=48, desc_dim=16, seed=0)
    sp = SuperPointNet(descriptor_dim=16, channels=(4,) * 8)
    before = {k: v.clone() for k, v in sp.state_dict().items()}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ft.train_superpoint(sp, scene, 4, 8, steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ft.train_subpix(SubpixHead(16), sp, scene, 4, 8, steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ft.train_pair_subpix(PairSubpixHead(16), sp, scene, 4, 8, steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ft.train_lightglue(LightGlueNet(dim=16, heads=2, layers=1,
                                        input_dim=16), sp, scene, 4, 8,
                           steps=1)
    for k, v in sp.state_dict().items():
        assert torch.equal(v, before[k]), k
    ft.train_superpoint(sp, scene, 4, 8, steps=1, device="cpu")


def _load_module(path):
    import importlib.util
    name = os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_script(name):
    return _load_module(os.path.join(ROOT, "scripts", name))


@pytest.mark.parametrize("script", ["train_frontend_torch.py",
                                    "train_pair_subpix_tiny_torch.py"])
def test_training_scripts_refuse_the_committed_checkpoints(script,
                                                           tmp_path):
    """--out may not be checkpoints/ (nor a directory in it), however it is
    spelled; the refusal comes before any device or training work. The
    default is the git-ignored trained_torch/."""
    mod = _load_script(script)
    ckpt = os.path.join(ROOT, "checkpoints")
    for out in (ckpt, ckpt + "/", os.path.join(ROOT, "scripts", "..",
                                               "checkpoints"),
                os.path.join(ckpt, "sub")):
        with pytest.raises(ValueError, match="checkpoints/"):
            mod.main(["--out", out, "--device", "cpu"])
    assert os.path.realpath(mod.DEFAULT_OUT) == os.path.realpath(
        os.path.join(ROOT, "trained_torch"))
    assert "trained_torch/" in open(os.path.join(ROOT, ".gitignore")).read()
    assert mod.checked_out_dir(str(tmp_path)) == str(tmp_path)
