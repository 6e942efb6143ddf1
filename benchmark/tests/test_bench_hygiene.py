"""What the benchmark may load and read."""

import ast
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN_TOP = {"jax", "jaxlib", "flax", "gl_slam_tpu"}
NOT_THE_YARDSTICK = ("bench_torch", "chip_smoke", "scripts/", "BENCH_",
                     "MS_ECON", "PERF_BASELINE")


def sources(sub="", tests=False):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        if not tests and os.sep + "tests" in dirpath:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def test_nothing_imports_jax_or_the_jax_package():
    for path in sources(tests=True):
        bad = set(imported_tops(path)) & FORBIDDEN_TOP
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        tops = set(imported_tops(path))
        assert not tops & (FORBIDDEN_TOP | {"gl_slam_tpu_torch",
                                            "benchmark"}), (path, tops)
        assert tops <= {"__future__", "re", "typing", "numpy", "torch"}, \
            (path, tops)


def test_nothing_reads_the_old_measurement_programs():
    for path in sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert not any(k in node.value for k in NOT_THE_YARDSTICK), \
                    (path, node.value)
        tops = set(imported_tops(path))
        assert not tops & {"bench_torch", "chip_smoke", "scripts", "bench"}


def test_the_program_is_reached_through_its_entry_points():
    allowed = {"gl_slam_tpu_torch", "gl_slam_tpu_torch.config",
               "gl_slam_tpu_torch.train", "gl_slam_tpu_torch.slam",
               "gl_slam_tpu_torch.ops", "gl_slam_tpu_torch.parallel.multistream"}
    names = {"config", "e2e", "fused", "frontend", "_build",
             "MultiStreamTracker"}
    for path in sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("gl_slam_tpu_torch"):
                assert node.module in allowed, (path, node.module)
                assert {a.name for a in node.names} <= names, (path, node)
