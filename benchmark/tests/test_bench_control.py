"""The control at a CPU size: the reference put in the program's place
one precision below (the networks in fp8, the BA's LM in TF32) reads far
above the program, on the same frames and BA window, and the check calls
it not correct; on the card at the cells' own sizes the same procedure is
`python benchmark/control.py` (the readings PERF.md gives)."""

import os

from benchmark import control

HERE = os.path.dirname(os.path.abspath(__file__))
TINY = os.path.join(HERE, "tiny")


def test_control_reads_above_the_program():
    res = control.readings("tiny.fleet2", [5], {5}, 0,
                           bench_json=os.path.join(TINY, "BENCHMARK.json"),
                           bench_dir=TINY, require_cuda=False,
                           log=lambda *a: None)
    prog, ctl = res["program"][5], res["control"][5]
    assert ctl["desc_gap"] > 30 * prog["desc_gap"]
    assert ctl["refine_gap_px"] > 10 * max(prog["refine_gap_px"], 1e-3)
    assert ctl["ba_cost_gap"] > 3 * max(prog["ba_cost_gap"], 0.0)
    assert ctl["correct"] is False
