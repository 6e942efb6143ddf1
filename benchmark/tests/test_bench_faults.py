"""A whole run at a CPU size with the program broken underneath: the
check must come out false for each fault the cell can have, and true for
the program as it is. The run skips only the look for a card."""

import os
import time

import pytest
import torch

from benchmark import runner

HERE = os.path.dirname(os.path.abspath(__file__))
TINY = os.path.join(HERE, "tiny")


def run_tiny(seed=11):
    return runner.execute("tiny.fleet2", seed, 0.5, False,
                          time.perf_counter(),
                          bench_json=os.path.join(TINY, "BENCHMARK.json"),
                          bench_dir=TINY, require_cuda=False)


def _half(real, cfg, sp, lg, K, T, S, kw):
    """Half of the streams left out: the chunk runs the first half and
    hands every left-out stream the result of a tracked one."""
    from gl_slam_tpu_torch.slam.state import tree_map
    h = S // 2
    fn = real(cfg, sp, lg, K, T, h, **kw)
    rows = torch.arange(S) % h

    def run(state, images, f0, u, **k):
        part = tree_map(lambda x: x[:h], state)
        st, outs, rec = fn(part, images[:h], f0, u[:h], **k)
        return (tree_map(lambda x: x[rows], st),
                [type(o)(*(x[rows] for x in o)) for o in outs], rec)
    return run


def _unchanged(real, cfg, sp, lg, K, T, S, kw):
    """A step that returns its state unchanged, its outputs at the
    state's pose."""
    fn = real(cfg, sp, lg, K, T, S, **kw)

    def run(state, images, f0, u, **k):
        _, outs, rec = fn(state, images, f0, u, **k)
        return state, [o._replace(R=state.R_cur, t=state.t_cur)
                       for o in outs], rec
    return run


def _pose(real, cfg, sp, lg, K, T, S, kw):
    """An answer altered where it is produced: each frame's translation
    off by 1 m along the optical axis."""
    fn = real(cfg, sp, lg, K, T, S, **kw)

    def run(state, images, f0, u, **k):
        st, outs, rec = fn(state, images, f0, u, **k)
        return st, [o._replace(t=o.t + torch.tensor([0.0, 0.0, 1.0]))
                    for o in outs], rec
    return run


CHUNK_FAULTS = {"half_the_streams": _half, "state_unchanged": _unchanged,
                "pose_altered": _pose}


@pytest.mark.parametrize("fault", list(CHUNK_FAULTS))
def test_a_broken_chunk_is_not_correct(monkeypatch, fault):
    from gl_slam_tpu_torch.slam import fused
    real = fused.build_multistream_chunk_fn

    def broken(cfg, sp, lg, K, T, S, **kw):
        return CHUNK_FAULTS[fault](real, cfg, sp, lg, K, T, S, kw)
    monkeypatch.setattr(fused, "build_multistream_chunk_fn", broken)
    res = run_tiny()
    assert res["correct"] is False, res["checks"]


def test_a_skipped_ba_is_not_correct(monkeypatch):
    """The BA pass returns the map unchanged: a step of the backend that
    returns its state as it was."""
    from gl_slam_tpu_torch.parallel import multistream
    monkeypatch.setattr(multistream.MultiStreamTracker, "ba",
                        lambda self, first_kf, window: None)
    res = run_tiny()
    assert res["correct"] is False
    gap = res["checks"]["ba_cost_gap"]
    assert gap["value"] > gap["limit"]


def test_descriptors_altered_where_produced_are_not_correct(monkeypatch):
    from gl_slam_tpu_torch.slam import fused
    real = fused.build_extract_fn

    def broken(cfg, sp, subpix_head=None):
        fn = real(cfg, sp, subpix_head=subpix_head)

        def run(images):
            kp, desc, *rest = fn(images)
            g = torch.Generator().manual_seed(0)
            desc = torch.nn.functional.normalize(
                desc + 0.05 * torch.randn(desc.shape, generator=g), dim=-1)
            return (kp, desc, *rest)
        return run
    monkeypatch.setattr(fused, "build_extract_fn", broken)
    res = run_tiny()
    assert res["correct"] is False
    assert res["checks"]["desc_gap"]["value"] > \
        res["checks"]["desc_gap"]["limit"]


def test_the_program_as_it_is_is_correct():
    res = run_tiny()
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] == 16 and res["failed"] == 0
    assert list(res)[-1] == "checks"
