"""The benchmark's drive: its frozen scene copy against the port's, and
the vectorised renderer against the frozen numpy loop."""

import numpy as np
import pytest
import torch

from benchmark import scene


def test_frozen_scene_equals_the_ports():
    from gl_slam_tpu_torch.io import synthetic
    a = scene.make_scene(num_landmarks=300, num_frames=20, height=48,
                         width=64, desc_dim=8, seed=4, loop_period=20)
    b = synthetic.make_scene(num_landmarks=300, num_frames=20, height=48,
                             width=64, desc_dim=8, seed=4, motion="loop",
                             loop_period=20)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    np.testing.assert_array_equal(scene.render_frame(a, 3, 64),
                                  synthetic.render_frame(b, 3, 64))


@pytest.mark.parametrize("max_keypoints", [40, 400])
def test_vectorised_renderer_equals_the_loop(max_keypoints):
    """Equal to float32 rounding: the loop mixes float32 and float64
    arithmetic, the vectorised renderer runs in float64 throughout. With 40
    keypoints the nearest-landmark cut is taken; with 400 every visible
    landmark is drawn."""
    sc = scene.loop_scene(seed=2**31 + 5, loop_period=24,
                          landmarks_per_frame=30, height=60, width=90)
    frames = [0, 5, 11, 23]
    got = scene.render_frames_torch(sc, frames, max_keypoints,
                                    torch.device("cpu"), batch=3).numpy()
    for i, f in enumerate(frames):
        want = scene.render_frame(sc, f, max_keypoints)
        assert want.max() > 0.3
        np.testing.assert_allclose(got[i], want, rtol=0, atol=2e-6)


def test_stream_offsets_and_ground_truth():
    from benchmark import harness
    cell = dict(config=dict(pipeline=dict(image_height=48, image_width=64,
                                          max_keypoints=32)),
                traffic=dict(streams=3, chunk=4, loop_period=30,
                             landmarks_per_frame=10))
    d = harness.Drive(cell, 7, torch.device("cpu"))
    assert list(d.starts) == [0, 10, 20]
    assert d.scene_frame(2, 12) == 2
    idx = [d.scene_frame(1, 2 + k) for k in range(4)]
    torch.testing.assert_close(d.chunk_images(0)[1], d.frames[idx])
    c = d.gt_center(1, np.arange(4))
    np.testing.assert_allclose(c[0], 0.0, atol=1e-12)
    assert abs(d.bootstrap_scale(1) - 1.0) < 0.01
    # one lap later the drive is where it started: no jump at the wrap
    lap = d.gt_center(0, np.array([29, 30, 31]))
    np.testing.assert_allclose(np.linalg.norm(np.diff(lap, axis=0), axis=1),
                               1.0, atol=0.01)
