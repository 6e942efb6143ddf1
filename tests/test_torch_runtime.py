"""The port's native runtime (gl_slam_tpu_torch/runtime/) against the JAX
package's, on the CPU.

  * `decode_png` and `NativeLoader` of both packages on the same PNG files
    (8-bit gray, RGB, RGBA, palette, 16-bit gray, 1-bit; cropped and
    padded to other sizes): equal bit for bit;
  * `CovisGraph` of both on random keyframe / point tables from a numpy
    seed: `num_edges`, `query` and `points_of` equal, for several seeds
    and edge thresholds;
  * the prefetcher's in-order admission: frame 0 is a named FIFO that
    gets its PNG only once the other workers have filled the ring
    (depth 1, 3 threads, 8 frames); `next()` must still return frame 0.
    The JAX loader's admission check keeps that frame waiting for room
    that never comes; the port admits the in-order frame always. The
    consumer runs in a thread with a join timeout, so a regression fails
    the test instead of hanging the suite;
  * the port's chunked command line on a 160x240 KITTI tree: the native
    loader and PIL give the same report (but for its wall-clock rate), and
    the loader's counter equals the frames fed.
"""

import contextlib
import io
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from gl_slam_tpu.runtime import native_lib as j_native
from gl_slam_tpu_torch import cli
from gl_slam_tpu_torch.io import synthetic
from gl_slam_tpu_torch.io.kitti import write_kitti_sequence
from gl_slam_tpu_torch.runtime import native_lib

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "checkpoints")


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """Eight 40x60 PNG files of every colour type the decoder normalises."""
    from PIL import Image
    d = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    paths = []
    for i, mode in enumerate(["L", "RGB", "RGBA", "P", "I;16", "1", "L",
                              "RGB"]):
        if mode == "I;16":
            img = Image.fromarray(
                (rng.random((40, 60)) * 65535).astype(np.uint16))
        else:
            rgb = (rng.random((40, 60, 3)) * 255).astype(np.uint8)
            img = Image.fromarray(rgb, mode="RGB").convert(mode)
        p = str(d / f"{i:06d}.png")
        img.save(p)
        paths.append(p)
    return paths


def test_native_libraries_build_apart():
    """The loader and the covisibility graph build into two libraries
    under the port's git-ignored build directory; only the loader links
    libpng."""
    assert native_lib.available()
    native_lib.CovisGraph(1)
    for name in ("loader", "covis"):
        path = native_lib.library_path(name)
        assert os.path.exists(path)
        assert os.path.dirname(path) == native_lib.BUILD_DIR
        assert "gl_slam_tpu_torch" in path.replace(os.sep, "/").split("/")
    assert "-lpng" in native_lib._LIBS["loader"][1]
    assert native_lib._LIBS["covis"][1] == []


def test_a_library_that_does_not_load_is_unavailable(tmp_path,
                                                     monkeypatch):
    """A library built on another machine may link a library this one
    lacks (libpng): it is then unavailable, with the reason, as a failed
    build is; the command line reads with PIL and the graph raises."""
    bogus = tmp_path / "libglslam_bogus.so"
    bogus.write_bytes(b"not a shared object")
    monkeypatch.setattr(native_lib, "library_path", lambda name: str(bogus))
    monkeypatch.setattr(native_lib, "_LOADED", {})
    monkeypatch.setattr(native_lib, "_FAILED", {})
    assert not native_lib.available()
    assert "libglslam_bogus.so" in native_lib.build_error()
    assert native_lib.decode_png(str(bogus), 4, 4) is None
    with pytest.raises(RuntimeError, match="unavailable"):
        native_lib.NativeLoader([str(bogus)], 4, 4)
    with pytest.raises(RuntimeError, match="unavailable"):
        native_lib.CovisGraph()


@pytest.mark.parametrize("size", [(40, 60), (30, 50), (48, 72)])
def test_decode_png_equals_jax(pngs, size):
    for p in pngs:
        got = native_lib.decode_png(p, *size)
        ref = j_native.decode_png(p, *size)
        assert got is not None and got.dtype == np.float32
        np.testing.assert_array_equal(got, ref, err_msg=p)
    assert native_lib.decode_png(pngs[0] + ".missing", *size) is None


@pytest.mark.parametrize("depth,threads", [(1, 1), (2, 3), (4, 2)])
def test_native_loader_equals_jax(pngs, depth, threads):
    native_lib.reset_frame_count()
    got = list(native_lib.NativeLoader(pngs, 40, 60, depth=depth,
                                       threads=threads))
    ref = list(j_native.NativeLoader(pngs, 40, 60, depth=depth,
                                     threads=threads))
    assert [i for i, _ in got] == list(range(len(pngs)))
    assert [i for i, _ in got] == [i for i, _ in ref]
    for (_, a), (_, b) in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert native_lib.DELIVERED["frames"] == len(pngs)


def test_native_loader_skips_a_frame_that_does_not_decode(pngs, tmp_path):
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as f:
        f.write(b"not a png")
    paths = [pngs[0], bad, pngs[2]]
    got = [i for i, _ in native_lib.NativeLoader(paths, 40, 60)]
    ref = [i for i, _ in j_native.NativeLoader(paths, 40, 60)]
    assert got == ref == [0, 2]


def _covis_table(seed):
    """A random keyframe / point table: 12 keyframes over 300 points, each
    observing a window of consecutive ids with holes and -1 padding."""
    rng = np.random.default_rng(seed)
    table = []
    for kf in range(12):
        lo = int(rng.integers(0, 200))
        ids = np.arange(lo, lo + int(rng.integers(30, 100)))
        ids = ids[rng.random(len(ids)) < 0.8]
        ids = np.concatenate([ids, -np.ones(int(rng.integers(0, 5)), int)])
        table.append(rng.permutation(ids).astype(np.int64))
    return table


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("threshold", [1, 10, 30])
def test_covis_graph_equals_jax(seed, threshold):
    table = _covis_table(seed)
    ours = native_lib.CovisGraph(edge_threshold=threshold)
    ref = j_native.CovisGraph(edge_threshold=threshold)
    for kf, ids in enumerate(table):
        ours.add_keyframe(kf, ids)
        ref.add_keyframe(kf, ids)
    assert ours.num_edges == ref.num_edges
    rng = np.random.default_rng(100 + seed)
    for _ in range(5):
        seeds = rng.integers(-1, 300, 40)
        k1, k2, top = (int(x) for x in rng.integers(1, 8, 3))
        np.testing.assert_array_equal(
            ours.query(seeds, k1=k1, k2=k2, top_n=top),
            ref.query(seeds, k1=k1, k2=k2, top_n=top))
        kfs = rng.choice(12, 3, replace=False)
        excl = rng.integers(0, 300, 50)
        np.testing.assert_array_equal(ours.points_of(kfs, excl),
                                      ref.points_of(kfs, excl))
        np.testing.assert_array_equal(ours.points_of(kfs, excl, max_out=7),
                                      ref.points_of(kfs, excl, max_out=7))


def test_covis_graph_small_case():
    """tests/test_runtime.py's hand-made graph on the port."""
    g = native_lib.CovisGraph(edge_threshold=2)
    g.add_keyframe(0, np.arange(5))
    g.add_keyframe(1, np.arange(7))
    g.add_keyframe(2, np.array([5, 6, 10]))
    assert g.num_edges == 2
    out = set(g.query(np.array([5, 6]), k1=2, k2=5, top_n=5).tolist())
    assert 1 in out and 2 in out
    pts = g.points_of(np.array([1]), exclude=np.array([0, 1]))
    assert set(pts.tolist()) == {2, 3, 4, 5, 6}


def test_in_order_frame_is_always_admitted(pngs, tmp_path):
    """Depth 1 and 3 workers leave room for 4 decoded frames. The worker
    that takes frame 0 blocks opening the FIFO; the two others decode
    frames 1-4 into the ring and then wait for room with frames 5 and 6.
    Only then does frame 0 get its bytes: it must be admitted past the
    full ring, or the consumer waits for it for ever."""
    from PIL import Image
    fifo = str(tmp_path / "000000.png")
    os.mkfifo(fifo)
    buf = io.BytesIO()
    Image.fromarray(np.full((40, 60), 77, np.uint8), mode="L").save(
        buf, format="PNG")
    paths = [fifo] + [pngs[0]] * 7
    loader = native_lib.NativeLoader(paths, 40, 60, depth=1, threads=3)
    got = {}

    def consume():
        got["frames"] = list(loader)

    time.sleep(1.0)                 # the other workers fill the ring
    fd = None
    for _ in range(50):             # the FIFO's reader is the frame-0 worker
        try:
            fd = os.open(fifo, os.O_WRONLY | os.O_NONBLOCK)
            break
        except OSError:
            time.sleep(0.1)
    assert fd is not None, "no worker opened frame 0"
    os.set_blocking(fd, True)
    os.write(fd, buf.getvalue())
    os.close(fd)
    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=10.0)
    if t.is_alive():
        loader._handle = None       # a stuck loader is not torn down
        pytest.fail("the loader did not deliver frame 0: the in-order "
                    "frame was not admitted")
    frames = got["frames"]
    assert [i for i, _ in frames] == list(range(8))
    np.testing.assert_allclose(frames[0][1], 77 / 255.0, atol=1e-6)
    loader.close()


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    scene = synthetic.make_scene(num_landmarks=700, num_frames=20,
                                 height=160, width=240, desc_dim=64,
                                 seed=23)
    return write_kitti_sequence(root, scene, num_frames=20,
                                max_keypoints=96)


def _chunked(kitti_dir, out, native: bool):
    argv = ["run", "--dataset", kitti_dir, "--frontend", "superpoint",
            "--preset", "tiny", "--weights", CKPT, "--out", out,
            "--first-frame", "0", "--last-frame", "19", "--height", "160",
            "--width", "240", "--kpts", "96", "--chunk", "4",
            "--ba-every", "4", "--subpix", "centroid", "--device", "cpu"]
    native_lib.reset_frame_count()
    stdout = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(stdout):
        if not native:
            mp.setattr(native_lib, "available", lambda: False)
        assert cli.main(argv) == 0
    return json.loads(stdout.getvalue()), native_lib.DELIVERED["frames"]


def test_cli_reads_through_the_native_loader(kitti_dir, tmp_path):
    """The chunked route fed by the loader and by PIL: every frame fed
    once through the loader and none without it, and the same report but
    for `fps_incl_io` (wall clock) and the ATE. The loader scales a pixel
    as the JAX loader does, x * (1 / 255), and PIL's path as x / 255;
    those differ in the last bit for 126 of the 256 grey levels, and the
    tracker carries that into the ATE: 0.4490 against 0.4462 m here, so
    the ATE is held to 1 cm (and both to the chunked route's 2 m bound of
    tests/test_torch_cli.py)."""
    rep_native, n_native = _chunked(kitti_dir, str(tmp_path / "n"), True)
    rep_pil, n_pil = _chunked(kitti_dir, str(tmp_path / "p"), False)
    assert n_native == rep_native["frames_fed"] == 20
    assert n_pil == 0
    ates = rep_native.pop("ate_rmse_m"), rep_pil.pop("ate_rmse_m")
    assert abs(ates[0] - ates[1]) <= 0.01 and max(ates) < 2.0, ates
    rep_native.pop("fps_incl_io")
    rep_pil.pop("fps_incl_io")
    assert rep_native == rep_pil
    assert rep_native["frames_tracked"] >= 14


def test_cli_per_frame_route_reads_each_frame_once(kitti_dir, tmp_path):
    """The per-frame route (Harris) through the loader: the frames up to
    --last-frame come off the loader's ring once each (a frame the motion
    gate skips is dropped, never read again), and the run tracks as on
    PIL."""
    reports, fetched = {}, []
    open_dataset = cli._open_dataset

    def counted(args):
        src, K, gt_R, gt_t, frame, gate = open_dataset(args)

        def fetch(i):
            fetched.append(i)
            return frame(i)
        return src, K, gt_R, gt_t, fetch, gate

    for native in (True, False):
        fetched.clear()
        argv = ["run", "--dataset", kitti_dir, "--frontend", "harris",
                "--kpts", "256", "--hypotheses", "128", "--height", "160",
                "--width", "240", "--last-frame", "11",
                "--out", str(tmp_path / str(native)), "--device", "cpu"]
        native_lib.reset_frame_count()
        stdout = io.StringIO()
        with pytest.MonkeyPatch.context() as mp, \
                contextlib.redirect_stdout(stdout):
            mp.setattr(cli, "_open_dataset", counted)
            if not native:
                mp.setattr(native_lib, "available", lambda: False)
            assert cli.main(argv) == 0
        reports[native] = json.loads(stdout.getvalue())
        gated = reports[native]["frames_gated"]
        assert len(fetched) == len(set(fetched)) == 12 - gated
        assert native_lib.DELIVERED["frames"] == (12 if native else 0)
    for key in ("frames_tracked", "frames_gated"):
        assert reports[True][key] == reports[False][key], key
