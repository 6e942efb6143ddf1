"""The sub-pixel heads (pair and single-view), the pair scatter, patch
gathering, the mutual-NN matcher, single-view extraction and the pair- and
single-mode slices: the port against the JAX package.

The Flax heads are built with dtype=float32 by constructor argument and
load the committed `kspair_*.npz` / `ks_*.npz` weights; inputs come from a
numpy seed. The slices run the micro pipeline of tests/test_torch_slice.py
(240x320, N=128, the 900-landmark scene, committed tiny weights, BA off)
over a bootstrap plus two chunks of 8, with the reference's own RANSAC
draws fed to the port.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gl_slam_tpu.checkpoint import load_params as j_load
from gl_slam_tpu.io import synthetic
from gl_slam_tpu.models import subpix as j_subpix
from gl_slam_tpu.ops import match as j_match
from gl_slam_tpu.slam import fused as j_fused
from gl_slam_tpu.slam.chunk_driver import ChunkedPipeline as JPipeline
from gl_slam_tpu.train import e2e as j_e2e
from gl_slam_tpu_torch import checkpoint as ckpt
from gl_slam_tpu_torch import config as t_cfg
from gl_slam_tpu_torch.models import subpix as t_subpix
from gl_slam_tpu_torch.ops import match as t_match
from gl_slam_tpu_torch.slam import fused as t_fused
from gl_slam_tpu_torch.train import e2e as t_e2e

import jax_weights

# Small shapes: one ATen thread per test worker keeps the parallel suite
# from oversubscribing the cores.
torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
P = 7
PRESETS = {"tiny": j_e2e.TINY_DESC_DIM, "flagship": j_e2e.FLAGSHIP_DESC_DIM}


def _heads(preset, dtype=jnp.float32):
    """(Flax head, its params, the port's head) from kspair_<preset>.npz."""
    D = PRESETS[preset]
    path = os.path.join(CKPT, f"kspair_{preset}.npz")
    jh = j_subpix.PairSubpixHead(patch=P, offset_range=1.5, dtype=dtype)
    z = jnp.zeros((4, P, P))
    jp = j_load(path, jax_weights.like(jh, z, z, jnp.zeros((4, D)),
                                       jnp.zeros((4, D)), jnp.zeros((4,))))
    th = t_subpix.PairSubpixHead(D, patch=P, offset_range=1.5,
                                 dtype=torch.float32 if dtype == jnp.float32
                                 else torch.bfloat16)
    ckpt.load_module(th, path, ckpt.subpix_state_dict)
    return jh, jp, th


def _head_inputs(rng, lead, D):
    p0 = rng.uniform(size=(*lead, P, P)).astype(np.float32)
    p1 = rng.uniform(size=(*lead, P, P)).astype(np.float32)
    d0 = rng.standard_normal((*lead, D)).astype(np.float32)
    d1 = rng.standard_normal((*lead, D)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    s = rng.uniform(size=lead).astype(np.float32)
    return p0, p1, d0, d1, s


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_pair_head_matches_flax(preset):
    jh, jp, th = _heads(preset)
    args = _head_inputs(np.random.default_rng(0), (300,), PRESETS[preset])
    want = np.asarray(jh.apply(jp, *map(jnp.asarray, args)))
    with torch.no_grad():
        got = th(*map(torch.from_numpy, args)).numpy()
    # float32 in both frameworks; the first layer sums 611 (flagship) or
    # 227 (tiny) products in another order: ~1e-6 on offsets of O(1).
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_pair_head_takes_leading_dimensions():
    _, _, th = _heads("tiny")
    args = _head_inputs(np.random.default_rng(1), (3, 40), PRESETS["tiny"])
    with torch.no_grad():
        got = th(*map(torch.from_numpy, args))
        flat = th(*(torch.from_numpy(a.reshape(120, *a.shape[2:]))
                    for a in args))
    assert got.shape == (3, 40, 2)
    np.testing.assert_allclose(got.reshape(120, 2).numpy(), flat.numpy(),
                               atol=1e-6)


def _single_heads(preset):
    """(Flax SubpixHead, its params, the port's head) from ks_<preset>.npz,
    float32 on both sides."""
    D = PRESETS[preset]
    jh = j_subpix.SubpixHead(patch=P, offset_range=1.5, dtype=jnp.float32)
    jp = j_load(os.path.join(CKPT, f"ks_{preset}.npz"),
                jax_weights.like(jh, jnp.zeros((4, P, P)), jnp.zeros((4, D))))
    th = t_e2e.load_tiny_subpix(CKPT, device="cpu", dtype=torch.float32) \
        if preset == "tiny" else t_e2e.load_flagship_subpix(
            CKPT, pair=False, device="cpu", dtype=torch.float32)
    return jh, jp, th


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_single_head_matches_flax(preset):
    jh, jp, th = _single_heads(preset)
    assert isinstance(th, t_subpix.SubpixHead)
    p0, _, d0, _, _ = _head_inputs(np.random.default_rng(8), (3, 100),
                                   PRESETS[preset])
    want = np.asarray(jh.apply(jp, jnp.asarray(p0.reshape(300, P, P)),
                               jnp.asarray(d0.reshape(300, -1))))
    with torch.no_grad():
        got = th(torch.from_numpy(p0), torch.from_numpy(d0)).numpy()
    # float32 in both frameworks; the first layer sums 305 (flagship) or
    # 113 (tiny) products in another order: ~1e-6 on offsets of O(1). The
    # port's head also takes a leading batch dimension.
    assert got.shape == (3, 100, 2) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.reshape(300, 2), want, atol=2e-5)


def test_single_mode_extraction_matches_jax():
    """build_extract_fn with the single-view head (ks_tiny.npz) on two
    rendered frames: the same detections, each moved by the head's offset
    from the patch and descriptor at its integer pixel, and descriptors
    sampled again at the refined points."""
    D = PRESETS["tiny"]
    scene = synthetic.make_scene(num_landmarks=900, num_frames=3, height=H,
                                 width=W, desc_dim=D, seed=11)
    imgs = t_e2e.render_stack(scene, 3, N)[1:]
    sp, spp, _, _ = jax_weights.load_tiny_frontend(CKPT)
    jh, jp, th = _single_heads("tiny")
    cfg = j_e2e.micro_config(H, W, N, D)
    want = j_fused.build_extract_fn(cfg, sp.clone(dtype=jnp.float32),
                                    subpix_head=jh)(
        j_fused.FusedParams(sp=spp, lg=None, ks=jp), jnp.asarray(imgs))
    tsp, _ = t_e2e.load_tiny_frontend(CKPT, device="cpu",
                                      dtype=torch.float32)
    tcfg = t_cfg.micro_config(H, W, N, D)
    with torch.no_grad():
        got = t_fused.build_extract_fn(tcfg, tsp, subpix_head=th)(
            torch.from_numpy(imgs))
        centroid = t_fused.build_extract_fn(tcfg, tsp)(
            torch.from_numpy(imgs))
    assert len(got) == 3                      # no patches in single mode
    kp, desc, valid = (x.numpy() for x in got)
    np.testing.assert_array_equal(valid, np.asarray(want[2]))
    assert valid.sum() > 100
    # float32 in both frameworks: heatmaps and descriptors to ~1e-6, the
    # head's offsets as in test_single_head_matches_flax
    np.testing.assert_allclose(kp, np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(desc, np.asarray(want[1]), atol=1e-4)
    # the head, not the centroid, refined them
    moved = np.abs(kp - centroid[0].numpy()).max(-1)[valid]
    assert (moved > 1e-3).mean() > 0.5


def _scatter_inputs(rng, N, D):
    """Patches, descriptors, current keypoints (some on exact halves, which
    round to even), a mutual match table (each current row at most once)
    with -1 rows, scores and a score mask that drops some matches."""
    p0, p1, d0, d1, s = _head_inputs(rng, (N,), D)
    kpts1 = rng.uniform(3.0, 60.0, size=(N, 2)).astype(np.float32)
    kpts1[:6] = np.floor(kpts1[:6]) + 0.5
    m = rng.permutation(N).astype(np.int32)
    m[rng.uniform(size=N) < 0.2] = -1
    mask = rng.uniform(size=N) < 0.8
    mask[m < 0] = rng.uniform(size=int((m < 0).sum())) < 0.5
    return p0, p1, d0, d1, kpts1, m, s, mask


def test_pair_refine_scatter_matches_jax():
    jh, jp, th = _heads("tiny")
    N = 64
    args = _scatter_inputs(np.random.default_rng(2), N, PRESETS["tiny"])
    p0, p1, d0, d1, kpts1, m, s, mask = args
    writes = mask & (m >= 0)
    # the matcher is mutual: no current row is written twice
    assert len(np.unique(m[writes])) == int(writes.sum()) > 10
    want = np.asarray(j_subpix.pair_refine_scatter(
        jh, jp, *map(jnp.asarray, (p0, p1, d0, d1, kpts1, m, s, mask))))
    with torch.no_grad():
        got = t_subpix.pair_refine_scatter(
            th, *map(torch.from_numpy, (p0, p1, d0, d1, kpts1, m, s,
                                        mask))).numpy()
    moved = np.zeros(N, bool)
    moved[m[writes]] = True
    # rows no match writes keep their coordinates bit for bit
    assert not moved.all()
    np.testing.assert_array_equal(got[~moved], kpts1[~moved])
    np.testing.assert_array_equal(want[~moved], kpts1[~moved])
    # written rows: round(kpts1) (half to even) + the head's offset, float32
    # in both frameworks (see test_pair_head_matches_flax)
    np.testing.assert_allclose(got[moved], want[moved], atol=2e-5)
    assert np.abs(got[moved] - np.round(kpts1[moved])).max() > 0.05


def test_pair_refine_scatter_batched_like_vmap():
    jh, jp, th = _heads("tiny")
    rng = np.random.default_rng(3)
    batch = [_scatter_inputs(rng, 32, PRESETS["tiny"]) for _ in range(3)]
    stacked = [np.stack(a) for a in zip(*batch)]
    want = np.asarray(jax.vmap(
        lambda *a: j_subpix.pair_refine_scatter(jh, jp, *a))(
            *map(jnp.asarray, stacked)))
    with torch.no_grad():
        got = t_subpix.pair_refine_scatter(
            th, *map(torch.from_numpy, stacked)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("H,W", [(120, 200), (40, 50)])
def test_gather_patches_matches_jax(H, W):
    """At 120 x 200 (> 16384 pixels) the JAX package gathers through its
    x-packed image copy, at 40 x 50 element by element; the port's direct
    gather equals both, at the borders and for keypoints outside the image
    (where the two JAX paths differ) included."""
    rng = np.random.default_rng(4)
    img = rng.uniform(size=(H, W)).astype(np.float32)
    kpts = np.round(rng.uniform(-4.0, [W + 3.0, H + 3.0],
                                size=(90, 2))).astype(np.float32)
    kpts[:4] = [[0, 0], [W - 1, H - 1], [0, H - 1], [W - 1, 0]]
    want = np.asarray(j_subpix.gather_patches(jnp.asarray(img),
                                              jnp.asarray(kpts), P))
    got = t_subpix.gather_patches(torch.from_numpy(img),
                                  torch.from_numpy(kpts), P).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("N,M", [(100, 80), (64, 64)])
def test_mutual_nn_match_matches_jax(N, M):
    """The mutual-NN matcher (the port's `reobs_matcher="mutual_nn"`):
    indices equal, scores to float32 rounding; masked rows come out
    unmatched and masked columns are never matched."""
    rng = np.random.default_rng(5)
    Dd = 32
    d1 = rng.standard_normal((M, Dd)).astype(np.float32)
    d0 = rng.standard_normal((N, Dd)).astype(np.float32)
    d0[: M // 2] = d1[: M // 2] + 0.3 * d0[: M // 2]     # true partners
    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    v0 = rng.uniform(size=N) < 0.9
    v1 = rng.uniform(size=M) < 0.9
    v0[0], v1[0] = True, False           # row 0's true partner is masked
    want = j_match.mutual_nn_match(*map(jnp.asarray, (d0, v0, d1, v1)))
    got = t_match.mutual_nn_match(*map(torch.from_numpy, (d0, v0, d1, v1)))
    np.testing.assert_array_equal(got.matches0.numpy(),
                                  np.asarray(want.matches0))
    np.testing.assert_allclose(got.mscores0.numpy(),
                               np.asarray(want.mscores0), atol=1e-6)
    m = got.matches0.numpy()
    assert (m >= 0).sum() > N // 4
    assert (m[~v0] == -1).all() and not np.isin(m, np.flatnonzero(~v1)).any()


def test_pair_mode_needs_the_prologue():
    cfg = t_cfg.micro_config(240, 320, 128, PRESETS["tiny"])
    head = t_subpix.PairSubpixHead(PRESETS["tiny"])
    with pytest.raises(ValueError, match="prologue=True"):
        t_fused.build_chunk_fn(cfg, None, None, torch.eye(3), 8,
                               subpix_head=head, prologue=False)
    # pair=False (the default, as in the JAX package): the single-view head
    # with the ks_tiny.npz weights
    single = t_e2e.load_tiny_subpix(CKPT, device="cpu")
    assert isinstance(single, t_subpix.SubpixHead) and single.patch == P
    flat = ckpt.load_params(os.path.join(CKPT, "ks_tiny.npz"))
    for i in range(3):
        dense = getattr(single, f"dense{i}")
        key = f"['params']['Dense_{i}']"
        np.testing.assert_array_equal(dense.weight.detach().numpy(),
                                      flat[key + "['kernel']"].T)
        np.testing.assert_array_equal(dense.bias.detach().numpy(),
                                      flat[key + "['bias']"])


# --- the pair-mode slice ----------------------------------------------------

H, W, N, NF, CHUNK = 240, 320, 128, 18, 8


def _slice_runs(pair, ba=False):
    """(JAX per-frame outputs, JAX pipeline, port diag, port E2EResult,
    the port's SuperPoint, config and the rendered frames) of one run of
    each side with the pair (`pair`) or the single-view head, with a window
    BA pass every chunk or none (`ba`)."""
    D = j_e2e.TINY_DESC_DIM
    scene = synthetic.make_scene(num_landmarks=900, num_frames=NF,
                                 height=H, width=W, desc_dim=D, seed=11)
    stack = t_e2e.render_stack(scene, NF, N)
    c0 = -scene.poses_R[0].T @ scene.poses_t[0]
    c1 = -scene.poses_R[1].T @ scene.poses_t[1]
    scale = float(np.linalg.norm(c1 - c0))

    sp, spp, lg, lgp = jax_weights.load_tiny_frontend(CKPT)
    ks, ksp = j_e2e.load_tiny_subpix(CKPT, pair=pair)
    sp = sp.clone(dtype=jnp.float32)
    lg = lg.clone(dtype=jnp.float32)
    ks = ks.clone(dtype=jnp.float32)
    cfg = j_e2e.micro_config(H, W, N, D)
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, run_full_ba=ba, loop_closing=False))
    jp = JPipeline(cfg, jnp.asarray(scene.K, jnp.float32), sp, lg,
                   j_fused.FusedParams(sp=spp, lg=lgp, ks=ksp), chunk=CHUNK,
                   ba_every=CHUNK, enable_ba=ba, subpix_head=ks)
    jp.bootstrap_from_images(stack[0], stack[1], scale)
    for s in range(2, NF, CHUNK):
        jp.track_chunk(jnp.asarray(stack[s:s + CHUNK]), s)
    ref = jp.stacked_outputs()

    # The reference's draws: bootstrap split(key), then split(key, 3) per
    # frame (tests/test_torch_slice.py).
    hyp = cfg.geometry.essential_hypotheses
    key, k_ess = jax.random.split(jax.random.PRNGKey(0))
    draws = [np.asarray(jax.random.uniform(k_ess, (hyp, 8)))]
    for _ in range(NF - 2):
        key, k_ess, _ = jax.random.split(key, 3)
        draws.append(np.asarray(jax.random.uniform(k_ess, (hyp, 8))))
    pos = [0]

    def feed(n):
        out = np.stack(draws[pos[0]:pos[0] + n])
        pos[0] += n
        return torch.from_numpy(out)

    tsp, tlg = t_e2e.load_tiny_frontend(CKPT, device="cpu",
                                        dtype=torch.float32)
    head = t_e2e.load_tiny_subpix(CKPT, pair=pair, device="cpu",
                                  dtype=torch.float32)
    tcfg = t_cfg.micro_config(H, W, N, D)
    tcfg = dataclasses.replace(tcfg, runtime=dataclasses.replace(
        tcfg.runtime, run_full_ba=ba, loop_closing=False))
    diag = {}
    res = t_e2e.run_learned_e2e(tsp, tlg, scene, tcfg, NF, chunk=CHUNK,
                                ba_every=CHUNK, device="cpu", draws=feed,
                                stack=stack, diag_out=diag, subpix=head)
    assert pos[0] == NF - 1          # every reference draw was consumed
    return ref, jp, diag, res, tsp, tcfg, stack


@pytest.fixture(scope="module")
def pair_runs():
    return _slice_runs(pair=True)


@pytest.fixture(scope="module")
def single_runs():
    # With BA: the single-view head tracks this scene less well than the
    # centroid (pose costs 2-7 px), and without BA one Sampson-threshold
    # flip (68 vs 69 inliers at frame 4) grows in both frameworks' drift to
    # 0.29 m between them at the last frame (JAX's own ATE 0.81 m). The
    # window BA re-anchors both maps after each chunk.
    return _slice_runs(pair=False, ba=True)


def test_pair_slice_poses_match_jax(pair_runs):
    ref, _, diag, _, _, _, _ = pair_runs
    got = diag["outputs"]
    # The tolerances of tests/test_torch_slice.py: float32 in both
    # frameworks with other summation orders, the first chunk to 1e-3, the
    # differences then growing through the map.
    np.testing.assert_allclose(got.R, ref.R, atol=1e-3)
    np.testing.assert_allclose(got.t[:CHUNK], ref.t[:CHUNK], atol=1e-3)
    np.testing.assert_allclose(got.t, ref.t, atol=5e-2)


def test_pair_slice_counts_match_jax(pair_runs):
    ref, _, diag, _, _, _, _ = pair_runs
    got = diag["outputs"]
    np.testing.assert_array_equal(got.frame_ok, ref.frame_ok)
    np.testing.assert_array_equal(got.num_matches, ref.num_matches)
    # As tests/test_torch_slice.py: threshold decisions under another
    # summation order, at most 2 per frame, in few frames.
    d = np.abs(got.num_inliers.astype(int) - ref.num_inliers.astype(int))
    assert d.max() <= 2 and (d > 0).sum() <= 2, (got.num_inliers,
                                                    ref.num_inliers)
    dm = np.abs(got.num_map_matches.astype(int)
                - ref.num_map_matches.astype(int))
    assert dm.max() <= 2 and (dm > 0).sum() <= 2, (got.num_map_matches,
                                                     ref.num_map_matches)


def test_pair_slice_refines_the_map_keypoints_like_jax(pair_runs):
    """The keyframes' stored keypoints are the pair-refined ones on both
    sides, and they differ from the centroid-refined extraction."""
    _, jp, diag, res, tsp, tcfg, stack = pair_runs
    jm, tm = jp.state.map, diag["state"].map
    n = int(tm.num_kf)
    assert n == int(jm.num_kf) == NF == res.num_keyframes
    got = tm.kf_kpts[:n].numpy()
    want = np.asarray(jm.kf_kpts[:n])
    # as the head's offsets (test_pair_head_matches_flax), through the
    # f32 matcher and RANSAC of both sides
    np.testing.assert_allclose(got, want, atol=1e-4)
    with torch.no_grad():
        centroid = t_fused.build_extract_fn(tcfg, tsp)(
            torch.from_numpy(stack[2:3]))[0][0].numpy()
    moved = np.abs(got[2] - centroid).max(axis=1) > 1e-3
    assert moved.sum() > 20, moved.sum()
    # the carried patches are those of the last accepted frame
    assert diag["state"].prev_patches.shape == (N, P, P)


def test_pair_slice_tracks(pair_runs):
    _, _, diag, res, _, _, _ = pair_runs
    got = diag["outputs"]
    assert res.num_keyframes == NF and res.num_rejected == 0
    assert res.mean_matches > 50
    assert np.isfinite(got.R).all() and np.isfinite(got.t).all()
    assert res.ate_m < 1.0, res


# --- the single-mode slice --------------------------------------------------

def _first_decision_flip(got, ref):
    """Index of the first frame where a count of the two runs differs (a
    threshold decision taken the other way), else the frame count."""
    names = ("num_inliers", "num_map_matches", "num_assoc_prev",
             "num_assoc_window", "num_assoc_covis", "num_new_points")
    diff = np.zeros(len(ref.R), bool)
    for n in names:
        diff |= np.asarray(getattr(got, n)) != np.asarray(getattr(ref, n))
    return int(np.argmax(diff)) if diff.any() else len(diff)


def test_single_slice_poses_match_jax(single_runs):
    ref, _, diag, _, _, _, _ = single_runs
    got = diag["outputs"]
    # The tolerances of tests/test_torch_slice.py: R to 1e-3 everywhere, t
    # to 1e-3 over the first chunk and 5e-2 after it, except that the
    # 1e-3 of the first chunk holds up to its first threshold decision that
    # the two sides take apart (measured: frame 4, one inlier; frames 5-7
    # then differ by up to 1.4e-2 m, and after the next BA pass by at most
    # 5.2e-4 m).
    flip = min(_first_decision_flip(got, ref), CHUNK - 1)
    assert flip >= 3, flip
    np.testing.assert_allclose(got.R, ref.R, atol=1e-3)
    np.testing.assert_allclose(got.t[:flip + 1], ref.t[:flip + 1],
                               atol=1e-3)
    np.testing.assert_allclose(got.t, ref.t, atol=5e-2)
    np.testing.assert_allclose(got.t[CHUNK:], ref.t[CHUNK:], atol=1e-3)


def test_single_slice_counts_match_jax(single_runs):
    ref, jp, diag, res, _, _, _ = single_runs
    got = diag["outputs"]
    np.testing.assert_array_equal(got.frame_ok, ref.frame_ok)
    np.testing.assert_array_equal(got.num_matches, ref.num_matches)
    # As test_pair_slice_counts_match_jax.
    d = np.abs(got.num_inliers.astype(int) - ref.num_inliers.astype(int))
    assert d.max() <= 2 and (d > 0).sum() <= 2, (got.num_inliers,
                                                    ref.num_inliers)
    dm = np.abs(got.num_map_matches.astype(int)
                - ref.num_map_matches.astype(int))
    assert dm.max() <= 2 and (dm > 0).sum() <= 2, (got.num_map_matches,
                                                     ref.num_map_matches)
    # the keyframes store the head-refined keypoints on both sides, and the
    # state carries no patches
    n = int(diag["state"].map.num_kf)
    assert n == int(jp.state.map.num_kf) == NF == res.num_keyframes
    np.testing.assert_allclose(diag["state"].map.kf_kpts[:n].numpy(),
                               np.asarray(jp.state.map.kf_kpts[:n]),
                               atol=1e-4)
    assert diag["state"].prev_patches is None
    assert res.num_rejected == 0 and res.ate_m < 1.0, res
