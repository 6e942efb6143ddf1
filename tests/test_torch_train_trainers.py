"""The front-end trainers of gl_slam_tpu_torch/train/frontend_train.py
against the JAX package's, on the CPU.

  * `_detect_features_staged` with the committed sp_tiny.npz (both
    networks in float32) on 8 frames of a tiny-preset scene, in both
    anchorings;
  * `train_subpix` and `train_pair_subpix` for 5 steps from JAX's
    initialisation: their draws are numpy-only, so the trained parameters
    agree within float32 rounding;
  * the SuperPoint descent test of tests/test_learned_e2e.py::
    test_training_steps_reduce_losses mirrored (30 Adam steps on a fixed
    batch end below 0.7 x the first loss), and short runs of
    `train_superpoint` and `train_lightglue`.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gl_slam_tpu.checkpoint import load_params as j_load
from gl_slam_tpu.io import synthetic as j_syn
from gl_slam_tpu.models import subpix as j_subpix
from gl_slam_tpu.models.superpoint import SuperPointNet as JSuperPoint
from gl_slam_tpu.train import frontend_train as jft
from gl_slam_tpu_torch import checkpoint as ckpt
from gl_slam_tpu_torch import config as t_cfg
from gl_slam_tpu_torch.io import synthetic as t_syn
from gl_slam_tpu_torch.models import init_like_flax
from gl_slam_tpu_torch.models import subpix as t_subpix
from gl_slam_tpu_torch.models.lightglue import LightGlueNet
from gl_slam_tpu_torch.models.superpoint import SuperPointNet
from gl_slam_tpu_torch.train import frontend_train as ft

import jax_weights

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
H, W, N, D = 160, 240, 96, t_cfg.TINY_DESC_DIM
SCENE = dict(num_landmarks=700, num_frames=8, height=H, width=W,
             desc_dim=D, seed=7)


def flat(params):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.fixture(scope="module")
def tiny():
    """(JAX scene, port scene, Flax SuperPoint, its params, port
    SuperPoint), float32, sp_tiny.npz."""
    jsp = JSuperPoint(descriptor_dim=D, channels=t_cfg.TINY_SP_CHANNELS,
                      dtype=jnp.float32)
    jp = j_load(os.path.join(CKPT, "sp_tiny.npz"),
                jax_weights.like(jsp, jnp.zeros((1, H, W, 1))))
    sp = SuperPointNet(descriptor_dim=D, channels=t_cfg.TINY_SP_CHANNELS,
                       dtype=torch.float32)
    ckpt.load_module(sp, os.path.join(CKPT, "sp_tiny.npz"),
                     ckpt.superpoint_state_dict)
    return (j_syn.make_scene(**SCENE), t_syn.make_scene(**SCENE), jsp, jp,
            sp)


@pytest.mark.parametrize("refine_centroid", [False, True])
def test_detect_features_staged_matches_jax(tiny, refine_centroid):
    js, ts, jsp, jp, sp = tiny
    want = jft._detect_features_staged(
        jsp, jp, jft.stage_packs([js], 8, N), N, 7, 1e-3, 3, 1.5,
        refine_centroid)
    got = ft._detect_features_staged(
        sp, ft.stage_packs([ts], 8, N, "cpu"), N, 7, 1e-3, 3, 1.5,
        refine_centroid)
    names = ("patches", "desc", "target", "ok", "lid")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        if name == "desc":
            # unit descriptors through f32 convolutions in another order
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)
        else:
            # the same detections: patches, targets, ids equal
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got[3].sum() > 200                  # matched detections exist


@pytest.mark.parametrize("pair", [False, True])
def test_subpix_trainers_match_jax(tiny, pair):
    """5 steps from the Flax initialisation (reinit=False keeps it): the
    parameters move by ~5e-3 (lr 1e-3 x 5) and agree within 1e-5 (observed
    1e-6: f32 gradients summed in another order; Adam's first steps are
    near sign(g), so only a gradient within rounding of 0 could differ by
    more, and none does)."""
    js, ts, jsp, jp, sp = tiny
    P = 7
    z = jnp.zeros
    if pair:
        jh = j_subpix.PairSubpixHead(patch=P, dtype=jnp.float32)
        th = t_subpix.PairSubpixHead(D, patch=P, dtype=torch.float32)
        init = jh.init(jax.random.PRNGKey(3), z((4, P, P)), z((4, P, P)),
                       z((4, D)), z((4, D)), z((4,)))
        want = jft.train_pair_subpix(jh, jsp, jp, [js], 8, N, steps=5)
        trainer = ft.train_pair_subpix
    else:
        jh = j_subpix.SubpixHead(patch=P, dtype=jnp.float32)
        th = t_subpix.SubpixHead(D, patch=P, dtype=torch.float32)
        init = jh.init(jax.random.PRNGKey(2), z((4, P, P)), z((4, D)))
        want = jft.train_subpix(jh, jsp, jp, [js], 8, N, steps=5)
        trainer = ft.train_subpix
    ckpt.load_module(th, flat(init), ckpt.subpix_state_dict)
    stats = {}
    out = trainer(th, sp, [ts], 8, N, steps=5, device="cpu", reinit=False,
                  stats=stats)
    assert out is th
    assert np.isfinite(stats["first_loss"]) and stats["steps"] == 5
    want_sd = ckpt.subpix_state_dict(flat(want))
    init_sd = ckpt.subpix_state_dict(flat(init))
    for name, p in th.state_dict().items():
        assert float((want_sd[name] - init_sd[name]).abs().max()) > 1e-3
        assert float((p - want_sd[name]).abs().max()) <= 1e-5, name


def test_superpoint_descent_like_the_jax_test():
    """tests/test_learned_e2e.py::test_training_steps_reduce_losses' SP
    half: 30 Adam (2e-3) steps on one fixed batch end below 0.7 x the first
    loss, every loss finite."""
    h, w, n, d = 80, 112, 32, 32
    scene = t_syn.make_scene(num_landmarks=150, num_frames=8, height=h,
                             width=w, desc_dim=d, seed=5)
    sp = SuperPointNet(descriptor_dim=d, channels=(8, 8, 16, 16, 16, 16, 32,
                                                   32))
    init_like_flax(sp, torch.Generator().manual_seed(0))
    packs = [ft.render_pack(scene, i, n) for i in range(8)]
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
             ft._pair_batch(packs, np.random.default_rng(0), 2).items()}
    opt = torch.optim.Adam(sp.parameters(), lr=2e-3)
    losses = []
    for _ in range(30):
        loss, _ = ft.superpoint_loss(sp, batch)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss))
        assert np.isfinite(losses[-1])
    assert losses[-1] < 0.7 * losses[0], losses


def test_short_training_runs():
    """train_superpoint (3 steps) then a 2-step train_lightglue on its
    weights, as the JAX test's smoke: finite losses, every weight of the
    matcher moved (q, k and v included), the same seed giving the same
    weights."""
    h, w, n, d = 80, 112, 32, 32
    scene = t_syn.make_scene(num_landmarks=150, num_frames=8, height=h,
                             width=w, desc_dim=d, seed=5)
    sp = SuperPointNet(descriptor_dim=d, channels=(8, 8, 16, 16, 16, 16, 32,
                                                   32))
    stats = {}
    assert ft.train_superpoint(sp, scene, 8, n, steps=3, device="cpu",
                               stats=stats) is sp
    assert np.isfinite(stats["last_loss"]), stats
    runs = []
    for _ in range(2):
        lg = LightGlueNet(dim=32, heads=2, layers=1, input_dim=d)
        # the trainer's own initialisation (seed 1)
        before = init_like_flax(LightGlueNet(dim=32, heads=2, layers=1,
                                             input_dim=d),
                                torch.Generator().manual_seed(1))
        stats = {}
        ft.train_lightglue(lg, sp, scene, 8, n, steps=2, batch_size=1,
                           device="cpu", stats=stats)
        assert np.isfinite(stats["first_loss"]), stats
        assert np.isfinite(stats["last_loss"]), stats
        for k, v in before.state_dict().items():
            if k.endswith("weight"):
                assert not torch.equal(lg.state_dict()[k], v), k
        runs.append(lg.state_dict())
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k


def test_flagship_matcher_steps_match_jax():
    """Five clip + Adam (8e-4, the matcher trainer's) steps of the
    flagship-width matcher (256 wide, 2 heads, 9 layers) in float32 on one
    batch of 2 pairs (64 GT keypoints of the tiny scene, each descriptor
    its landmark's plus noise), from one Flax initialisation: the losses
    agree within 1e-3 relative (observed 1e-4: f32 sums in another order,
    amplified by each step), and in both packages the loss climbs above
    its first value within the five steps: the reference's recipe on a
    9-layer matcher without normalisation layers, not the port."""
    import optax

    from gl_slam_tpu.models.lightglue import LightGlueNet as JLightGlue

    n, d = 64, 256
    scene = j_syn.make_scene(num_landmarks=700, num_frames=4, height=H,
                             width=W, desc_dim=d, seed=7)
    packs = [jft.render_pack(scene, i, n) for i in range(4)]
    batch = jft._pair_batch(packs, np.random.default_rng(1), 2,
                            augment=False)
    rng = np.random.default_rng(2)
    desc = []
    for k in ("a", "b"):
        lid = batch["lids_" + k]
        x = scene.descriptors[np.maximum(lid, 0)] \
            + 0.5 * rng.standard_normal(lid.shape + (d,))
        desc.append((x / np.linalg.norm(x, axis=-1, keepdims=True))
                    .astype(np.float32))
    nb = {"desc0": desc[0], "desc1": desc[1], "kpts0": batch["kpts_a"],
          "kpts1": batch["kpts_b"], "valid0": batch["valid_a"],
          "valid1": batch["valid_b"], "lids0": batch["lids_a"],
          "lids1": batch["lids_b"]}
    jl = JLightGlue(dim=d, heads=2, layers=9, input_dim=d,
                    dtype=jnp.float32)
    kd, kk, km = jnp.zeros((8, d)), jnp.zeros((8, 2)), jnp.ones((8,), bool)
    params = jl.init(jax.random.PRNGKey(1), kd, kd, kk, kk, km, km)
    lg = LightGlueNet(dim=d, heads=2, layers=9, input_dim=d,
                      dtype=torch.float32)
    ckpt.load_module(lg, flat(params), ckpt.lightglue_state_dict)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(8e-4))
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in nb.items()}

    @jax.jit
    def step(p, st):
        loss, g = jax.value_and_grad(
            lambda q: jft.lightglue_loss(jl, q, jb, H, W))(p)
        upd, st = opt.update(g, st)
        return optax.apply_updates(p, upd), st, loss

    state = opt.init(params)
    topt = ft.ClipAdam(lg.parameters(), 8e-4)
    want, got = [], []
    for _ in range(5):
        params, state, loss = step(params, state)
        want.append(float(loss))
        loss = ft.lightglue_loss(lg, tb, H, W)
        topt.step(loss)
        got.append(float(loss.detach()))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert max(want) > want[0] and max(got) > got[0], (want, got)
