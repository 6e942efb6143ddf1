"""Front-end training's pieces against the JAX package: the two losses and
all their gradients, the training data and draws, the optimiser step, the
Flax-default initialiser and the attention's gradient.

Shapes are tests/test_learned_e2e.py::test_training_steps_reduce_losses':
80x112 frames, N 32, D 32, SuperPoint channels (8,8,16,16,16,16,32,32),
LightGlue 32 wide with 2 heads and 2 layers. The Flax references are built
with dtype=float32 by constructor argument (one case each in bfloat16) at
"highest" matmul precision (tests/conftest.py); both packages start from
the Flax initialisation, carried into the port by its checkpoint loaders.
Gradients are compared in the Flax layout, through `save_params`.
"""

import copy

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from gl_slam_tpu.io import synthetic as j_syn
from gl_slam_tpu.models import subpix as j_subpix
from gl_slam_tpu.models.lightglue import LightGlueNet as JLightGlue
from gl_slam_tpu.models.superpoint import SuperPointNet as JSuperPoint
from gl_slam_tpu.ops import attention as j_attn
from gl_slam_tpu.train import frontend_train as jft
from gl_slam_tpu_torch import checkpoint as ckpt
from gl_slam_tpu_torch.io import synthetic as t_syn
from gl_slam_tpu_torch.models import init_like_flax
from gl_slam_tpu_torch.models import subpix as t_subpix
from gl_slam_tpu_torch.models.lightglue import LightGlueNet
from gl_slam_tpu_torch.models.superpoint import SuperPointNet
from gl_slam_tpu_torch.ops import attention as t_attn
from gl_slam_tpu_torch.train import frontend_train as ft

torch.set_num_threads(1)

H, W, N, D = 80, 112, 32, 32
SP_CH = (8, 8, 16, 16, 16, 16, 32, 32)
LG = dict(dim=32, heads=2, layers=2)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def flat(params):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}


def grads_as_flax(module, tmp_path):
    """The module's .grad of every parameter, in the Flax layout."""
    g = copy.deepcopy(module)
    with torch.no_grad():
        for a, b in zip(g.parameters(), module.parameters()):
            a.copy_(b.grad)
    path = str(tmp_path / "grads.npz")
    ckpt.save_params(path, g)
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def check_grads(got, want, case):
    """float32: every element within 1e-5 x the network's largest gradient
    element, and every leaf that carries at least 1e-6 of the gradient's
    norm within 1e-4 of its norm (leaves below that are rounding noise of
    an exact zero: a key bias shifts every logit of a query by the same
    amount, which the softmax cancels). bfloat16: one rounding of 2^-8
    per op through the network; the whole gradient within 5 % of its norm
    and every element within 0.1 x the largest."""
    assert set(got) == set(want)
    G = max(float(np.abs(v).max()) for v in want.values())
    total = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                        for v in want.values()))
    diff = np.sqrt(sum(float(((got[k] - want[k]).astype(np.float64) ** 2)
                             .sum()) for k in want))
    if case == "bf16":
        assert diff <= 0.05 * total, diff / total
        for k in want:
            assert np.abs(got[k] - want[k]).max() <= 0.1 * G, k
        return
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= 1e-5 * G, k
        norm = np.linalg.norm(want[k])
        if norm >= 1e-6 * total:
            assert np.linalg.norm(got[k] - want[k]) <= 1e-4 * norm, k


@pytest.fixture(scope="module")
def packs():
    scene = j_syn.make_scene(num_landmarks=150, num_frames=8, height=H,
                             width=W, desc_dim=D, seed=5)
    return [jft.render_pack(scene, i, N) for i in range(8)]


def _tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


@pytest.mark.parametrize("case", sorted(DTYPES))
def test_superpoint_loss_and_grads_match_jax(packs, case, tmp_path):
    jdt, tdt = DTYPES[case]
    batch = jft._pair_batch(packs, np.random.default_rng(0), 2)
    jsp = JSuperPoint(descriptor_dim=D, channels=SP_CH, dtype=jdt)
    jp = jsp.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 1)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: jft.superpoint_loss(jsp, p, jb), has_aux=True))(jp)
    sp = SuperPointNet(descriptor_dim=D, channels=SP_CH, dtype=tdt)
    ckpt.load_module(sp, flat(jp), ckpt.superpoint_state_dict)
    loss, aux = ft.superpoint_loss(sp, _tensors(batch))
    loss.backward()
    # f32: the CE and the InfoNCE sums agree to a few f32 roundings
    # (observed 1e-7 relative); bf16: the logits round to 2^-8 relative
    # (observed 3e-5 relative on the sum).
    rtol = 1e-6 if case == "f32" else 1e-3
    for got, want in ((loss, jl), (aux["det"], jaux["det"]),
                      (aux["desc"], jaux["desc"])):
        assert abs(float(got) - float(want)) <= rtol * abs(float(want))
    check_grads(grads_as_flax(sp, tmp_path), flat(jg), case)


def _lightglue_batch(packs):
    batch = jft._pair_batch(packs, np.random.default_rng(1), 2,
                            augment=False)
    rng = np.random.default_rng(2)
    desc = rng.standard_normal((2, 2, N, D)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    return {"desc0": desc[0], "desc1": desc[1],
            "kpts0": batch["kpts_a"], "kpts1": batch["kpts_b"],
            "valid0": batch["valid_a"], "valid1": batch["valid_b"],
            "lids0": batch["lids_a"], "lids1": batch["lids_b"]}


@pytest.mark.parametrize("case", sorted(DTYPES))
def test_lightglue_loss_and_grads_match_jax(packs, case, tmp_path):
    jdt, tdt = DTYPES[case]
    batch = _lightglue_batch(packs)
    assert batch["valid0"].sum() > 10          # matched pairs exist
    jlg = JLightGlue(input_dim=D, dtype=jdt, **LG)
    kd, kk, km = jnp.zeros((8, D)), jnp.zeros((8, 2)), jnp.ones((8,), bool)
    jp = jlg.init(jax.random.PRNGKey(1), kd, kd, kk, kk, km, km)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jft.lightglue_loss(jlg, p, jb, H, W)))(jp)
    lg = LightGlueNet(input_dim=D, dtype=tdt, **LG)
    ckpt.load_module(lg, flat(jp), ckpt.lightglue_state_dict)
    loss = ft.lightglue_loss(lg, _tensors(batch), H, W)
    loss.backward()
    # observed: equal in f32, 2e-5 relative in bf16
    rtol = 1e-6 if case == "f32" else 1e-3
    assert abs(float(loss) - float(jl)) <= rtol * abs(float(jl))
    check_grads(grads_as_flax(lg, tmp_path), flat(jg), case)


def test_superpoint_logits_match_jax(packs):
    """return_logits gives Flax's (B, Hc, Wc, 65) cell logits."""
    jsp = JSuperPoint(descriptor_dim=D, channels=SP_CH, dtype=jnp.float32)
    jp = jsp.init(jax.random.PRNGKey(3), jnp.zeros((1, H, W, 1)))
    img = np.stack([p.image for p in packs[:2]])[..., None]
    _, _, want = jsp.apply(jp, img, return_logits=True)
    sp = SuperPointNet(descriptor_dim=D, channels=SP_CH, dtype=torch.float32)
    ckpt.load_module(sp, flat(jp), ckpt.superpoint_state_dict)
    with torch.no_grad():
        _, _, got = sp(torch.from_numpy(img), return_logits=True)
    assert got.shape == (2, H // 8, W // 8, 65)
    # f32 convolutions summed in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_cell_labels_match_jax():
    rng = np.random.default_rng(4)
    kpts = rng.uniform(-4, [W + 4, H + 4], (200, 2)).astype(np.float32)
    kpts[10] = kpts[11] + 0.3                  # a collision: the last wins
    kpts[20] = (W - 0.5, 12.5)                 # rounds out of the image
    valid = rng.uniform(size=200) < 0.8
    np.testing.assert_array_equal(ft.cell_labels(kpts, valid, H, W),
                                  jft.cell_labels(kpts, valid, H, W))


def test_render_pack_matches_jax():
    kw = dict(num_landmarks=150, num_frames=4, height=H, width=W,
              desc_dim=D, seed=5)
    js, ts = j_syn.make_scene(**kw), t_syn.make_scene(**kw)
    for i in (0, 3):
        want, got = jft.render_pack(js, i, N), ft.render_pack(ts, i, N)
        for name in ft.FramePack._fields:
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))


@pytest.mark.parametrize("augment", [False, True])
def test_pair_batch_matches_jax(packs, augment):
    scene_of = np.repeat([0, 1], 4)
    for seed in range(3):
        want = jft._pair_batch(packs, np.random.default_rng(seed), 3,
                               augment=augment, scene_of=scene_of)
        got = ft._pair_batch(packs, np.random.default_rng(seed), 3,
                             augment=augment, scene_of=scene_of)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_sample_pairs_match_jax():
    scene_of = np.repeat([0, 1, 2], 12)
    for seed in range(4):
        for age_max in (1, 6):
            want = jft._sample_pairs(np.random.default_rng(seed), scene_of,
                                     4, age_max=age_max)
            got = ft._sample_pairs(np.random.default_rng(seed), scene_of,
                                   4, age_max=age_max)
            assert len(got) == 3
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    # At age_max 0 the JAX package's draw raises (rng.integers(1, 1)); the
    # port draws in-scene pairs with a gap of 1 or 2.
    with pytest.raises(ValueError):
        jft._sample_pairs(np.random.default_rng(0), scene_of, 4)
    ia, ib = ft._sample_pairs(np.random.default_rng(0), scene_of, 64)
    assert set(ib - ia) <= {1, 2}
    assert (scene_of[ia] == scene_of[ib]).all()


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])
def test_clip_adam_steps_match_optax(grad_scale):
    """Three clip + Adam steps on the same gradients: the global norm below
    1 (no clip) and above it. Equal to f32 rounding of the parameters."""
    rng = np.random.default_rng(5)
    shapes = [(7, 5), (5,), (3, 3, 2, 4)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(grad_scale * rng.standard_normal(s)).astype(np.float32)
              for s in shapes] for _ in range(3)]
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    topt = ft.ClipAdam(tp, 1e-3)
    for g in grads:
        upd, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        norm = float(topt.clip())
        assert (norm > 1.0) == (grad_scale > 1.0)
        topt.adam.step()
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-6,
                                   atol=1e-7)


def _nets():
    """(port module, Flax module, Flax init args) of the four networks."""
    kd, kk, km = jnp.zeros((8, D)), jnp.zeros((8, 2)), jnp.ones((8,), bool)
    p7 = jnp.zeros((4, 7, 7))
    return {
        "superpoint": (SuperPointNet(descriptor_dim=D, channels=SP_CH),
                       JSuperPoint(descriptor_dim=D, channels=SP_CH),
                       (jnp.zeros((1, H, W, 1)),)),
        "lightglue": (LightGlueNet(input_dim=D, **LG),
                      JLightGlue(input_dim=D, **LG),
                      (kd, kd, kk, kk, km, km)),
        "subpix": (t_subpix.SubpixHead(D, patch=7),
                   j_subpix.SubpixHead(patch=7),
                   (p7, jnp.zeros((4, D)))),
        "pair_subpix": (t_subpix.PairSubpixHead(D, patch=7),
                        j_subpix.PairSubpixHead(patch=7),
                        (p7, p7, jnp.zeros((4, D)), jnp.zeros((4, D)),
                         jnp.zeros((4,)))),
    }


@pytest.mark.parametrize("net", ["superpoint", "lightglue", "subpix",
                                 "pair_subpix"])
def test_init_like_flax_statistics(net, tmp_path):
    """Every kernel a truncated normal of variance 1 / fan_in within +-2 of
    its scale, every bias zero, as Flax's defaults; the same generator seed
    gives the same weights."""
    module, jmod, args = _nets()[net]
    init_like_flax(module, torch.Generator().manual_seed(0))
    path = str(tmp_path / "init.npz")
    ckpt.save_params(path, module)
    with np.load(path) as data:
        got = {k: data[k] for k in data.files}
    want = flat(jmod.init(jax.random.PRNGKey(0), *args))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k.endswith("['bias']"):
            assert not g.any() and not w.any(), k
            continue
        fan_in = int(np.prod(w.shape[:-1]))
        std = 1.0 / np.sqrt(fan_in)
        limit = 2 * std / 0.87962566103423978
        for a in (g, w):
            assert np.abs(a).max() <= limit * (1 + 1e-6), k
            # sampling error of a standard deviation over n draws:
            # ~1/sqrt(2n) relative; 6 of those, and at least 10 %
            tol = max(0.1, 6 / np.sqrt(2 * a.size))
            assert abs(a.std() / std - 1) <= tol, (k, a.std() / std)
            assert abs(a.mean()) <= 6 * std / np.sqrt(a.size), k
    again = copy.deepcopy(module)
    init_like_flax(again, torch.Generator().manual_seed(0))
    for a, b in zip(again.parameters(), module.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attention_autograd_matches_jax_vjp(dtype):
    """attention() on the CPU (the plain version) under autograd against
    jax.vjp of attention_xla: a ragged mask and a fully masked set."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, 2, n, 32)).astype(np.float32)
               for n in (24, 40, 40))
    mask = rng.uniform(size=(2, 40)) < 0.7
    mask[1] = False
    g = rng.standard_normal((2, 2, 24, 32)).astype(np.float32)
    scale = 32 ** -0.5
    ref, grads = [], []
    for s in range(2):
        out, vjp = jax.vjp(lambda a, b, c: j_attn.attention_xla(
            a, b, c, jnp.asarray(mask[s]), scale),
            *(jnp.asarray(x[s], jdt) for x in (q, k, v)))
        ref.append(np.asarray(out))
        grads.append([np.asarray(x, np.float32)
                      for x in vjp(jnp.asarray(g[s]))])
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    out = t_attn.attention(tq, tk, tv, torch.from_numpy(mask), scale)
    out.backward(torch.from_numpy(g))
    # f32: a few roundings; bf16: the inputs are equal bf16 numbers, the
    # probabilities round to bf16 once in each (2^-8) and the gradients
    # round to bf16 on the way out.
    tol = 1e-5 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(out.detach().numpy(), np.stack(ref),
                               atol=tol * np.abs(ref).max(), rtol=0)
    for t, i in ((tq, 0), (tk, 1), (tv, 2)):
        assert t.grad.dtype == tdt
        want = np.stack([gr[i] for gr in grads])
        np.testing.assert_allclose(t.grad.float().numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max())
