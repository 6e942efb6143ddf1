"""`checkpoint.save_params`, the inverse of the port's loaders.

A network the port initialised (models.init_like_flax, float32 compute) is
written with `save_params`; the JAX package's `load_params` reads the
file into the Flax parameter tree, and the Flax network's forward equals
the port's. The port's own loader gives back the state bit for bit, and
the committed checkpoints, loaded and saved again, come back with the same
keys and the same arrays.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gl_slam_tpu.checkpoint import load_params as j_load
from gl_slam_tpu.models import subpix as j_subpix
from gl_slam_tpu.models.lightglue import LightGlueNet as JLightGlue
from gl_slam_tpu.models.superpoint import SuperPointNet as JSuperPoint
from gl_slam_tpu_torch import checkpoint as ckpt
from gl_slam_tpu_torch import config as t_cfg
from gl_slam_tpu_torch.models import init_like_flax
from gl_slam_tpu_torch.models import subpix as t_subpix
from gl_slam_tpu_torch.models.lightglue import LightGlueNet
from gl_slam_tpu_torch.models.superpoint import SuperPointNet
from gl_slam_tpu_torch.train import e2e as t_e2e

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
H, W, D = 64, 96, 32
SP_CH = (8, 8, 16, 16, 16, 16, 32, 32)
LG = dict(dim=32, heads=2, layers=2)
f32 = jnp.float32


def _case(name, rng):
    """(port module, Flax module, Flax init args, forward inputs (numpy),
    state_dict converter)."""
    if name == "superpoint":
        img = rng.uniform(size=(2, H, W, 1)).astype(np.float32)
        return (SuperPointNet(descriptor_dim=D, channels=SP_CH,
                              dtype=torch.float32),
                JSuperPoint(descriptor_dim=D, channels=SP_CH, dtype=f32),
                (jnp.zeros((1, H, W, 1)),), (img,),
                ckpt.superpoint_state_dict)
    if name == "lightglue":
        n, m = 24, 24
        d0 = rng.standard_normal((n, D)).astype(np.float32)
        d1 = rng.standard_normal((m, D)).astype(np.float32)
        k0 = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
        k1 = rng.uniform(-1, 1, (m, 2)).astype(np.float32)
        m0, m1 = rng.uniform(size=n) < 0.8, rng.uniform(size=m) < 0.8
        z = (jnp.zeros((8, D)), jnp.zeros((8, D)), jnp.zeros((8, 2)),
             jnp.zeros((8, 2)), jnp.ones((8,), bool), jnp.ones((8,), bool))
        return (LightGlueNet(input_dim=D, dtype=torch.float32, **LG),
                JLightGlue(input_dim=D, dtype=f32, **LG), z,
                (d0, d1, k0, k1, m0, m1), ckpt.lightglue_state_dict)
    M, P = 16, 7
    pt0 = rng.uniform(size=(M, P, P)).astype(np.float32)
    pt1 = rng.uniform(size=(M, P, P)).astype(np.float32)
    d0 = rng.standard_normal((M, D)).astype(np.float32)
    d1 = rng.standard_normal((M, D)).astype(np.float32)
    if name == "subpix":
        return (t_subpix.SubpixHead(D, patch=P, dtype=torch.float32),
                j_subpix.SubpixHead(patch=P, dtype=f32),
                (jnp.zeros((4, P, P)), jnp.zeros((4, D))), (pt0, d0),
                ckpt.subpix_state_dict)
    s = rng.uniform(size=M).astype(np.float32)
    return (t_subpix.PairSubpixHead(D, patch=P, dtype=torch.float32),
            j_subpix.PairSubpixHead(patch=P, dtype=f32),
            (jnp.zeros((4, P, P)), jnp.zeros((4, P, P)), jnp.zeros((4, D)),
             jnp.zeros((4, D)), jnp.zeros((4,))),
            (pt0, pt1, d0, d1, s), ckpt.subpix_state_dict)


@pytest.mark.parametrize("name", ["superpoint", "lightglue", "subpix",
                                  "pair_subpix"])
def test_saved_params_load_in_jax_and_give_its_forward(name, tmp_path):
    rng = np.random.default_rng(len(name))
    module, jmod, init_args, inputs, convert = _case(name, rng)
    init_like_flax(module, torch.Generator().manual_seed(len(name)))
    path = str(tmp_path / f"{name}.npz")
    ckpt.save_params(path, module)

    # The JAX package's loader takes the file as its parameter tree.
    like = jmod.init(jax.random.PRNGKey(0), *init_args)
    jp = j_load(path, like)
    assert jax.tree_util.tree_structure(jp) == \
        jax.tree_util.tree_structure(like)
    want = jmod.apply(jp, *inputs)
    with torch.no_grad():
        got = module(*(torch.from_numpy(x) for x in inputs))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    # float32 through the same layers summed in another order
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1.0))

    # The port's loader gives the same state and forward bit for bit.
    again = _case(name, rng)[0]
    ckpt.load_module(again, path, convert)
    for k, v in module.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    with torch.no_grad():
        twice = again(*(torch.from_numpy(x) for x in inputs))
    twice = twice if isinstance(twice, tuple) else (twice,)
    for a, b in zip(twice, got):
        assert torch.equal(a, b)


def test_committed_checkpoints_save_back_unchanged(tmp_path):
    """Loaded into the port and saved again, every tiny checkpoint has the
    same keys and bit-equal arrays."""
    sp, lg = t_e2e.load_tiny_frontend(CKPT, device="cpu")
    nets = {"sp": sp, "lg": lg,
            "ks": t_e2e.load_tiny_subpix(CKPT, device="cpu"),
            "kspair": t_e2e.load_tiny_subpix(CKPT, pair=True, device="cpu")}
    for tag, module in nets.items():
        path = str(tmp_path / f"{tag}.npz")
        ckpt.save_params(path, module)
        with np.load(path) as got, \
                np.load(os.path.join(CKPT, f"{tag}_tiny.npz")) as want:
            assert sorted(got.files) == sorted(want.files), tag
            for k in want.files:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert t_cfg.TINY_DESC_DIM == sp.desc.out_channels


def test_save_params_refuses_other_modules(tmp_path):
    with pytest.raises(TypeError, match="no Flax layout"):
        ckpt.save_params(str(tmp_path / "x.npz"), torch.nn.Linear(2, 2))
