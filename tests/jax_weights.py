"""The JAX package's committed weights for the port's tests, without an
eager Flax init.

`gl_slam_tpu.train.e2e.load_tiny_frontend` runs `Module.init` op by op only
to learn each parameter tree's structure, ~25 s on the CPU; `jax.eval_shape`
gives the same structure without running anything. The arrays then come
from the JAX package's own `checkpoint.load_params`, so the result is the
same, leaf for leaf.
"""

import jax
import jax.numpy as jnp

from gl_slam_tpu.checkpoint import load_params, params_path
from gl_slam_tpu.models.lightglue import LightGlueNet
from gl_slam_tpu.models.superpoint import SuperPointNet
from gl_slam_tpu.train import e2e


def like(module, *args):
    """The parameter tree's structure of `module.init(PRNGKey(0), *args)`."""
    return jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)


def load(path, module, *args):
    """`load_params(path, module.init(PRNGKey(0), *args))`, without the
    init."""
    return load_params(path, like(module, *args))


def load_tiny_frontend(ckpt_dir="checkpoints"):
    """`e2e.load_tiny_frontend(ckpt_dir)`: (sp, sp_params, lg, lg_params)."""
    D = e2e.TINY_DESC_DIM
    sp = SuperPointNet(descriptor_dim=D, channels=e2e.TINY_SP_CHANNELS)
    lg = LightGlueNet(input_dim=D, **e2e.TINY_LG)
    d8, k8, m8 = jnp.zeros((8, D)), jnp.zeros((8, 2)), jnp.ones((8,), bool)
    return (sp, load(params_path(ckpt_dir, "sp_tiny"), sp,
                     jnp.zeros((1, 160, 240, 1))),
            lg, load(params_path(ckpt_dir, "lg_tiny"), lg, d8, d8, k8, k8,
                     m8, m8))


def cli_learned_frontend(args):
    """`gl_slam_tpu.cli._load_learned_frontend(args)` (the per-frame
    route's nets and weights), without the init."""
    from gl_slam_tpu.train.e2e import (FLAGSHIP_LG, FLAGSHIP_SP_CHANNELS,
                                       TINY_LG, TINY_SP_CHANNELS)
    D = args.desc_dim
    tiny = args.preset == "tiny"
    sp = SuperPointNet(descriptor_dim=D, channels=TINY_SP_CHANNELS if tiny
                       else FLAGSHIP_SP_CHANNELS)
    lg = LightGlueNet(input_dim=D, **(TINY_LG if tiny else FLAGSHIP_LG))
    H8 = args.height + (-args.height) % 8
    W8 = args.width + (-args.width) % 8
    d8, k8, m8 = jnp.zeros((8, D)), jnp.zeros((8, 2)), jnp.ones((8,), bool)
    return (sp, load(params_path(args.weights, f"sp_{args.preset}"), sp,
                     jnp.zeros((1, H8, W8, 1))),
            lg, load(params_path(args.weights, f"lg_{args.preset}"), lg,
                     d8, d8, k8, k8, m8, m8))
