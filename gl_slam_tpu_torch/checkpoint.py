"""Carry the JAX package's trained weights into the port's modules.

The committed checkpoints (`checkpoints/{sp,lg}_{tiny,flagship}.npz`) are
flat npz trees keyed by `jax.tree_util.keystr` of the Flax parameter tree,
e.g. "['params']['layer0']['self_attn']['q']['kernel']". This module reads
them with numpy alone and turns them into the port's `state_dict`s:

  * Conv kernels go from HWIO to OIHW;
  * Dense kernels go from (in, out) to the `nn.Linear` layout (out, in);
  * the matcher's batched attention modules (`nn.vmap` with broadcast
    params) share the parameter tree of the per-set calls, so one
    `self_attn` / `cross_attn` entry serves both GlueLayer paths.
"""

from __future__ import annotations

import os
import re
from typing import Mapping

import numpy as np
import torch


def params_path(out_dir: str, name: str) -> str:
    return os.path.join(out_dir, f"{name}.npz")


def load_params(path: str) -> dict:
    """The flat {keystr: np.ndarray} parameter dict of an npz checkpoint."""
    with np.load(path) as data:
        return {k: np.asarray(data[k]) for k in data.files}


def _path(key: str) -> tuple:
    """"['params']['a']['b']" -> ('a', 'b') (the leading 'params' dropped)."""
    parts = tuple(re.findall(r"\['([^']*)'\]", key))
    return parts[1:] if parts and parts[0] == "params" else parts


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _leaf(name: str, leaf: str, a: np.ndarray) -> tuple[str, torch.Tensor]:
    if leaf == "bias":
        return f"{name}.bias", _tensor(a)
    if leaf != "kernel":
        raise KeyError(f"unexpected parameter leaf {leaf!r} in {name}")
    if a.ndim == 4:                       # Conv HWIO -> OIHW
        return f"{name}.weight", _tensor(a.transpose(3, 2, 0, 1))
    if a.ndim == 2:                       # Dense (in, out) -> (out, in)
        return f"{name}.weight", _tensor(a.T)
    raise ValueError(f"{name}: kernel of rank {a.ndim}")


def superpoint_state_dict(flat: Mapping[str, np.ndarray]) -> dict:
    """SuperPointNet params -> the port's SuperPointNet state_dict.

    Flax names `_VGGBlock_i/Conv_0` (the ten 3x3 convs, in call order) and
    `Conv_0` / `Conv_1` (the 1x1 detector and descriptor heads)."""
    out = {}
    for key, a in flat.items():
        p = _path(key)
        if len(p) == 3 and p[0].startswith("_VGGBlock_"):
            name = f"blocks.{int(p[0].rsplit('_', 1)[1])}"
        elif p[:1] == ("Conv_0",):
            name = "det"
        elif p[:1] == ("Conv_1",):
            name = "desc"
        else:
            raise KeyError(f"unexpected SuperPointNet parameter {key}")
        k, v = _leaf(name, p[-1], a)
        out[k] = v
    return out


# GlueLayer's two nn.Sequential MLPs are created in the order mlp_s, mlp_c,
# so their Dense layers are Dense_0/1 (self) and Dense_2/3 (cross).
_GLUE_MLP = {"Dense_0": "mlp_s.0", "Dense_1": "mlp_s.2",
             "Dense_2": "mlp_c.0", "Dense_3": "mlp_c.2"}


def lightglue_state_dict(flat: Mapping[str, np.ndarray]) -> dict:
    """LightGlueNet params -> the port's LightGlueNet state_dict."""
    out = {}
    for key, a in flat.items():
        p = _path(key)
        if p[0] in ("inp", "final", "matchability") and len(p) == 2:
            name = p[0]
        elif p[:2] == ("rope", "freqs"):
            name = "rope.freqs"
        elif re.fullmatch(r"layer\d+", p[0]):
            layer = f"layers.{int(p[0][5:])}"
            if p[1] in _GLUE_MLP and len(p) == 3:
                name = f"{layer}.{_GLUE_MLP[p[1]]}"
            elif p[1] in ("self_attn", "cross_attn") and len(p) == 4:
                name = f"{layer}.{p[1]}.{p[2]}"
            else:
                raise KeyError(f"unexpected LightGlueNet parameter {key}")
        else:
            raise KeyError(f"unexpected LightGlueNet parameter {key}")
        k, v = _leaf(name, p[-1], a)
        out[k] = v
    return out


def load_module(module: torch.nn.Module, path_or_flat, convert) -> None:
    """Load a checkpoint (path or flat dict) into `module` in place, strict:
    every parameter must be present with its exact shape."""
    flat = load_params(path_or_flat) if isinstance(path_or_flat, str) \
        else path_or_flat
    sd = convert(flat)
    own = module.state_dict()
    for k, v in sd.items():
        if k not in own:
            raise KeyError(f"checkpoint parameter {k} has no counterpart")
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: checkpoint shape {tuple(v.shape)} != "
                             f"module shape {tuple(own[k].shape)}")
    module.load_state_dict(sd, strict=True)
