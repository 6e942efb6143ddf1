"""Carry the JAX package's trained weights into the port's modules.

The committed checkpoints
(`checkpoints/{sp,lg,ks,kspair}_{tiny,flagship}.npz`)
are flat npz trees keyed by `jax.tree_util.keystr` of the Flax parameter
tree, e.g. "['params']['layer0']['self_attn']['q']['kernel']". This module
reads them with numpy alone and turns them into the port's `state_dict`s:

  * Conv kernels go from HWIO to OIHW;
  * Dense kernels go from (in, out) to the `nn.Linear` layout (out, in);
  * the matcher's batched attention modules (`nn.vmap` with broadcast
    params) share the parameter tree of the per-set calls, so one
    `self_attn` / `cross_attn` entry serves both GlueLayer paths.

`save_params` is the inverse: it writes a module the port trained as such
a flat npz, which the JAX package's `load_params` reads.

It also saves and restores a tracking state (`save_state` /
`load_state`) and writes and reads trajectories as KITTI pose rows.
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


def subpix_state_dict(flat: Mapping[str, np.ndarray]) -> dict:
    """SubpixHead or PairSubpixHead params (Flax `Dense_0..2`, in call
    order; `ks_*.npz` and `kspair_*.npz`) -> the port's head's state_dict
    (`dense0..2`)."""
    out = {}
    for key, a in flat.items():
        p = _path(key)
        if len(p) != 2 or not re.fullmatch(r"Dense_[0-2]", p[0]):
            raise KeyError(f"unexpected sub-pixel head parameter {key}")
        k, v = _leaf(f"dense{p[0][-1]}", p[1], a)
        out[k] = v
    return out


_GLUE_MLP_FLAX = {v: k for k, v in _GLUE_MLP.items()}


def _flax_path(kind: str, name: str) -> tuple:
    """A state_dict entry's module path (e.g. "layers.0.mlp_s.2") -> its
    Flax path (e.g. ('layer0', 'Dense_1'))."""
    p = name.split(".")
    if kind == "SuperPointNet":
        if p[0] == "blocks":
            return (f"_VGGBlock_{int(p[1])}", "Conv_0")
        return ({"det": "Conv_0", "desc": "Conv_1"}[p[0]],)
    if kind == "LightGlueNet":
        if p[0] == "layers":
            layer, rest = f"layer{int(p[1])}", ".".join(p[2:])
            if rest in _GLUE_MLP_FLAX:
                return (layer, _GLUE_MLP_FLAX[rest])
            return (layer, *p[2:])
        return tuple(p)                   # inp, final, matchability, rope
    return (f"Dense_{int(p[0][5:])}",)    # the sub-pixel heads' dense0..2


def save_params(path: str, module: torch.nn.Module) -> None:
    """Write `module` (a SuperPointNet, LightGlueNet, SubpixHead or
    PairSubpixHead) as a flat npz in the Flax layout, keyed by
    `jax.tree_util.keystr` of the parameter tree: Conv weights OIHW ->
    HWIO, Dense weights (out, in) -> (in, out), float32. The space-to-depth
    stem's input channels and the detector head's 65 output channels are
    already in the JAX order (models/superpoint.py), so they map back as
    they are. np.savez appends ".npz" to a path without it."""
    kind = type(module).__name__
    if kind not in ("SuperPointNet", "LightGlueNet", "SubpixHead",
                    "PairSubpixHead"):
        raise TypeError(f"save_params: no Flax layout for {kind}")
    arrays = {}
    for name, t in module.state_dict().items():
        owner, leaf = name.rsplit(".", 1)
        a = t.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            leaf = "kernel"
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        elif leaf != "bias":
            raise KeyError(f"save_params: unexpected parameter {name}")
        key = "".join(f"['{p}']" for p in ("params", *_flax_path(kind, owner),
                                           leaf))
        arrays[key] = np.ascontiguousarray(a)
    np.savez(path, **arrays)


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


STATE_FILE = "state.npz"


def _flatten_state(state, prefix: str = "") -> dict:
    """{dotted field name: tensor or None} of a NamedTuple of tensors,
    nested NamedTuples (the TrackState's map) flattened."""
    out = {}
    for name, v in state._asdict().items():
        if hasattr(v, "_asdict"):
            out.update(_flatten_state(v, f"{prefix}{name}."))
        else:
            out[prefix + name] = v
    return out


def save_state(path: str, state) -> None:
    """Save a TrackState or MapState to `<path>/state.npz`: one array per
    field (dotted names for the nested map), bfloat16 fields as their raw
    16-bit patterns, and the dtype of each field, so `load_state` restores
    it bit for bit. Fields that are None are not stored."""
    os.makedirs(path, exist_ok=True)
    arrays, dtypes = {}, []
    for name, v in _flatten_state(state).items():
        if v is None:
            continue
        t = v.detach().cpu()
        dtypes.append(f"{name}:{str(t.dtype).removeprefix('torch.')}")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arrays[name] = t.numpy()
    # compressed: a fixed-capacity state is mostly empty rows
    np.savez_compressed(os.path.join(path, STATE_FILE),
                        __dtypes__=np.array(dtypes), **arrays)


def load_state(path: str, like):
    """Restore a state saved by `save_state` from directory `path`. `like`
    (a state of the same type and capacities, e.g. a fresh
    `frontend.init_track_state`) gives the structure, the shapes, the
    dtypes and the device; a missing, extra or differently shaped or typed
    field raises. The JAX package's orbax checkpoint directories are not
    read."""
    with np.load(os.path.join(path, STATE_FILE)) as data:
        stored = dict(s.split(":") for s in data["__dtypes__"].tolist())
        want = _flatten_state(like)
        have = {n for n, v in want.items() if v is not None}
        if set(stored) != have:
            raise ValueError(
                f"state fields differ: missing {sorted(have - set(stored))}, "
                f"unexpected {sorted(set(stored) - have)}")
        values = {}
        for name in have:
            ref = want[name]
            dtype = str(ref.dtype).removeprefix("torch.")
            if stored[name] != dtype:
                raise ValueError(f"{name}: stored dtype {stored[name]} != "
                                 f"{dtype}")
            t = torch.from_numpy(np.array(data[name]))
            if ref.dtype == torch.bfloat16:
                t = t.view(torch.bfloat16)
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"{name}: stored shape {tuple(t.shape)} != "
                                 f"{tuple(ref.shape)}")
            values[name] = t.to(ref.device)

    def build(tmpl, prefix=""):
        kw = {}
        for name, v in tmpl._asdict().items():
            if hasattr(v, "_asdict"):
                kw[name] = build(v, f"{prefix}{name}.")
            else:
                kw[name] = values.get(prefix + name)
        return type(tmpl)(**kw)

    return build(like)


def export_kitti_trajectory(path: str, R: np.ndarray, t: np.ndarray) -> None:
    """Write world->camera poses as KITTI rows (camera-to-world 3x4), the
    text of the JAX package's writer byte for byte."""
    rows = []
    for i in range(len(R)):
        P = np.concatenate([R[i].T, (-R[i].T @ t[i])[:, None]], axis=1)
        rows.append(" ".join(f"{v:.9e}" for v in P.reshape(-1)))
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def load_kitti_trajectory(path: str):
    """KITTI rows (camera-to-world 3x4) -> world->camera (R (F,3,3), t)."""
    from .io.kitti import load_poses
    return load_poses(path)
