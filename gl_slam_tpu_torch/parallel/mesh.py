"""The stream-to-device map.

Counterpart of gl_slam_tpu/parallel/mesh.py. The JAX package lays the
stream axis of a multi-stream state over a 1-D `data` mesh of chips and
runs the chunk under `shard_map`, which keeps the program free of
collectives: streams are independent, so each chip runs the local-batch
chunk on its own share. Here the mesh is a list of devices, a sharded tree
is the list of its per-device parts (each moved to its device), and a
multi-stream chunk built with `devices=` (slam/fused.py) runs each part
on its own device with no operation across parts.

With one H100 the mesh is `[cuda:0]` and the split is the identity: one
part that holds every stream.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence

import torch

from ..slam.state import tree_map


def make_mesh(n_devices: Optional[int] = None) -> List[torch.device]:
    """The CUDA devices of this host (the first `n_devices` of them). Raises
    when there is no card or fewer than `n_devices`."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device available")
    n = torch.cuda.device_count() if n_devices is None else n_devices
    if n > torch.cuda.device_count():
        raise ValueError(f"make_mesh: {n} devices asked for, "
                         f"{torch.cuda.device_count()} present")
    return [torch.device("cuda", i) for i in range(n)]


def _bounds(num_streams: int, n_parts: int) -> List[slice]:
    if num_streams % n_parts:
        raise ValueError(f"{num_streams} streams do not split evenly over "
                         f"{n_parts} devices")
    per = num_streams // n_parts
    return [slice(p * per, (p + 1) * per) for p in range(n_parts)]


def stream_parts(num_streams: int, devices: Optional[Sequence] = None):
    """[(device or None, slice of the stream axis)] of each part: one part
    of every stream (device None: wherever the inputs are) without a
    device list."""
    if devices is None:
        return [(None, slice(0, num_streams))]
    devs = [torch.device(d) for d in devices]
    return list(zip(devs, _bounds(num_streams, len(devs))))


def stream_sharding(devices: Sequence):
    """The placement that splits the leading (stream) axis of every tensor
    of a tree evenly over `devices` (JAX: `NamedSharding(mesh, P("data"))`):
    a function tree -> list of per-device parts, as `shard_streams`."""
    return lambda tree: shard_streams(tree, devices)


def replicated(devices: Sequence):
    """The placement that puts a whole copy of a tree on each of `devices`
    (JAX: `NamedSharding(mesh, P())`): a function tree -> list of copies,
    one per device."""
    return lambda tree: [tree_map(lambda x, d=d: x.to(d), tree)
                         for d in (torch.device(d) for d in devices)]


def shard_streams(tree, devices: Sequence):
    """Split the leading (stream) axis of every tensor of `tree` evenly
    over `devices` -> the list of parts, part p moved to devices[p]. None
    stays None."""
    if tree is None:
        return None
    first = next(x for x in _leaves(tree))
    parts = stream_parts(first.shape[0], devices)
    return [tree_map(lambda x, d=d, sl=sl: x[sl].to(d), tree)
            for d, sl in parts]


def gather_streams(parts, device=None):
    """The parts of a sharded tree joined along the stream axis on
    `device` (default: the first part's)."""
    leaves0 = list(_leaves(parts[0]))
    dev = device if device is not None else leaves0[0].device
    flat = [list(_leaves(p)) for p in parts]
    joined = iter([torch.cat([f[i].to(dev) for f in flat])
                   for i in range(len(leaves0))])
    return tree_map(lambda _: next(joined), parts[0])


def _leaves(tree):
    if tree is None:
        return
    if isinstance(tree, tuple):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def module_on(module, device):
    """`module` if it already lives on `device` (or device is None), else
    a copy moved there. None stays None."""
    if module is None or device is None:
        return module
    p = next(module.parameters(), None)
    if p is None or p.device == torch.device(device):
        return module
    return copy.deepcopy(module).to(device)
