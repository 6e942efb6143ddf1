"""The port's networks (superpoint, lightglue, subpix, classical)."""

from __future__ import annotations

import math

import torch

# Flax's lecun_normal: a normal truncated at +-2 standard deviations,
# rescaled by this constant (the truncated unit normal's standard deviation)
# so that the result has variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


def init_like_flax(module: torch.nn.Module,
                   generator: torch.Generator) -> torch.nn.Module:
    """Re-initialise every `Dense` and `Conv` of `module` in place as Flax
    initialises `nn.Dense` and `nn.Conv` by default: kernels from
    lecun_normal (a truncated normal of variance 1 / fan_in, fan_in = the
    input features times the kernel's window), biases zero. Draws come
    from `generator` (a CPU generator gives the same weights on every
    device), one tensor per layer in `named_modules` order. Returns
    `module`."""
    from .lightglue import Dense
    from .superpoint import Conv
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    with torch.no_grad():
        for _, m in module.named_modules():
            if not isinstance(m, (Dense, Conv)):
                continue
            w = m.weight
            fan_in = w.numel() // w.shape[0]
            u = lo + (hi - lo) * torch.rand(w.shape, generator=generator,
                                            dtype=torch.float64,
                                            device=generator.device)
            x = math.sqrt(2) * torch.erfinv(u)
            w.copy_((x * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)).to(w))
            if m.bias is not None:
                m.bias.zero_()
    return module
