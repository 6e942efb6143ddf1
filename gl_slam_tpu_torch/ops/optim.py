"""Gauss-Newton least squares with fixed iteration counts.

Counterpart of gl_slam_tpu/ops/optim.py. Both solvers minimise
0.5 ||residual_fn(params)||^2 and return (params, final_cost); `params` is
a tensor or a tuple of tensors, and the residual a tensor or a tuple of
tensors. Every loop runs its full count (the JAX `lax.scan`): accept or
reject is a `torch.where`, never a host read, and the damping adapts x0.3
on an accepted step and x10 on a rejected one.

  * `gauss_newton_dense` builds J with `torch.func.jacfwd` and solves the
    dense damped normal equations exactly (pose graphs up to a few thousand
    parameters);
  * `gauss_newton_cg` is matrix-free: conjugate gradients on the normal
    equations, each product one forward-mode JVP and one VJP.

Both run in full f32: on the card TF32 is off (ops/precision.py).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import jacfwd, jvp, vjp


def _ravel(x):
    """(flat 1-D tensor, unravel) of a tensor or a tuple of tensors."""
    if torch.is_tensor(x):
        shape = x.shape
        return x.reshape(-1), lambda z: z.reshape(shape)
    shapes = [t.shape for t in x]
    sizes = [t.numel() for t in x]

    def unravel(z):
        return tuple(p.reshape(s) for p, s in
                     zip(torch.split(z, sizes), shapes))

    return torch.cat([t.reshape(-1) for t in x]), unravel


def _flat_residual(residual_fn, unravel):
    def fres(z):
        return _ravel(residual_fn(unravel(z)))[0]
    return fres


def gauss_newton_dense(residual_fn: Callable, params0, gn_iters: int = 6,
                       damping: float = 1e-8):
    """Exact Gauss-Newton steps via the dense normal equations
    H = J^T J + lam I (J by jacfwd, one batched JVP sweep), solved by LU.
    For chain-structured problems (pose graphs) the dense solve resolves
    every smooth mode in one step, where unpreconditioned CG needs O(C)
    iterations per mode."""
    flat0, unravel = _ravel(params0)
    fres = _flat_residual(residual_fn, unravel)
    n = flat0.shape[0]
    eye = torch.eye(n, dtype=flat0.dtype, device=flat0.device)
    z = flat0
    lam = torch.full((), damping, dtype=flat0.dtype, device=flat0.device)
    cost = None
    for _ in range(gn_iters):
        r = fres(z)
        J = jacfwd(fres)(z)                         # (R, P)
        H = J.T @ J + lam * eye
        g = J.T @ r
        # solve_ex neither raises nor waits for the device on a singular
        # system: like jnp.linalg.solve it hands back non-finite values,
        # which the accept test below rejects.
        dz, _ = torch.linalg.solve_ex(H, -g[:, None])
        z_new = z + dz[:, 0]
        c_old = 0.5 * (r * r).sum()
        rn = fres(z_new)
        c_new = 0.5 * (rn * rn).sum()
        accept = c_new < c_old
        z = torch.where(accept, z_new, z)
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 10.0),
                          1e-10, 1e8)
        cost = torch.where(accept, c_new, c_old)
    return unravel(z), cost


def gauss_newton_cg(residual_fn: Callable, params0, gn_iters: int = 10,
                    cg_iters: int = 50, damping: float = 1e-6,
                    step_clip: float = 1.0):
    """Levenberg-style Gauss-Newton with CG inner solves on
    (J^T J + lam I) dx = -J^T r; J is never built. The step is clipped to
    norm `step_clip` (trust region) before the accept test."""
    flat0, unravel = _ravel(params0)
    fres = _flat_residual(residual_fn, unravel)

    def cost(z):
        r = fres(z)
        return 0.5 * (r * r).sum()

    z = flat0
    lam = torch.full((), damping, dtype=torch.float32, device=flat0.device)
    c_out = None
    for _ in range(gn_iters):
        r, vjp_fn = vjp(fres, z)

        def hv(v):
            return lam * v + vjp_fn(jvp(fres, (z,), (v,))[1])[0]

        b = -vjp_fn(r)[0]
        x = torch.zeros_like(b)
        rr = b
        p = rr
        rs = (rr * rr).sum()
        for _ in range(cg_iters):
            Ap = hv(p)
            denom = (p * Ap).sum()
            alpha = rs / torch.where(denom.abs() < 1e-20, 1e-20, denom)
            x = alpha * p + x
            rr = -alpha * Ap + rr
            rs_new = (rr * rr).sum()
            beta = rs_new / torch.where(rs < 1e-20, 1e-20, rs)
            p = beta * p + rr
            rs = rs_new
        dx_norm = torch.sqrt((x * x).sum())
        x = torch.clamp(step_clip / torch.clamp_min(dx_norm, 1e-12),
                        max=1.0) * x
        z_new = z + x
        c_old = cost(z)
        c_new = cost(z_new)
        accept = c_new < c_old
        z = torch.where(accept, z_new, z)
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 10.0),
                          1e-9, 1e8)
        c_out = torch.where(accept, c_new, c_old)
    return unravel(z), c_out
