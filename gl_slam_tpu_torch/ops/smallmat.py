"""LAPACK-free small-matrix linear algebra for the geometry path.

Counterpart of gl_slam_tpu/ops/smallmat.py (the subset the chunked tracker
reaches). Every solver is built from elementwise arithmetic and tiny
products over leading batch dimensions, so the results follow the JAX
package's closed forms step by step instead of a library eigensolver's:

  * `smallest_eigvec` — shifted inverse iteration through the unrolled
    Cholesky (8-point essential 9x9 Gram matrices);
  * `eigh3x3` / `svd3` — closed-form symmetric 3x3 eigendecomposition
    (Cardano) and the SVD built from it;
  * `cholesky_solve` — unrolled Cholesky for the 5x5/6x6 normal equations;
  * `inv3x3`, `det3x3`;
  * `scaled_solve` — the one library call: a Jacobi-scaled dense LU solve
    for the window BA's reduced camera system (`jnp.linalg.solve` there,
    `torch.linalg.solve_ex` here).

All functions take (..., n, n) batches and run in float32.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def _norm(x, keepdim=False):
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


def cholesky_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for small SPD A (..., n, n), b (..., n).

    Fully unrolled Cholesky + two triangular solves (n static)."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp_min(s, _EPS))
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def scaled_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Direct dense solve with symmetric Jacobi scaling, for small SPD
    systems with badly mixed parameter scales (a Schur-reduced camera
    system: rotation columns scale like f*depth, translation like f).

    x = D y where (D A D) y = D b, D = diag(A)^{-1/2}. `solve_ex` neither
    raises nor synchronises on a singular system: like `jnp.linalg.solve` it
    hands back whatever the LU gives (non-finite values, which the pipeline's
    health check catches)."""
    d = torch.diagonal(A, dim1=-2, dim2=-1)
    s = torch.rsqrt(torch.clamp_min(d.abs(), _EPS))
    As = A * s[..., :, None] * s[..., None, :]
    y, _ = torch.linalg.solve_ex(As, (b * s)[..., None])
    return y[..., 0] * s


def smallest_eigvec(M: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of symmetric PSD (..., n, n):
    inverse iteration with a tiny diagonal shift."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    scale = torch.clamp_min(tr, _EPS) / n
    Ms = M / scale + 1e-6 * eye
    v = (1.0 + 0.01 * torch.arange(n, dtype=M.dtype, device=M.device)
         ).expand(M.shape[:-1])
    for _ in range(iters):
        v = cholesky_solve(Ms, v)
        v = v / torch.clamp_min(_norm(v, keepdim=True), _EPS)
    return v


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse via the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    inv_det = 1.0 / torch.where(det.abs() < _EPS, torch.full_like(det, _EPS),
                                det)
    adj = torch.stack([torch.stack([A00, A01, A02], -1),
                       torch.stack([A10, A11, A12], -1),
                       torch.stack([A20, A21, A22], -1)], -2)
    return adj * inv_det[..., None, None]


def det3x3(A: torch.Tensor) -> torch.Tensor:
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2]
                            - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2]
                              - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1]
                              - A[..., 1, 1] * A[..., 2, 0]))


def _unit(k: int, like: torch.Tensor) -> torch.Tensor:
    """e_k along the last axis, shaped like `like`. A fill of the view:
    `e[..., k] = 1.0` copies the 1.0 from the host on a card, which makes
    the host wait for the stream."""
    e = torch.zeros_like(like)
    e[..., k].fill_(1.0)
    return e


def eigh3x3(A: torch.Tensor):
    """Closed-form eigendecomposition of symmetric 3x3 (batched).

    Returns (w ascending (..., 3), V (..., 3, 3) eigenvectors as columns)."""
    nrm = torch.clamp_min(A.abs().amax(dim=(-2, -1)), _EPS)
    A = A / nrm[..., None, None]
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    B = A - q[..., None, None] * eye
    p2 = (B * B).sum(dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp_min(p2, _EPS))
    r = det3x3(B) / (2.0 * torch.clamp_min(p, _EPS) ** 3)
    r = torch.clamp(r, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    w2 = q + 2.0 * p * torch.cos(phi)
    w0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    w1 = 3.0 * q - w0 - w2
    w = torch.stack([w0, w1, w2], dim=-1)

    def eigvec(wi):
        Bi = A - wi[..., None, None] * eye
        c01 = torch.linalg.cross(Bi[..., 0, :], Bi[..., 1, :], dim=-1)
        c02 = torch.linalg.cross(Bi[..., 0, :], Bi[..., 2, :], dim=-1)
        c12 = torch.linalg.cross(Bi[..., 1, :], Bi[..., 2, :], dim=-1)
        cands = torch.stack([c01, c02, c12], dim=-2)
        norms = _norm(cands)
        idx = torch.argmax(norms, dim=-1)
        v = torch.take_along_dim(
            cands, idx[..., None, None].expand(*idx.shape, 1, 3),
            dim=-2)[..., 0, :]
        n = _norm(v, keepdim=True)
        v = torch.where(n > 1e-20, v / torch.clamp_min(n, _EPS),
                        _unit(0, v))
        return v, norms.amax(dim=-1)

    va, qa = eigvec(w0)
    vb, qb = eigvec(w2)
    use_a = (qa >= qb)[..., None]
    prim = torch.where(use_a, va, vb)
    sec_raw = torch.where(use_a, vb, va)
    sec = sec_raw - (sec_raw * prim).sum(-1, keepdim=True) * prim
    sn = _norm(sec, keepdim=True)
    alt = torch.linalg.cross(prim, _unit(0, prim), dim=-1)
    alt2 = torch.linalg.cross(prim, _unit(1, prim), dim=-1)
    alt = torch.where(_norm(alt, keepdim=True) > 0.1, alt, alt2)
    alt = alt / torch.clamp_min(_norm(alt, keepdim=True), _EPS)
    sec = torch.where(sn > 1e-5, sec / torch.clamp_min(sn, _EPS), alt)
    v0 = torch.where(use_a, prim, sec)
    v2 = torch.where(use_a, sec, prim)
    v1 = torch.linalg.cross(v2, v0, dim=-1)
    v1 = v1 / torch.clamp_min(_norm(v1, keepdim=True), _EPS)
    V = torch.stack([v0, v1, v2], dim=-1)
    return w * nrm[..., None], V


def svd3(E: torch.Tensor):
    """SVD of (batched) 3x3 via eigh3x3(E^T E): (U, s descending, Vt)."""
    w, V = eigh3x3(E.transpose(-1, -2) @ E)
    V = V.flip(-1)
    s = torch.sqrt(torch.clamp_min(w.flip(-1), 0.0))
    u0 = (E @ V[..., 0:1])[..., 0]
    u0 = u0 / torch.clamp_min(_norm(u0, keepdim=True), _EPS)
    u1 = (E @ V[..., 1:2])[..., 0]
    u1 = u1 - (u1 * u0).sum(-1, keepdim=True) * u0
    u1 = u1 / torch.clamp_min(_norm(u1, keepdim=True), _EPS)
    u2 = torch.linalg.cross(u0, u1, dim=-1)
    Ev2 = (E @ V[..., 2:3])[..., 0]
    d = (u2 * Ev2).sum(-1, keepdim=True)
    sgn = torch.where(d.abs() > 1e-7, torch.sign(d), torch.ones_like(d))
    u2 = u2 * sgn
    U = torch.stack([u0, u1, u2], dim=-1)
    return U, s, V.transpose(-1, -2)


def block_jacobi_pcg(S: torch.Tensor, b: torch.Tensor,
                     iters: int) -> torch.Tensor:
    """Preconditioned conjugate gradients on a block-structured SPD system
    S (C, C, 6, 6), b (C, 6), for a fixed number of iterations. The
    preconditioner is the exact inverse of the (6, 6) diagonal blocks
    (through the unrolled Cholesky against the identity), which removes
    the rotation-against-translation scale mix that stalls plain float32
    CG on a Schur-reduced camera system."""
    C = S.shape[0]
    ar = torch.arange(C, device=S.device)
    diag = S[ar, ar]                                        # (C, 6, 6)
    eye = torch.eye(6, dtype=S.dtype, device=S.device)
    # column e of each inverse, then (C, 6, 6) with rows as in JAX
    Minv = cholesky_solve(diag[:, None].expand(C, 6, 6, 6),
                          eye.expand(C, 6, 6)).transpose(-1, -2)

    def mv(x):
        return torch.einsum('cdij,dj->ci', S, x)

    def pre(r):
        return torch.einsum('cij,cj->ci', Minv, r)

    x = torch.zeros_like(b)
    r = b
    z = pre(r)
    p = z
    rz = (r * z).sum()
    for _ in range(iters):
        Ap = mv(p)
        denom = (p * Ap).sum()
        alpha = rz / torch.where(denom.abs() < _EPS, _EPS, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = pre(r)
        rz_new = (r * z).sum()
        beta = rz_new / torch.where(rz.abs() < _EPS, _EPS, rz)
        p = z + beta * p
        rz = rz_new
    return x


def cg_solve(A: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Conjugate gradients with a Jacobi preconditioner for PSD A
    (..., n, n), b (..., n), for a fixed number of iterations (exact for
    iters >= n in exact arithmetic)."""
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    Minv = 1.0 / torch.clamp_min(diag.abs(), _EPS)

    def mv(x):
        return torch.einsum('...ij,...j->...i', A, x)

    x = torch.zeros_like(b)
    r = b
    z = Minv * r
    p = z
    rz = (r * z).sum(-1)
    for _ in range(iters):
        Ap = mv(p)
        denom = (p * Ap).sum(-1)
        alpha = rz / torch.where(denom.abs() < _EPS, _EPS, denom)
        x = x + alpha[..., None] * p
        r = r - alpha[..., None] * Ap
        z = Minv * r
        rz_new = (r * z).sum(-1)
        beta = rz_new / torch.where(rz.abs() < _EPS, _EPS, rz)
        p = z + beta[..., None] * p
        rz = rz_new
    return x
