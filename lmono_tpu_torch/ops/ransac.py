"""Batched-hypothesis RANSAC for the fundamental matrix.

Port of the fundamental-matrix part of `lmono_tpu/ops/ransac.py` (`:23-77`
and the small linear algebra at `:121-174`).  All hypotheses are solved as
one batched program (8-point), scored in parallel, and the best kept.  The
reference's `vmap` over hypotheses is a leading batch dimension here.

The reference draws its samples from a JAX key, which torch cannot replay,
so `ransac_fundamental` takes the sample indices, and `masked_categorical`
turns Gumbel noise into them exactly as `jax.random.categorical` does.
PnP and the remaining helpers come with the loop slice.
"""

from __future__ import annotations

import torch


def gumbel_noise(shape: tuple, generator: torch.Generator,
                 device=None) -> torch.Tensor:
    """Standard Gumbel noise of `shape` drawn from `generator`."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def masked_categorical(mask: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """Indices drawn uniformly among `mask`'s set entries: mask (N,) bool,
    gumbel (..., N) standard Gumbel noise → (...) int64.

    `jax.random.categorical(key, logits[None], shape=s)` is
    `argmax(logits + gumbel(key, s + (N,)), -1)` with logits 0 on valid
    entries and −1e9 elsewhere; given the same noise, this is equal.
    """
    logits = torch.where(mask, 0.0, -1e9).to(gumbel.dtype)
    return torch.argmax(logits + gumbel, dim=-1)


def _eight_point(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Normalized 8-point: x0,x1 (..., 8, 2) normalized coords → F (..., 3, 3)."""
    u0, v0 = x0[..., 0], x0[..., 1]
    u1, v1 = x1[..., 0], x1[..., 1]
    A = torch.stack([u1 * u0, u1 * v0, u1, v1 * u0, v1 * v0, v1, u0, v0,
                     torch.ones_like(u0)], dim=-1)          # (..., 8, 9)
    # nullspace via unrolled Householder QR; rank-2 projection removes the
    # smallest right-singular component: F(I − nnᵀ) with n = argmin ‖F n‖
    F = _qr_nullvec(A).reshape(A.shape[:-2] + (3, 3))
    n = _nullvec(F, iters=24)
    Fn = (F @ n[..., None])[..., 0]
    return F - Fn[..., :, None] * n[..., None, :]


def _sampson(F: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Sampson distance of each correspondence under each F:
    F (..., 3, 3), x0/x1 (N, 2) normalized coords → (..., N)."""
    ones = torch.ones_like(x0[..., :1])
    p0 = torch.cat([x0, ones], -1)
    p1 = torch.cat([x1, ones], -1)
    Fx0 = p0 @ F.transpose(-1, -2)      # (..., N, 3)
    Ftx1 = p1 @ F                       # (..., N, 3)
    num = torch.sum(p1 * Fx0, dim=-1) ** 2
    den = Fx0[..., 0] ** 2 + Fx0[..., 1] ** 2 + Ftx1[..., 0] ** 2 + Ftx1[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def ransac_fundamental(x0: torch.Tensor, x1: torch.Tensor, mask: torch.Tensor,
                       samples: torch.Tensor, thresh: float = 1e-4
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """RANSAC F-matrix on normalized coords.

    x0,x1: (N,2); mask: (N,) valid correspondences; samples: (iters, 8)
    indices (see `masked_categorical`).  thresh is the squared Sampson
    distance in normalized units ((px/f)²).
    Returns (inlier_mask (N,), best_F (3,3)).
    """
    Fs = _eight_point(x0[samples], x1[samples])             # (iters,3,3)
    d = _sampson(Fs, x0, x1)                                # (iters,N)
    inl = (d < thresh) & mask[None, :]
    best = torch.argmax(inl.sum(dim=-1))
    # guard: degenerate sample sets (few valid) → accept everything valid
    enough = mask.sum() >= 9
    return torch.where(enough, inl[best], mask), Fs[best]


def _nullvec(A: torch.Tensor, iters: int = 48) -> torch.Tensor:
    """Unit vector minimizing ‖A v‖ when the spectral gap is healthy (e.g.
    projecting a near-rank-2 3×3 F): power iteration on M = c·I − AᵀA with
    c = tr(AᵀA) ≥ λmax."""
    AtA = A.transpose(-1, -2) @ A
    n = AtA.shape[-1]
    c = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    M = c * torch.eye(n, dtype=A.dtype, device=A.device) - AtA
    # deterministic full-spectrum init (no zero component in any basis dir)
    v = (torch.ones(AtA.shape[:-2] + (n,), dtype=A.dtype, device=A.device)
         + 0.1 * torch.arange(n, dtype=A.dtype, device=A.device))
    for _ in range(iters):
        v = (M @ v[..., None])[..., 0]
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)
    return v


def _qr_nullvec(A: torch.Tensor) -> torch.Tensor:
    """Nullspace vector of A (..., m, n) with m ∈ {n−1, n} and nullity 1:
    unrolled Householder QR, then back-substitution with the last variable
    pinned to 1 (`x[n-1] = 1`, as the reference does; ROADMAP Queue 3).
    Returns a unit (..., n) vector."""
    m, n = A.shape[-2], A.shape[-1]
    batch = A.shape[:-2]
    R = A
    r = min(m, n - 1)              # columns to eliminate
    for k in range(r):
        col = R[..., k:, k]                              # (..., m-k)
        nrm = torch.sqrt(torch.sum(col * col, dim=-1, keepdim=True))
        s = torch.where(col[..., :1] >= 0, 1.0, -1.0)
        e0 = torch.zeros(m - k, dtype=A.dtype, device=A.device)
        e0[0] = 1.0
        v = col + s * nrm * e0
        vn2 = torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=1e-30)
        sub = R[..., k:, :]                              # (..., m-k, n)
        proj = (v[..., None, :] @ sub)[..., 0, :]        # (..., n)
        sub = sub - (2.0 / vn2)[..., None] * v[..., :, None] * proj[..., None, :]
        R = torch.cat([R[..., :k, :], sub], dim=-2)
    # back-substitution: x[n-1] = 1, solve the r×r upper block
    x = [torch.ones(batch, dtype=A.dtype, device=A.device)
         for _ in range(r, n)]
    x = [None] * r + x
    for i in reversed(range(r)):
        s = torch.zeros(batch, dtype=A.dtype, device=A.device)
        for j2 in range(i + 1, n):
            s = s + R[..., i, j2] * x[j2]
        d = R[..., i, i]
        tiny = torch.where(d < 0, -1e-12, 1e-12).to(A.dtype)
        d = torch.where(torch.abs(d) < 1e-12, tiny, d)
        x[i] = -s / d
    v = torch.stack(x, dim=-1)
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)
