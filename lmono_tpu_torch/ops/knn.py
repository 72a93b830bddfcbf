"""Exact brute-force KNN over fixed-capacity masked point banks.

Port of `lmono_tpu/ops/knn.py`.  `knn` dispatches on the device of its
inputs: CUDA tensors go to the hand-written kernel
(`lmono_tpu_torch.ops.cuda.knn`, source `csrc/knn.cu`), CPU tensors to
`knn_plain`, the plain PyTorch version of the same function.  Both are exact
(the JAX package's TPU default was `approx_min_k` at 0.95 recall; its CPU
path is exact, and that is what the port matches).

Semantics shared by both: the k smallest squared distances per query,
ascending, with int32 indices; masked bank rows never match; missing
entries (fewer than k valid rows) have d² = 1e12 and index 0; ties go to
the earliest bank index.
"""

from __future__ import annotations

import torch

_INF = 1e12

# calls of `knn_plain`; read with the kernel's launch count to show which
# path a run took
knn_plain_calls = 0


def knn_plain(query: torch.Tensor, target: torch.Tensor,
              target_mask: torch.Tensor, k: int,
              chunk: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch exact KNN: the bank streams through in chunks and a
    running best-k is merged with each chunk's distances.

    d² uses the difference form (dx²+dy²+dz²), which has none of the
    q²−2q·t+t² expansion's cancellation at world magnitudes.  A stable sort
    over [best | chunk] keeps the earliest index first among equal
    distances, because the running best precedes the chunk and holds only
    earlier indices.
    """
    global knn_plain_calls
    knn_plain_calls += 1
    Q, M = query.shape[0], target.shape[0]
    best_d = torch.full((Q, k), _INF, dtype=query.dtype, device=query.device)
    best_i = torch.zeros((Q, k), dtype=torch.int64, device=query.device)
    for base in range(0, M, chunk):
        t = target[base:base + chunk]
        m = target_mask[base:base + chunk]
        d2 = torch.sum((query[:, None, :] - t[None, :, :]) ** 2, dim=-1)
        d2 = torch.where(m[None, :], d2, torch.full_like(d2, _INF))
        idx = torch.arange(base, base + t.shape[0], device=query.device)
        cat_d = torch.cat([best_d, d2], dim=1)
        cat_i = torch.cat([best_i, idx.expand(Q, -1)], dim=1)
        cat_d, order = torch.sort(cat_d, dim=1, stable=True)
        best_d = cat_d[:, :k]
        best_i = torch.gather(cat_i, 1, order[:, :k])
    return best_d, best_i.to(torch.int32)


def knn(query: torch.Tensor, target: torch.Tensor, target_mask: torch.Tensor,
        k: int, center: torch.Tensor | None = None
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest targets for each query point.

    query: (Q, 3); target: (M, 3); target_mask: (M,) bool.
    Returns (dists2 (Q, k), idx (Q, k) int32).  `center` recentres both
    point sets first (distances are translation invariant; small
    magnitudes keep f32 d² accurate); the CUDA kernel subtracts it as it
    loads the points, with the same f32 rounding.
    """
    if query.is_cuda:
        from lmono_tpu_torch.ops.cuda.knn import knn_cuda
        return knn_cuda(query.contiguous(), target.contiguous(),
                        target_mask.contiguous(), k,
                        center=None if center is None else center.contiguous())
    if center is not None:
        query = query - center
        target = target - center
    return knn_plain(query, target, target_mask, k)


def nn1(query: torch.Tensor, target: torch.Tensor,
        target_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Single nearest neighbor (the k=1 case)."""
    d, i = knn(query, target, target_mask, 1)
    return d[:, 0], i[:, 0]
