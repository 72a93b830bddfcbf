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

`select` ports the JAX package's reduced-precision neighbour selection
(`LidarConfig.knn_select`, read on its TPU route): "bf16x3" picks the exact
k smallest of the f32 expansion key (q² − 2·q·t) + t², "bf16" the same key
with the cross term formed from coordinates rounded to bf16; q² and t²
stay f32 over the recentred coordinates.  The k picks then get their exact
difference-form d², and are returned in selection order (ascending key,
ties to the earliest index), not re-sorted by d².  `knn_select_plain` is
the plain version of both keys.
"""

from __future__ import annotations

import math

import torch

_INF = 1e12
SELECT_MODES = ("exact", "bf16x3", "bf16")

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


def _sq_norm(p: torch.Tensor) -> torch.Tensor:
    """(x·x + y·y) + z·z in f32, in the kernel's order."""
    return (p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]) + p[:, 2] * p[:, 2]


def select_key_topk(query: torch.Tensor, target: torch.Tensor,
                    target_mask: torch.Tensor, k: int, select: str,
                    chunk: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest selection keys (q² − 2·q·t) + t² per query, ascending
    with the earliest index first among equal keys, and their int64
    indices; keys of 1e12 and above (masked rows, missing entries) never
    match, and a missing entry is (1e12, 0).  The cross term is formed over
    bf16-rounded coordinates for "bf16", over the f32 ones for "bf16x3";
    every product and sum is one f32 rounding, as in the kernel."""
    if select not in ("bf16x3", "bf16"):
        raise ValueError(f"select must be 'bf16x3' or 'bf16', got {select!r}")
    Q, M = query.shape[0], target.shape[0]
    if select == "bf16":
        qs = query.to(torch.bfloat16).to(query.dtype)
        ts = target.to(torch.bfloat16).to(target.dtype)
    else:
        qs, ts = query, target
    q2 = _sq_norm(query)[:, None]
    best_k = torch.full((Q, k), _INF, dtype=query.dtype, device=query.device)
    best_i = torch.zeros((Q, k), dtype=torch.int64, device=query.device)
    for base in range(0, M, chunk):
        t = ts[base:base + chunk]
        t2 = _sq_norm(target[base:base + chunk])
        dot = ((qs[:, None, 0] * t[None, :, 0] + qs[:, None, 1] * t[None, :, 1])
               + qs[:, None, 2] * t[None, :, 2])
        key = (q2 - 2.0 * dot) + t2[None, :]
        key = torch.where(target_mask[None, base:base + chunk], key,
                          torch.full_like(key, math.inf))
        idx = torch.arange(base, base + t.shape[0], device=query.device)
        cat_k, order = torch.sort(torch.cat([best_k, key], dim=1), dim=1,
                                  stable=True)
        best_k = cat_k[:, :k]
        best_i = torch.gather(torch.cat([best_i, idx.expand(Q, -1)], dim=1), 1,
                              order[:, :k])
    return best_k, best_i


def knn_select_plain(query: torch.Tensor, target: torch.Tensor,
                     target_mask: torch.Tensor, k: int, select: str,
                     chunk: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch reduced-precision selection: the k picks of
    `select_key_topk`, in selection order, with their exact difference-form
    d² (knn_plain's arithmetic); missing entries are (1e12, 0)."""
    global knn_plain_calls
    knn_plain_calls += 1
    key, idx = select_key_topk(query, target, target_mask, k, select, chunk)
    found = key < _INF
    d2 = torch.sum((query[:, None, :] - target[idx]) ** 2, dim=-1)
    d2 = torch.where(found, d2, torch.full_like(d2, _INF))
    return d2, idx.to(torch.int32)


def knn(query: torch.Tensor, target: torch.Tensor, target_mask: torch.Tensor,
        k: int, center: torch.Tensor | None = None, select: str = "exact"
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest targets for each query point.

    query: (Q, 3); target: (M, 3); target_mask: (M,) bool.
    Returns (dists2 (Q, k), idx (Q, k) int32).  `center` recentres both
    point sets first (distances are translation invariant; small
    magnitudes keep f32 d² accurate); the CUDA kernel subtracts it as it
    loads the points, with the same f32 rounding.  `select` is one of
    SELECT_MODES: "exact" returns the picks sorted by d²; the reduced modes
    (module docstring) in selection order.
    """
    if select not in SELECT_MODES:
        raise ValueError(f"select must be one of {SELECT_MODES}, got {select!r}")
    if query.is_cuda:
        from lmono_tpu_torch.ops.cuda.knn import knn_cuda
        return knn_cuda(query.contiguous(), target.contiguous(),
                        target_mask.contiguous(), k,
                        center=None if center is None else center.contiguous(),
                        select=select)
    if center is not None:
        query = query - center
        target = target - center
    if select == "exact":
        return knn_plain(query, target, target_mask, k)
    return knn_select_plain(query, target, target_mask, k, select)


def nn1(query: torch.Tensor, target: torch.Tensor,
        target_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Single nearest neighbor (the k=1 case)."""
    d, i = knn(query, target, target_mask, 1)
    return d[:, 0], i[:, 0]
