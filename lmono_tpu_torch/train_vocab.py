"""Train the place-recognition vocabulary (k-means over BRIEF descriptors).

Port of `examples/train_vocab.py`.  The reference ships an offline-trained
DBoW2 vocabulary (`brief_k10L6.bin`, k=10 L=6 hierarchical tree); this
trains the DBoW2-style construction: **hierarchical** spherical k-means
(branch k at each level, L levels → k^L leaf words) on BRIEF descriptors
harvested from rendered viewpoints of the ray-cast city with photometric
jitter (brightness/gamma).  The leaf centroids are stored as one flat
codebook, and `global_descriptor`'s argmax bucket is exactly the
nearest-leaf word (±1 descriptors have constant norm).

Runs on the CUDA card unless `--device` names another device.  Writes
`--out` (default: this package's `assets/vocab_brief_{bits}x{dim}.npz`, the
file `ops/brief.py:make_codebook` loads) with `codebook` (bits, dim)
float32 and `meta` int64 [descriptors, views, iters].

Usage:
    python -m lmono_tpu_torch.train_vocab --branch 10 --levels 3 \\
        --views 200 --iters 25                      # the shipped 1000 words
    python -m lmono_tpu_torch.train_vocab --dim 128  # flat k-means
        [--out FILE] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from lmono_tpu_torch import default_device
from lmono_tpu_torch.config import synthetic_config
from lmono_tpu_torch.io import synthetic as syn
from lmono_tpu_torch.ops.brief import BRIEF_BITS, brief_describe, vocab_asset_path
from lmono_tpu_torch.ops.corners import detect_grid
from lmono_tpu_torch.utils.lie import Pose, so3_exp_quat


def harvest(views: int, kp_per_view: int, cam_cfg, device=None) -> torch.Tensor:
    """BRIEF descriptors from random viewpoints in the ray-cast city, as
    (N, 256) float32 ±1 on `device`.

    Each view also contributes a photometrically jittered copy (brightness
    scale + gamma — BRIEF's pairwise comparisons are invariant to monotonic
    maps, but the blur + bilinear sampling make the bits only *nearly*
    invariant, and the jitter teaches the vocabulary that residual), with
    its keypoints detected anew.  Draws come from numpy's RandomState(3) in
    the reference's order, eight a view."""
    dev = default_device(device)
    scene = syn.make_city_scene(device=dev)
    rng = np.random.RandomState(3)
    no_uv = torch.zeros((1, 2), device=dev)
    no_mask = torch.zeros((1,), dtype=torch.bool, device=dev)

    def describe(img: torch.Tensor) -> torch.Tensor:
        uv, ok = detect_grid(img, 16, kp_per_view, no_uv, no_mask)
        return brief_describe(img, uv, ok)[ok]

    out, count = [], 0
    for v in range(views):
        # random position on/near the road network, random yaw, slight tilt
        ang = rng.uniform(0, 2 * np.pi)
        rad = rng.uniform(6.0, 18.0)
        t = torch.tensor([rad * np.cos(ang), rad * np.sin(ang),
                          rng.uniform(1.2, 2.2)], dtype=torch.float32, device=dev)
        ypr = torch.tensor([rng.uniform(0, 2 * np.pi), rng.uniform(-0.08, 0.08),
                            rng.uniform(-0.05, 0.05)], dtype=torch.float32,
                           device=dev)
        img = syn.render_camera(scene, Pose(t, so3_exp_quat(ypr)), cam_cfg)
        out.append(describe(img))
        scale = rng.uniform(0.6, 1.4)
        gamma = rng.uniform(0.7, 1.4)
        jimg = torch.clamp(torch.clamp(img * scale, 0.0, 1.0) ** gamma, 0.0, 1.0)
        out.append(describe(jimg))
        count += out[-2].shape[0] + out[-1].shape[0]
        if v % 40 == 0:
            print(f"view {v}/{views}: {count} descriptors", flush=True)
    return torch.cat(out).to(torch.float32)


def spherical_kmeans(X: torch.Tensor, k: int, iters: int, seed: int = 0,
                     reseed_idx: torch.Tensor | None = None):
    """Cosine k-means on constant-norm rows X (N, d); returns unit centroids
    (d, k), the mean best cosine and the share of occupied centroids.

    The initial centroids are rows `RandomState(seed).choice(N, k)`, as in
    the reference.  A centroid that no row chose is reseeded from row
    `reseed_idx[i, c]` at iteration i: an (iters, k) index tensor (the
    reference draws it from a JAX key chain, which torch cannot reproduce),
    by default drawn from a torch.Generator seeded with `seed`.  X @ C runs
    in full f32: the package keeps TF32 off (`lmono_tpu_torch/__init__.py`)."""
    dev = X.device
    N = X.shape[0]
    rng = np.random.RandomState(seed)
    init = torch.from_numpy(rng.choice(N, k, replace=False)).to(dev)
    if reseed_idx is None:
        g = torch.Generator(device=dev).manual_seed(seed)
        reseed_idx = torch.randint(0, N, (iters, k), generator=g, device=dev)
    reseed_idx = reseed_idx.to(dev)
    ones = torch.ones(N, device=dev)

    def normalize(C):
        return C / torch.clamp(torch.linalg.vector_norm(C, dim=0, keepdim=True),
                               min=1e-6)

    C = normalize(X[init].T)                                  # (d, k)
    for i in range(iters):
        a = torch.argmax(X @ C, dim=1)                        # (N,)
        sums = torch.zeros((k, X.shape[1]), device=dev).index_add_(0, a, X)
        cnt = torch.zeros(k, device=dev).index_add_(0, a, ones)
        # dead centroids re-seed from random rows
        newC = torch.where(cnt[:, None] > 0, sums, X[reseed_idx[i]]).T
        C = normalize(newC)
        sim = torch.max(X @ C, dim=1).values.mean()
        if i % 5 == 0 or i == iters - 1:
            occ = float((cnt > 0).float().mean())
            print(f"iter {i}: mean cos {float(sim):.4f}, "
                  f"occupied {100 * occ:.0f}%", flush=True)
    return C, float(sim), float((cnt > 0).float().mean())


def hierarchical_kmeans(X: torch.Tensor, branch: int, levels: int,
                        iters: int, seed: int = 0):
    """DBoW2-style vocabulary tree: recursive spherical k-means, `branch`
    children per node, `levels` deep → branch**levels leaf words.  Returns
    the flat (d, branch**levels) leaf-centroid codebook, the mean best
    cosine and the share of words used, both over X[:20000]."""
    def rec(idx: torch.Tensor, level: int, seed: int) -> list:
        if level == levels:
            # leaf: centroid of this cell (unit-normalized mean)
            c = X[idx].mean(dim=0)
            n = torch.linalg.vector_norm(c)
            return [c / n if float(n) > 1e-6 else c]
        k = min(branch, max(1, len(idx)))
        if len(idx) < 2 * branch:
            # too few descriptors to split further: pad with copies so the
            # leaf count stays branch**levels (duplicate words are harmless
            # — argmax ties resolve deterministically)
            leaf = rec(idx, levels, seed)
            return leaf * (branch ** (levels - level))
        C, _, _ = spherical_kmeans(X[idx], k, iters, seed=seed)
        a = torch.argmax(X[idx] @ C, dim=1)
        out = []
        for c in range(branch):
            sub = idx[a == min(c, k - 1)] if c < k else idx[a == k - 1]
            if len(sub) == 0:
                sub = idx[:1]
            out.extend(rec(sub, level + 1, seed * branch + c + 1))
        return out

    leaves = rec(torch.arange(len(X), device=X.device), 0, seed + 1)
    C = torch.stack(leaves, dim=1).to(torch.float32)          # (d, k^L)
    sim, occ = codebook_stats(X[:20000], C)
    return C, sim, occ


def codebook_stats(X: torch.Tensor, C: torch.Tensor) -> tuple[float, float]:
    """Mean best cosine of the rows X against the words C, and the share of
    words that are some row's best."""
    proj = X @ C
    sim = float(torch.max(proj, dim=1).values.mean())
    occ = len(torch.unique(torch.argmax(proj, dim=1))) / C.shape[1]
    return sim, occ


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=128,
                    help="flat k-means word count (ignored with --levels)")
    ap.add_argument("--branch", type=int, default=10)
    ap.add_argument("--levels", type=int, default=0,
                    help=">0: hierarchical k-means, branch**levels words")
    ap.add_argument("--views", type=int, default=160)
    ap.add_argument("--kp-per-view", type=int, default=200)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", type=str, default=None,
                    help="output npz (default: the package's vocabulary asset)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)

    cam_cfg = synthetic_config().camera
    t0 = time.perf_counter()
    X = harvest(args.views, args.kp_per_view, cam_cfg, device=dev)
    t_harvest = time.perf_counter() - t0
    print(f"harvested {len(X)} descriptors from {args.views} views")
    t0 = time.perf_counter()
    if args.levels > 0:
        args.dim = args.branch ** args.levels
        C, sim, occ = hierarchical_kmeans(X, args.branch, args.levels, args.iters)
    else:
        C, sim, occ = spherical_kmeans(X, args.dim, args.iters)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_kmeans = time.perf_counter() - t0

    path = args.out or vocab_asset_path(BRIEF_BITS, args.dim)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    meta = np.array([len(X), args.views, args.iters], np.int64)
    np.savez_compressed(path, codebook=C.cpu().numpy().astype(np.float32), meta=meta)
    print(f"wrote {path} (mean cos {sim:.4f}, occupancy {100 * occ:.0f}%; "
          f"harvest {t_harvest:.1f} s, k-means {t_kmeans:.1f} s)")
    return {"path": path, "codebook": C, "descriptors": X, "meta": meta,
            "sim": sim, "occ": occ, "harvest_s": t_harvest, "kmeans_s": t_kmeans}


if __name__ == "__main__":
    main()
