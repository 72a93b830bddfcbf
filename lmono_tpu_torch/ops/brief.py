"""Binary (BRIEF-style) descriptors and Hamming matching as matmuls.

Port of `lmono_tpu/ops/brief.py`.  Descriptors are 256 comparisons of
blurred intensities on a fixed pattern, stored as ±1 int8, so that the
Hamming distance is a matmul: ham(a, b) = (B − a·b)/2 for a, b ∈ {±1}^B.
The dot runs in f32 (integer matmuls have no CUDA kernel): sums of at most
B ±1 terms are exact in f32 with TF32 off, as the package keeps it.  Place
recognition scores come from a soft-BoW global descriptor: each local
descriptor votes for its nearest vocabulary word.

The vocabularies are the JAX package's assets, copied byte for byte into
`lmono_tpu_torch/assets/`; a (bits, dim) pair that ships no asset gets the
reference's random signed projection.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from lmono_tpu_torch.ops.image import bilinear_sample, gauss_blur5

BRIEF_BITS = 256
_PATTERN_SCALE = 15.0
# (bits, dim) pairs with a trained vocabulary in assets/
SHIPPED_VOCABS = ((256, 1000), (256, 128))


def brief_pattern(bits: int = BRIEF_BITS, seed: int = 1234) -> np.ndarray:
    """Deterministic sampling pattern: (bits, 4) = (x1, y1, x2, y2), from an
    isotropic Gaussian like the original BRIEF paper (σ = patch/5)."""
    rng = np.random.RandomState(seed)
    pat = rng.normal(0.0, _PATTERN_SCALE / 2.5, size=(bits, 4))
    return np.clip(pat, -_PATTERN_SCALE, _PATTERN_SCALE).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pattern(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(brief_pattern()).to(device)


def brief_describe(image: torch.Tensor, kps: torch.Tensor, mask: torch.Tensor,
                   angle: torch.Tensor | None = None) -> torch.Tensor:
    """±1 BRIEF descriptors at keypoints.

    image: (H, W) in [0,1]; kps: (K, 2) pixel coords; angle: optional (K,)
    orientation (radians) that rotates the pattern (ORB's steered BRIEF).
    Returns (K, 256) int8 in {±1} (masked rows are +1 everywhere).
    """
    sm = gauss_blur5(gauss_blur5(image))
    pat = _pattern(image.device)
    off1 = pat[None, :, :2]                      # (1, B, 2)
    off2 = pat[None, :, 2:]
    if angle is not None:
        ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]

        def rot(o):
            x, y = o[..., 0], o[..., 1]
            return torch.stack([ca * x - sa * y, sa * x + ca * y], -1)

        off1, off2 = rot(off1), rot(off2)
    i1 = bilinear_sample(sm, kps[:, None, :] + off1)
    i2 = bilinear_sample(sm, kps[:, None, :] + off2)
    one = torch.ones_like(i1, dtype=torch.int8)
    bits = torch.where(i1 < i2, one, -one)
    return torch.where(mask[:, None], bits, one)


def patch_orientation(image: torch.Tensor, kps: torch.Tensor,
                      radius: int = 7) -> torch.Tensor:
    """ORB intensity-centroid orientation per keypoint: θ = atan2(m01, m10)
    over a disc-masked (2r+1)² patch.  Returns (K,) radians."""
    sm = gauss_blur5(image)
    d = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=image.device)
    oy, ox = torch.meshgrid(d, d, indexing="ij")
    disc = (ox ** 2 + oy ** 2) <= radius ** 2
    grid = torch.stack([ox, oy], -1).reshape(-1, 2)     # (P, 2)
    vals = (bilinear_sample(sm, kps[:, None, :] + grid[None])
            * disc.reshape(-1)[None, :])
    m10 = torch.sum(vals * grid[None, :, 0], dim=1)
    m01 = torch.sum(vals * grid[None, :, 1], dim=1)
    return torch.atan2(m01, m10)


def pack_bits(desc: torch.Tensor) -> torch.Tensor:
    """±1 int8 (..., B) → packed uint8 (..., B//8): bit j of byte i is
    (desc[8i+j] > 0)."""
    B = desc.shape[-1]
    bits = (desc > 0).to(torch.int32).reshape(desc.shape[:-1] + (B // 8, 8))
    weights = 2 ** torch.arange(8, dtype=torch.int32, device=desc.device)
    return torch.sum(bits * weights, dim=-1).to(torch.uint8)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """Packed uint8 (..., B//8) → ±1 int8 (..., B) (inverse of pack_bits)."""
    shifts = torch.arange(8, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[..., None] >> shifts) & 1
    one = torch.ones_like(bits, dtype=torch.int8)
    pm1 = torch.where(bits > 0, one, -one)
    return pm1.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,))


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances between ±1 descriptor sets.

    a: (..., Na, B) int8; b: (..., Nb, B) int8 → (..., Na, Nb) int32.
    """
    dot = a.to(torch.float32) @ b.to(torch.float32).transpose(-1, -2)
    return ((a.shape[-1] - dot.to(torch.int32)) // 2).to(torch.int32)


def match_descriptors(a: torch.Tensor, a_mask: torch.Tensor,
                      b: torch.Tensor, b_mask: torch.Tensor,
                      max_hamming: int = 80):
    """Mutual-best matching under a Hamming gate; batched over leading
    dims.  Returns (idx_b_for_a (..., Na) int32, ok (..., Na))."""
    D = hamming_matrix(a, b)
    far = torch.full_like(D, 10 ** 6)
    D = torch.where(b_mask[..., None, :], D, far)
    D = torch.where(a_mask[..., :, None], D, far)
    best_d = torch.amin(D, dim=-1)
    best_b = torch.argmin(D, dim=-1)          # first index among ties
    best_a_of_b = torch.argmin(D, dim=-2)
    Na = a.shape[-2]
    mutual = (torch.gather(best_a_of_b, -1, best_b)
              == torch.arange(Na, device=a.device))
    ok = a_mask & (best_d <= max_hamming) & mutual
    return best_b.to(torch.int32), ok


def vocab_asset_path(bits: int, dim: int) -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "assets", f"vocab_brief_{bits}x{dim}.npz")


def make_codebook(bits: int = BRIEF_BITS, dim: int = 128, seed: int = 77,
                  device=None) -> torch.Tensor:
    """Vocabulary codebook (bits, dim): the shipped k-means vocabulary of
    this pair (unit-norm centroids, so a descriptor's argmax bucket is its
    nearest word), or a random signed projection for a pair that ships
    none.  A shipped pair whose file is missing raises."""
    path = vocab_asset_path(bits, dim)
    if (bits, dim) in SHIPPED_VOCABS:
        if not os.path.exists(path):
            raise FileNotFoundError(f"vocabulary asset missing: {path}")
        C = np.load(path)["codebook"].astype(np.float32)
        if C.shape != (bits, dim):
            raise ValueError(f"{path}: codebook shape {C.shape}, "
                             f"expected {(bits, dim)}")
    else:
        rng = np.random.RandomState(seed)
        C = rng.normal(size=(bits, dim)).astype(np.float32)
        C /= np.linalg.norm(C, axis=0, keepdims=True)
    return torch.from_numpy(C).to(device)


def global_descriptor(desc: torch.Tensor, mask: torch.Tensor,
                      codebook: torch.Tensor) -> torch.Tensor:
    """Soft-BoW global descriptor: each local descriptor votes for its
    argmax bucket, and the histogram is L2-normalized.
    desc (K, B) ±1 int8 → (dim,) f32."""
    proj = desc.to(torch.float32) @ codebook            # (K, dim)
    bucket = torch.argmax(proj, dim=-1)                 # (K,)
    hist = torch.zeros(codebook.shape[1], device=desc.device)
    hist = hist.index_add(0, bucket, mask.to(torch.float32))
    return hist / torch.clamp(torch.linalg.vector_norm(hist), min=1e-6)
