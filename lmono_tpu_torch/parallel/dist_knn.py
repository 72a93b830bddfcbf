"""KNN over a point bank sharded on a mesh axis.

Port of `lmono_tpu/parallel/dist_knn.py`.  Each rank runs K1
(`ops/knn.py:knn`) over its own shard, the per-rank candidates are
gathered over the axis and merged into the global top-k by a stable sort,
so a tie goes to the lower shard, the lower global index.  Communication
is O(Q·k·ranks), small beside the O(Q·M/ranks) local distance work.
"""

from __future__ import annotations

import torch

from lmono_tpu_torch.ops.knn import knn
from lmono_tpu_torch.parallel.mesh import Mesh


def sharded_knn(mesh: Mesh, query: torch.Tensor, target_shard: torch.Tensor,
                mask_shard: torch.Tensor, k: int, axis: str = "map"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """query (Q,3) replicated; target (M/D, 3) and mask (M/D,) this rank's
    block of the global bank over `axis`.

    Returns (d² (Q,k), idx (Q,k) int32) on every rank, idx into the
    concatenated (shard-major) bank.
    """
    ax = mesh.axis(axis)
    d2, idx = knn(query, target_shard, mask_shard, k)
    gidx = idx.to(torch.int64) + ax.index * target_shard.shape[0]
    d2_all = ax.all_gather(d2, 1, tiled=True)             # (Q, D·k)
    i_all = ax.all_gather(gidx, 1, tiled=True)
    d2_all, sel = torch.sort(d2_all, dim=1, stable=True)
    return d2_all[:, :k], torch.gather(i_all, 1, sel[:, :k]).to(torch.int32)
