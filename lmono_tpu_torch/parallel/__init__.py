"""The device-mesh engine on `torch.distributed` (port of `lmono_tpu/parallel`).

* `mesh`: the process-group mesh, its axes and collectives, spec trees;
* `dist_knn`: KNN over a bank sharded on the space axis;
* `dist_window`: the landmark-sharded window LM;
* `dist_engine`: the shard maps of the engine's state, the distributed
  fused step and pipeline, and the per-lane builders;
* `dist_loop`: the keyframe DB sharded over DB slots;
* `dist_posegraph`: the node-sharded pose-graph GN + CG;
* `dist_ba`: the combined distributed step and its demo inputs.

Each module is imported by path; this package imports none of them, since
the single-device modules import `parallel.mesh` for their `axis=`.
"""
