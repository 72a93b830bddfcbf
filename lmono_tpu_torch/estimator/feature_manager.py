"""Window feature bookkeeping: table updates, parallax keyframe test,
batched multi-view triangulation, and window sliding.

Port of `lmono_tpu/estimator/feature_manager.py` (the reference
`FeatureManager`: `featureCheck`, `triangulate`, `removeBack/removeFront/
removeBackShiftDepth`) as masked tensor transforms over the fixed
(max_tracks, W+1) observation table.

The frame slot is a host int here (`WindowState.count` is host-knowable),
so it indexes directly.  Orders that must match the reference exactly:
the id gather stays a one-hot matmul (exact with TF32 off, as the package
sets it, and equal for duplicate ids), and the free-slot / new-feature
orders are stable sorts of int32 keys, which CUDA keeps as the CPU does.
"""

from __future__ import annotations

import torch

from lmono_tpu_torch.config import EstimatorConfig
from lmono_tpu_torch.estimator.tracker import TrackOutput
from lmono_tpu_torch.estimator.window import FeatureTable, WindowState
from lmono_tpu_torch.utils.lie import (
    Pose,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_rotate_inv,
)


def ingest_observations(feats: FeatureTable, out: TrackOutput,
                        frame_slot: int, axis=None) -> FeatureTable:
    """Insert this frame's tracked features into the table at `frame_slot`.

    Known ids update their slot; unknown ids claim free slots (anchor =
    frame_slot), the k-th new feature in tracker order the k-th free slot.

    axis: a mesh `Axis` (landmark axis, "kf") over which the table's rows
    are sharded, `out` replicated.  Two collectives give the single-device
    allocation exactly: the psum'd "id already known" mask, and the free
    rows of lower ranks (an all_gather of the per-rank counts), so the k-th
    new feature still takes the k-th free row of the global table.
    """
    M = feats.ids.shape[0]
    N = out.ids.shape[0]
    dev = feats.ids.device
    s = frame_slot
    match = ((feats.ids[:, None] == out.ids[None, :]) & out.alive[None, :]
             & feats.alive[:, None] & (feats.ids[:, None] >= 0))      # (M,N)
    present = torch.any(match, dim=1)                               # (M,)
    obs_m = match.to(out.norm.dtype) @ out.norm                     # (M,2)

    obs = feats.obs.clone()
    obs_mask = feats.obs_mask.clone()
    obs[:, s] = torch.where(present[:, None], obs_m, feats.obs[:, s])
    obs_mask[:, s] = present | feats.obs_mask[:, s]

    # new features: tracker slots whose id is not in the table
    known = torch.any(match, dim=0)                                 # (N,)
    free = ~feats.alive
    k = torch.arange(M, device=dev)
    gk = k                                          # global rank of a free row
    if axis is not None:
        known = axis.psum(known) > 0
        # free rows sort by global row index: this rank's first free row
        # ranks after every free row of the lower ranks
        n_free = axis.all_gather(torch.sum(free).reshape(1), 0, tiled=True)
        gk = k + torch.sum(n_free[:axis.index])
    is_new = out.alive & ~known & (out.ids >= 0)
    slot_order = torch.argsort((~free).to(torch.int32), stable=True)  # free first
    new_order = torch.argsort((~is_new).to(torch.int32), stable=True)  # new first
    take = (gk < torch.sum(is_new)) & (k < torch.sum(free))
    src = new_order[torch.clamp(gk, 0, N - 1)]                      # tracker idx
    dst = slot_order                                                # table idx

    # dst is a permutation of the table rows, so each row is written once
    def put(x, new):
        return x.index_copy(0, dst, torch.where(take.view((-1,) + (1,) * (x.dim() - 1)),
                                                new, x[dst]))

    obs[:, s] = put(obs[:, s], out.norm[src])
    obs_mask[:, s] = put(obs_mask[:, s], torch.ones_like(take))
    return FeatureTable(
        ids=put(feats.ids, out.ids[src]),
        anchor=put(feats.anchor, torch.full_like(feats.anchor, s)),
        obs=obs, obs_mask=obs_mask,
        inv_depth=put(feats.inv_depth, torch.zeros_like(feats.inv_depth)),
        depth_ok=put(feats.depth_ok, torch.zeros_like(feats.depth_ok)),
        alive=put(feats.alive, torch.ones_like(take)),
    )


def keyframe_check(feats: FeatureTable, frame_slot: int,
                   cfg: EstimatorConfig, axis=None) -> torch.Tensor:
    """Parallax keyframe gate (reference `featureCheck`): mean parallax
    between the two frames before the new one, over co-visible features;
    keyframe when above FEATURE_THRESHOLD px (virtual focal) or when
    tracking is thin.  Returns a () bool tensor.  axis: a landmark-sharded
    table psums the two sums, so every rank takes the same decision."""
    j1 = max(frame_slot - 1, 0)
    j2 = max(frame_slot - 2, 0)
    co = feats.obs_mask[:, j1] & feats.obs_mask[:, j2] & feats.alive
    d = feats.obs[:, j1, :] - feats.obs[:, j2, :]
    par = torch.sqrt(torch.sum(d * d, dim=-1))
    n_co = torch.sum(co)
    sum_par = torch.sum(torch.where(co, par, 0.0))
    if axis is not None:
        n_co = axis.psum(n_co)
        sum_par = axis.psum(sum_par)
    mean_par = sum_par / torch.clamp(n_co, min=1)
    thin = n_co < 20
    kf = thin | (mean_par * cfg.focal_length > cfg.feature_threshold)
    return kf | (frame_slot < 2)


def _cam_poses(state: WindowState) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera poses of every slot: T_W_C = T_W_L ∘ T_CL⁻¹ → (t (W1,3), q (W1,4))."""
    T_LC = Pose(state.ex_t, state.ex_q).inverse()
    cam_t = state.t + quat_rotate(state.q, T_LC.t.expand(state.t.shape))
    cam_q = quat_normalize(quat_mul(state.q, T_LC.q))
    return cam_t, cam_q


def triangulate(state: WindowState, cfg: EstimatorConfig) -> WindowState:
    """Batched multi-view triangulation of un-depthed features (reference
    `FeatureManager::triangulate`): least-squares ray intersection
    p* = argmin Σ_j ||(I − d̂_j d̂_jᵀ)(p − c_j)||² over all observing
    camera centres c_j and ray directions d̂_j; the anchor-frame depth
    becomes the inverse-depth state."""
    feats = state.feats
    M, W1, _ = feats.obs.shape
    dev = feats.obs.device
    cam_t, cam_q = _cam_poses(state)

    # ray dirs in world for every (feature, frame)
    d_cam = torch.cat([feats.obs, torch.ones((M, W1, 1), device=dev)], dim=-1)
    d_cam = d_cam / torch.sqrt(torch.sum(d_cam * d_cam, dim=-1, keepdim=True))
    d_w = quat_rotate(cam_q[None, :, :], d_cam)                     # (M,W1,3)

    frame_idx = torch.arange(W1, device=dev)[None, :]
    act = feats.obs_mask & feats.alive[:, None] & (frame_idx < state.count)

    eye = torch.eye(3, device=dev)
    P_perp = eye - d_w[..., :, None] * d_w[..., None, :]            # (M,W1,3,3)
    P_perp = P_perp * act[..., None, None]
    A = torch.sum(P_perp, dim=1)                                    # (M,3,3)
    b = torch.einsum("mwij,wj->mi", P_perp, cam_t)
    p_w = torch.linalg.solve_ex(A + 1e-6 * eye, b[..., None])[0][..., 0]

    # parallax gate: angle spread of observing rays
    mean_d = torch.sum(torch.where(act[..., None], d_w, 0.0), dim=1)
    n_obs = torch.sum(act, dim=1)
    mean_d = mean_d / torch.clamp(
        torch.sqrt(torch.sum(mean_d * mean_d, dim=-1, keepdim=True)), min=1e-9)
    cos_spread = torch.where(act, torch.einsum("mwi,mi->mw", d_w, mean_d), 1.0)
    min_cos = torch.min(cos_spread, dim=1).values
    cos_gate = torch.cos(torch.tensor(cfg.min_parallax_depth, device=dev))
    enough_parallax = min_cos < cos_gate

    # depth in anchor camera frame
    a = feats.anchor.long()
    z = quat_rotate_inv(cam_q[a], p_w - cam_t[a])[..., 2]
    good = ((n_obs >= 2) & enough_parallax & (z > cfg.depth_min)
            & torch.all(torch.isfinite(p_w), dim=-1))

    newly = good & ~feats.depth_ok & feats.alive
    inv_depth = torch.where(newly, 1.0 / torch.clamp(z, min=cfg.depth_min),
                            feats.inv_depth)
    return state._replace(feats=feats._replace(
        inv_depth=inv_depth, depth_ok=feats.depth_ok | newly))


def shift_left(x: torch.Tensor) -> torch.Tensor:
    """Slots i ← i+1 along the first axis; the last slot keeps its value."""
    return torch.cat([x[1:], x[-1:]], dim=0)


def slide_old(state: WindowState) -> WindowState:
    """Marginalize-oldest slide: shift frames left by one; transfer anchor
    depths of features anchored at slot 0 into slot 1's camera frame
    (reference `removeBackShiftDepth`)."""
    feats = state.feats
    M = feats.obs.shape[0]
    cam_t, cam_q = _cam_poses(state)

    # depth transfer for anchor==0 features with an obs at slot 1
    n0 = feats.obs[:, 0, :]
    depth0 = 1.0 / torch.clamp(feats.inv_depth, min=1e-4)
    p_c0 = torch.cat([n0, torch.ones((M, 1), device=n0.device)], -1) * depth0[:, None]
    p_w = quat_rotate(cam_q[0], p_c0) + cam_t[0]
    z1 = quat_rotate_inv(cam_q[1], p_w - cam_t[1])[..., 2]

    anchored0 = feats.alive & (feats.anchor == 0)
    transfer = anchored0 & feats.obs_mask[:, 1] & feats.depth_ok & (z1 > 0.05)
    inv_depth = torch.where(transfer, 1.0 / torch.clamp(z1, min=0.05),
                            feats.inv_depth)
    depth_ok = torch.where(anchored0, transfer, feats.depth_ok)

    # shift observations left
    obs = torch.cat([feats.obs[:, 1:], torch.zeros_like(feats.obs[:, :1])], dim=1)
    obs_mask = torch.cat([feats.obs_mask[:, 1:],
                          torch.zeros_like(feats.obs_mask[:, :1])], dim=1)
    alive = feats.alive & torch.any(obs_mask, dim=1)
    new_feats = FeatureTable(
        ids=torch.where(alive, feats.ids, -1),
        anchor=torch.clamp(feats.anchor - 1, min=0),
        obs=obs, obs_mask=obs_mask,
        inv_depth=inv_depth,
        depth_ok=depth_ok & alive,
        alive=alive,
    )
    return state._replace(
        t=shift_left(state.t), q=shift_left(state.q),
        lt=shift_left(state.lt), lq=shift_left(state.lq),
        feats=new_feats,
        count=state.count - 1,
    )


def slide_new(state: WindowState) -> WindowState:
    """Drop-second-newest slide (non-keyframe): slot W-1 ← slot W
    (reference `slideWindow` MARGIN_SECOND_NEW).  The two laser relative
    factors merge implicitly because the kept odometry poses stay
    consistent."""
    feats = state.feats
    last, prev = state.w1 - 1, state.w1 - 2

    def move(x):
        x = x.clone()
        x[prev] = x[last]
        return x

    obs = feats.obs.clone()
    obs_mask = feats.obs_mask.clone()
    obs[:, prev] = feats.obs[:, last]
    obs_mask[:, prev] = feats.obs_mask[:, last]
    obs[:, last] = 0.0
    obs_mask[:, last] = False
    alive = feats.alive & torch.any(obs_mask, dim=1)
    new_feats = feats._replace(
        ids=torch.where(alive, feats.ids, -1),
        anchor=torch.where(feats.anchor == last, prev, feats.anchor),
        obs=obs, obs_mask=obs_mask,
        alive=alive, depth_ok=feats.depth_ok & alive)
    return state._replace(
        t=move(state.t), q=move(state.q),
        lt=move(state.lt), lq=move(state.lq),
        feats=new_feats,
        count=state.count - 1,
    )
