"""Keyframe-sharded pose-graph GN + CG over a mesh axis.

Port of `lmono_tpu/parallel/dist_posegraph.py`: the single-device
optimizer's matrix-free GN + CG (`loop/posegraph.py`), laid out by hand
over the ranks of one axis.

* Node states are block-sharded: rank d owns nodes [d·Nl, (d+1)·Nl).
* The only remote rows a residual reads are the next block's first row
  (the far end of a rank's last sequential edge), the loop edges' end
  rows and node 0 (the gauge).  One psum of a (2L + 1 + D, C) row pack,
  each owner contributing its rows and zeros elsewhere, gives every rank
  all of them (`_pack_remote`); its size does not depend on N.
* A loop edge's residual is counted by the owner of its node i only.
* J is formed once per GN step as per-edge blocks (`posegraph._blocks`),
  as the single-device port does.  The JAX package forms Hv with
  `jax.linearize` through its psum; `torch.func` cannot differentiate
  through a collective, so here J v packs only the remote rows' values of
  v (one psum), and Jᵀ u sends each block's product to the owner of its
  node through the same layout (one more psum), where a one-hot matmul
  adds them into the local rows.
* The CG's two dot products are psums, as in the JAX package's `_pcg`
  (the fused single-reduction variant it rejected for f32 stability is
  not taken either).

Collectives per CG step: two (2L + 1 + D, C) psums inside Hv and two
scalar psums.  Like the JAX package's sharded optimizer, this one runs a
fixed count of GN steps and of CG steps; the loop-edge weights are held
fixed within a GN step, as in the single-device port.  Every decision is
a fixed count, so the ranks stay in step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from lmono_tpu_torch.loop.posegraph import (PoseGraph, _blocks, _bmv, _edge4,
                                            _edge6, _gnc_c, _robust_w, _wrap)
from lmono_tpu_torch.parallel.mesh import Mesh, gather_sharded, put_sharded
from lmono_tpu_torch.utils.lie import (mat_to_quat, mat_to_ypr, quat_conj,
                                       quat_mul, quat_rotate_inv, quat_to_mat,
                                       so3_exp_quat, so3_log_quat, ypr_to_mat)

_NODE = ("t", "ypr", "node_mask", "seq_dt", "seq_dyaw", "seq_dq", "seq_mask")


def graph_specs(axis: str = "kf") -> PoseGraph:
    """Spec tree: node arrays sharded over `axis`, loop edges and counts
    replicated."""
    return PoseGraph(**{f: (axis if f in _NODE else None)
                        for f in PoseGraph._fields})


def graph_shardings(mesh: Mesh, g: PoseGraph, axis: str = "kf") -> PoseGraph:
    """This rank's part of a global graph (`graph_specs`)."""
    return put_sharded(mesh, g, graph_specs(axis))


def graph_gathered(mesh: Mesh, g: PoseGraph, axis: str = "kf") -> PoseGraph:
    """The global graph from this rank's part."""
    return gather_sharded(mesh, g, graph_specs(axis))


class _Layout(NamedTuple):
    """Where the remote rows sit in the psum'd row pack."""
    rows: torch.Tensor     # (2L + 1 + D,) global rows: loop i, loop j, 0, firsts
    onehot: torch.Tensor   # (Nl, 2L + 1 + D): local row ← pack row it owns
    L: int
    halo: int              # pack row of the next block's first row


def _layout(Nl: int, loop_i, loop_j, axis, dtype) -> _Layout:
    L, nd, my = loop_i.shape[0], axis.size, axis.index
    firsts = torch.arange(nd, device=loop_i.device) * Nl
    rows = torch.cat([loop_i, loop_j, torch.zeros(1, dtype=loop_i.dtype,
                                                  device=loop_i.device), firsts])
    loc = rows - my * Nl
    own = (loc >= 0) & (loc < Nl)
    onehot = (F.one_hot(torch.clamp(loc, 0, Nl - 1), Nl).T.to(dtype)
              * own[None, :].to(dtype))
    return _Layout(rows, onehot, L, 2 * L + 1 + (my + 1) % nd)


def _pack_remote(vals_loc: torch.Tensor, lay: _Layout, axis) -> torch.Tensor:
    """Every rank's copy of the pack's rows of a block-sharded (Nl, C)
    array: each owner contributes its rows, zeros elsewhere, one psum.
    Exact: every row is one owner's value plus zeros."""
    Nl = vals_loc.shape[0]
    loc = lay.rows - axis.index * Nl
    own = (loc >= 0) & (loc < Nl)
    v = vals_loc[torch.clamp(loc, 0, Nl - 1)]
    return axis.psum(torch.where(own[:, None], v, torch.zeros_like(v)))


class _ShardLin(NamedTuple):
    """J at one GN iterate on this rank: the blocks of its Nl sequential
    edges (edge k joins local node k and k+1, node Nl the next block's
    first), of the loop edges it owns (zero blocks for the others) and its
    part of the gauge residual (rank 0 only)."""
    r_seq: torch.Tensor
    Ji_seq: torch.Tensor
    Jj_seq: torch.Tensor
    r_loop: torch.Tensor
    Ji_loop: torch.Tensor
    Jj_loop: torch.Tensor
    r_fix: torch.Tensor
    lead: float            # 1.0 on the owner of node 0
    lay: _Layout

    def residuals(self):
        return (self.r_seq, self.r_loop, self.r_fix)

    def J(self, v, axis):
        pack = _pack_remote(v, self.lay, axis)
        L = self.lay.L
        vj_seq = torch.cat([v[1:], pack[self.lay.halo][None]])
        seq = _bmv(self.Ji_seq, v) + _bmv(self.Jj_seq, vj_seq)
        loop = _bmv(self.Ji_loop, pack[:L]) + _bmv(self.Jj_loop, pack[L:2 * L])
        return seq, loop, 100.0 * self.lead * v[0]

    def JT(self, u, axis):
        u_seq, u_loop, u_fix = u
        L = self.lay.L
        a = _bmv(self.Ji_seq.transpose(1, 2), u_seq)
        b = _bmv(self.Jj_seq.transpose(1, 2), u_seq)
        out = a + F.pad(b[:-1], (0, 0, 1, 0))
        sent = torch.zeros((self.lay.rows.shape[0], a.shape[1]),
                           dtype=a.dtype, device=a.device)
        sent[:L] = _bmv(self.Ji_loop.transpose(1, 2), u_loop)
        sent[L:2 * L] = _bmv(self.Jj_loop.transpose(1, 2), u_loop)
        sent[self.lay.halo] = b[-1]
        out = out + self.lay.onehot @ axis.psum(sent)
        return torch.cat([out[:1] + 100.0 * self.lead * u_fix, out[1:]])


def _linearize4(x, pr, anchor, seq_dt, seq_dyaw, seq_mask, loop_i, loop_j,
                loop_dt, loop_dyaw, loop_w, lay, axis, c) -> _ShardLin:
    """4-DoF blocks at the local x = (t, yaw) (Nl, 4); pr the local
    (pitch, roll); loop weights from the pack's end rows, held fixed."""
    Nl, L, my = x.shape[0], lay.L, axis.index
    pack = _pack_remote(torch.cat([x, pr], -1), lay, axis)
    ei, ej, nxt = pack[:L], pack[L:2 * L], pack[lay.halo]
    # robust loop weights at x, counted by the owner of node i
    own = (loop_i // Nl == my).to(x.dtype)
    R_i = ypr_to_mat(torch.cat([ei[:, 3:4], ei[:, 4:6]], -1))
    raw_t = (R_i.transpose(1, 2) @ (ej[:, :3] - ei[:, :3])[..., None])[..., 0] - loop_dt
    raw_y = _wrap(ej[:, 3] - ei[:, 3] - loop_dyaw)
    w = loop_w * own * _robust_w(torch.linalg.vector_norm(raw_t, dim=-1),
                                 torch.abs(raw_y), c)
    xj = torch.cat([x[1:], nxt[None, :4]])
    r_s, Ji_s, Jj_s = _blocks(_edge4, x, xj, pr, seq_dt, seq_dyaw[:, None],
                              seq_mask.to(x.dtype))
    r_l, Ji_l, Jj_l = _blocks(_edge4, ei[:, :4], ej[:, :4], ei[:, 4:6], loop_dt,
                              loop_dyaw[:, None], w)
    lead = 1.0 if my == 0 else 0.0
    return _ShardLin(r_s, Ji_s, Jj_s, r_l, Ji_l, Jj_l,
                     100.0 * lead * (x[0] - anchor), lead, lay)


def _linearize6(x, q0, anchor_t, seq_dt, seq_dq, seq_mask, loop_i, loop_j,
                loop_dt, loop_dq, loop_w, lay, axis, c) -> _ShardLin:
    """SE(3) blocks at the local x = (t, δθ) (Nl, 6) around the node
    rotations q0 (Nl, 4)."""
    Nl, L, my = x.shape[0], lay.L, axis.index
    pack = _pack_remote(torch.cat([x, q0], -1), lay, axis)
    ei, ej, nxt = pack[:L], pack[L:2 * L], pack[lay.halo]
    own = (loop_i // Nl == my).to(x.dtype)
    qi = quat_mul(ei[:, 6:10], so3_exp_quat(ei[:, 3:6]))
    qj = quat_mul(ej[:, 6:10], so3_exp_quat(ej[:, 3:6]))
    raw_t = quat_rotate_inv(qi, ej[:, :3] - ei[:, :3]) - loop_dt
    raw_r = so3_log_quat(quat_mul(quat_conj(loop_dq), quat_mul(quat_conj(qi), qj)))
    w = loop_w * own * _robust_w(torch.linalg.vector_norm(raw_t, dim=-1),
                                 torch.linalg.vector_norm(raw_r, dim=-1), c)
    xj = torch.cat([x[1:], nxt[None, :6]])
    q0j = torch.cat([q0[1:], nxt[None, 6:10]])
    r_s, Ji_s, Jj_s = _blocks(_edge6, x, xj, q0, q0j, seq_dt, seq_dq,
                              seq_mask.to(x.dtype))
    r_l, Ji_l, Jj_l = _blocks(_edge6, ei[:, :6], ej[:, :6], ei[:, 6:10],
                              ej[:, 6:10], loop_dt, loop_dq, w)
    lead = 1.0 if my == 0 else 0.0
    r_fix = 100.0 * lead * torch.cat([x[0, :3] - anchor_t, x[0, 3:]])
    return _ShardLin(r_s, Ji_s, Jj_s, r_l, Ji_l, Jj_l, r_fix, lead, lay)


def _pcg(Av, b, iters: int, axis):
    """CG with psum'd dot products (b and x are this rank's rows); a fixed
    count of steps, as the JAX package's `_pcg`."""
    def pdot(a, c):
        return axis.psum(torch.sum(a * c))

    x = torch.zeros_like(b)
    r = p = b
    rs = pdot(r, r)
    for _ in range(iters):
        Ap = Av(p)
        alpha = rs / torch.clamp(pdot(p, Ap), min=1e-12)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = pdot(r, r)
        p = r + (rs_new / torch.clamp(rs, min=1e-12)) * p
        rs = rs_new
    return x


def _gn_dx(lin: _ShardLin, node_mask, cg_iters: int, axis):
    """One GN step's masked update from the linearization."""
    grad = lin.JT(lin.residuals(), axis)
    dx = _pcg(lambda v: lin.JT(lin.J(v, axis), axis) + 1e-4 * v, -grad,
              cg_iters, axis)
    return torch.where(node_mask[:, None], dx, torch.zeros_like(dx))


def make_sharded_posegraph_opt(mesh: Mesh, iters: int = 10, cg_iters: int = 50,
                               four_dof: bool = True, axis: str = "kf"):
    """The keyframe-sharded `optimize_posegraph`: f(g) -> g, where g holds
    this rank's block of the node arrays and the replicated loop edges
    (`graph_shardings`); the node capacity must split over the axis."""
    ax = mesh.axis(axis)

    def optimize(g: PoseGraph) -> PoseGraph:
        Nl = g.t.shape[0]
        w = g.loop_w * g.loop_mask
        lay = _layout(Nl, g.loop_i, g.loop_j, ax, g.t.dtype)
        if four_dof:
            x = torch.cat([g.t, g.ypr[:, :1]], -1)
            anchor = torch.cat([g.t[0], g.ypr[0, :1]])
            pr = g.ypr[:, 1:]
            for it in range(iters):
                lin = _linearize4(x, pr, anchor, g.seq_dt, g.seq_dyaw, g.seq_mask,
                                  g.loop_i, g.loop_j, g.loop_dt, g.loop_dyaw, w,
                                  lay, ax, _gnc_c(it))
                x = x + _gn_dx(lin, g.node_mask, cg_iters, ax)
            return g._replace(t=x[:, :3],
                              ypr=torch.stack([x[:, 3], g.ypr[:, 1], g.ypr[:, 2]], -1))
        q0 = mat_to_quat(ypr_to_mat(g.ypr))
        t = g.t
        anchor_t = g.t[0]
        zero3 = torch.zeros_like(t)
        for it in range(iters):
            x = torch.cat([t, zero3], -1)
            lin = _linearize6(x, q0, anchor_t, g.seq_dt, g.seq_dq, g.seq_mask,
                              g.loop_i, g.loop_j, g.loop_dt, g.loop_dq, w,
                              lay, ax, _gnc_c(it))
            x = x + _gn_dx(lin, g.node_mask, cg_iters, ax)
            t = x[:, :3]
            q0 = quat_mul(q0, so3_exp_quat(x[:, 3:]))
        return g._replace(t=t, ypr=mat_to_ypr(quat_to_mat(q0)))

    return optimize
