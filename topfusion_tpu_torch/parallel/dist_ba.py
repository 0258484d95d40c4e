"""Distributed pose-graph bundle adjustment over the map axis (port of
``topfusion_tpu/parallel/dist_ba.py``).

The edges (the observations) are split over the members of a
``MapAxis``: each member linearizes only its block of edges (per-edge
6x6 Jacobian blocks, ``models/posegraph.edge_jacobians``), and the
normal equations are solved matrix-free by block-Jacobi PCG
(``models/posegraph._pcg_solve``).  The Hessian is never formed; the
only collectives are keyframe-sized sums:

  * one [K, 6] per Hessian-vector product (``cg_iters + 1`` per
    Gauss-Newton step: the CG steps' and the initial residual's),
  * one [K, 6] for the gradient and one [K, 6, 6] for the
    preconditioner per Gauss-Newton step,

so ``gn_iters * (cg_iters + 3)`` calls per solve.  The poses stay
replicated: every member applies the same summed update.  With one
member every sum is its input and the solve is ``optimize_pcg``, bit for
bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import PoseGraphConfig
from ..geometry.se3 import se3_exp
from ..models.posegraph import PoseGraph, _finish, _huber_weights, _pcg_solve, edge_jacobians
from .collectives import MapAxis


def optimize_distributed(
    pg: PoseGraph, cfg: PoseGraphConfig, axis: MapAxis
) -> Tuple[PoseGraph, torch.Tensor]:
    """Gauss-Newton over the keyframe poses with the edges split over
    ``axis``; every member calls it with the same graph.  The edges are
    padded to a multiple of the axis size (identity measurement, invalid,
    weight 0) and member r takes the contiguous block ``[r * e_pad / ns,
    (r + 1) * e_pad / ns)``, the split ``P(axis)`` gives in the JAX
    package.  Returns (optimized graph, final chi2)."""
    ns, r = axis.size, axis.rank
    dev = pg.kf_poses.device
    k_cap = pg.kf_poses.shape[0]
    e_cap = pg.edge_i.shape[0]
    e_pad = -(-e_cap // ns) * ns
    extra = e_pad - e_cap

    def pad(x, fill):
        return torch.cat([x, torch.full((extra,) + x.shape[1:], fill, dtype=x.dtype, device=dev)])

    edge_T = torch.cat([pg.edge_T, torch.eye(4, dtype=pg.edge_T.dtype, device=dev).expand(extra, 4, 4)])
    valid = pad(torch.arange(e_cap, device=dev) < pg.num_edges, False)
    lo, hi = r * e_pad // ns, (r + 1) * e_pad // ns
    ei, ej = pad(pg.edge_i, 0)[lo:hi], pad(pg.edge_j, 0)[lo:hi]
    eT, ev, ew = edge_T[lo:hi], valid[lo:hi], pad(pg.edge_weight, 0)[lo:hi]

    poses = pg.kf_poses
    for _ in range(cfg.gn_iters):
        res, A, B = edge_jacobians(poses, ei, ej, eT)
        we = _huber_weights(res, cfg.huber_delta) * ew * ev.to(torch.float32)
        dx = _pcg_solve(A, B, res, we, ei, ej, k_cap, cfg.damping, cfg.cg_iters, axis=axis)
        poses = se3_exp(dx) @ poses
    return _finish(pg, poses)
