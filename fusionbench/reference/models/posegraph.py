# Frozen copy of topfusion_tpu_torch/models/posegraph.py at commit 81038a6, the yardstick's plain reference.
"""Keyframe pose graph with loop closure and Gauss-Newton optimization
(port of ``topfusion_tpu/models/posegraph.py``).

Fixed capacities as in the JAX package (occupancy by masks; no shape
depends on the data).  What differs is the form, not the semantics:

* Masked writes.  The JAX package drops a masked-off write through an
  out-of-range index (``.at[i].set(v, mode="drop")``).  Here the small
  arrays (poses, descriptors, edges, flags) take the extra-row pattern of
  ``ops/pointcloud._emit``: a copy with one sacrificial row receives every
  dropped write and is sliced off.  The keyframe point and normal maps
  (2 x 236 MB at the defaults) are written IN PLACE, one row per insert,
  at the clamped index, with the row's old value where the mask is off:
  a copy per insert would move half a gigabyte.  No write reads a mask on
  the host, so inserting and detecting make no host sync of their own.
* Loop verification runs the 2 x ``loop_candidates`` x queries ICPs as one
  ``torch.func.vmap`` of ``ops.icp.icp_track``: one set of launches, then
  one batched eigensolve of their Gram matrices for the observability
  gate (``ops.icp.obs_ratio``: on the card one launch of the eig6 kernel,
  which does not sync), so ``detect_loop`` makes no host sync and can be
  captured in a CUDA graph.
* Candidate ranking is a stable ascending sort: ``lax.top_k`` of the
  negated scores takes the lower index on ties, ``torch.topk`` promises no
  order.  ``torch.argmax`` takes the first maximum, as ``jnp.argmax``.
* Jacobians are ``torch.func.jacfwd`` inside ``torch.func.vmap``.
* The segment sums of the PCG solve are products with the [K, E]
  incidence matrices of the edges' endpoints in float32 (TF32 off), not
  ``index_add_``, whose float atomics on the card add in an order that
  changes from run to run: two runs on the card give the same graph to
  the bit.
* The ``fori_loop``s are Python loops (10 GN x 48 CG steps at the
  defaults, about 15 operations a step): eagerly a host-bound solve; on
  the card ``models/slam.CapturedSlam`` replays it as one CUDA graph.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
from torch.func import jacfwd, vmap

from ..config import CameraConfig, ICPConfig, PoseGraphConfig
from ..geometry.se3 import (
    rotate_vectors,
    se3_exp,
    se3_inverse,
    se3_log,
    transform_points,
)
from ..ops.icp import icp_track, obs_ratio
from ..utils.device_info import entry_device
from ..utils.numerics import norm3, true_div

# The incidence products and the 6x6 algebra must run in float32: TF32
# would round their inputs to 10 bits of mantissa.
torch.backends.cuda.matmul.allow_tf32 = False


class PoseGraph(NamedTuple):
    kf_poses: torch.Tensor     # [K, 4, 4] world-from-camera at keyframe time
    kf_points: torch.Tensor    # [K, h, w, 3] camera-space vertex map (coarse level)
    kf_normals: torch.Tensor   # [K, h, w, 3]
    kf_frame: torch.Tensor     # [K] int32 source frame index
    kf_desc: torch.Tensor      # [K, DESC_DIM] appearance descriptor
    num_kf: torch.Tensor       # () int32
    edge_i: torch.Tensor       # [E] int32 source node
    edge_j: torch.Tensor       # [E] int32 target node
    edge_T: torch.Tensor       # [E, 4, 4] measured T_i^-1 T_j
    edge_is_loop: torch.Tensor  # [E] bool
    edge_weight: torch.Tensor  # [E] float32 information weight
    num_edges: torch.Tensor    # () int32
    # [K] bool: the keyframe already owns an outgoing loop edge, so a
    # re-queried keyframe inserts no duplicate.
    kf_loop_done: torch.Tensor


# Appearance descriptor: 16 depth bins + 8 normal-azimuth bins + 4
# normal-elevation bins, each histogram L1-normalized on its own.
_DESC_Z_BINS = 16
_DESC_AZ_BINS = 8
_DESC_EL_BINS = 4
DESC_DIM = _DESC_Z_BINS + _DESC_AZ_BINS + _DESC_EL_BINS


def _row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor, without the host sync of indexing
    by a 0-d tensor (which reads it as a Python int)."""
    return x.index_select(0, i.reshape(1).long())[0]


def _put_rows(x: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    """A copy of ``x`` with rows ``idx`` [n] set to ``values`` (broadcast to
    [n, ...]); an index of ``len(x)`` drops its write into an extra row
    that is sliced off."""
    out = torch.cat([x, x[:1]])
    if isinstance(values, torch.Tensor):
        v = values.to(x.dtype)
    else:  # a fill on the device: a host tensor would be copied, a sync
        v = torch.full((), values, dtype=x.dtype, device=x.device)
    out[idx.long()] = v.expand((idx.shape[0],) + x.shape[1:])
    return out[: x.shape[0]]


def _set_row_(x: torch.Tensor, i: torch.Tensor, keep: torch.Tensor, value: torch.Tensor) -> None:
    """In place: row ``i`` of ``x`` becomes ``value`` where ``keep``, and
    keeps its old value where not (``i`` is clamped into range)."""
    j = torch.clamp(i, 0, x.shape[0] - 1).reshape(1).long()
    old = x.index_select(0, j)
    x.index_copy_(0, j, torch.where(keep, value.to(x.dtype)[None], old))


def _histogram(bins: torch.Tensor, n: int, weight: torch.Tensor) -> torch.Tensor:
    """Per-bin sums of ``weight`` over the image: exact counts of 0/1
    weights (a one-hot sum, as the JAX package's)."""
    one_hot = bins[..., None] == torch.arange(n, dtype=bins.dtype, device=bins.device)
    return torch.sum(one_hot.to(torch.float32) * weight[..., None], dim=(0, 1))


def kf_descriptor(
    points: torch.Tensor,
    normals: torch.Tensor,
    z_min: float = 0.2,
    z_max: float = 3.0,
) -> torch.Tensor:
    """Appearance descriptor of a keyframe's coarse CAMERA-SPACE maps:
    L1-normalized histograms over the valid pixels of depth (16 bins over
    the frustum), normal azimuth (8 bins) and normal elevation (4 bins over
    n_z).  Loop candidates are ranked by its L1 distance."""
    vf = torch.any(points != 0.0, dim=-1).to(torch.float32)

    zb = torch.clamp(
        (true_div(points[..., 2] - z_min, z_max - z_min) * _DESC_Z_BINS).to(torch.int32),
        0, _DESC_Z_BINS - 1,
    )
    az = torch.atan2(normals[..., 1], normals[..., 0])
    ab = torch.clamp(
        (true_div(az + math.pi, 2.0 * math.pi) * _DESC_AZ_BINS).to(torch.int32),
        0, _DESC_AZ_BINS - 1,
    )
    eb = torch.clamp(
        ((normals[..., 2] + 1.0) * 0.5 * _DESC_EL_BINS).to(torch.int32),
        0, _DESC_EL_BINS - 1,
    )

    def l1(h):
        return h / torch.clamp(torch.sum(h), min=1.0)

    return torch.cat([
        l1(_histogram(zb, _DESC_Z_BINS, vf)),
        l1(_histogram(ab, _DESC_AZ_BINS, vf)),
        l1(_histogram(eb, _DESC_EL_BINS, vf)),
    ])


def make_pose_graph(cfg: PoseGraphConfig, cam_level: CameraConfig, device="cuda") -> PoseGraph:
    """An empty graph on ``device`` (the card by default, a
    ``RuntimeError`` where there is none)."""
    dev = entry_device(device)
    k, e = cfg.max_keyframes, cfg.max_edges
    h, w = cam_level.height, cam_level.width
    eye = torch.eye(4, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return PoseGraph(
        kf_poses=eye.expand(k, 4, 4).clone(),
        kf_points=torch.zeros((k, h, w, 3), device=dev),
        kf_normals=torch.zeros((k, h, w, 3), device=dev),
        kf_frame=torch.full((k,), -1, **i32),
        kf_desc=torch.zeros((k, DESC_DIM), device=dev),
        num_kf=torch.zeros((), **i32),
        edge_i=torch.zeros((e,), **i32),
        edge_j=torch.zeros((e,), **i32),
        edge_T=eye.expand(e, 4, 4).clone(),
        edge_is_loop=torch.zeros((e,), dtype=torch.bool, device=dev),
        edge_weight=torch.ones((e,), device=dev),
        num_edges=torch.zeros((), **i32),
        kf_loop_done=torch.zeros((k,), dtype=torch.bool, device=dev),
    )


# ----------------------------------------------------------------- insert
def add_keyframe(
    pg: PoseGraph,
    T_wc: torch.Tensor,
    points_l: torch.Tensor,
    normals_l: torch.Tensor,
    frame_idx,
    do_add,
) -> PoseGraph:
    """Insert a keyframe (masked by ``do_add``, a bool or 0-d tensor) and
    its odometry edge to the previous keyframe.  ``kf_points`` and
    ``kf_normals`` are written in place (see the module docstring)."""
    dev = pg.kf_poses.device
    k_cap = pg.kf_poses.shape[0]
    e_cap = pg.edge_i.shape[0]
    idx = pg.num_kf
    if not isinstance(do_add, torch.Tensor):
        do_add = torch.full((), bool(do_add), dtype=torch.bool, device=dev)
    can = do_add & (idx < k_cap)
    widx = torch.where(can, idx, k_cap).reshape(1)
    if not isinstance(frame_idx, torch.Tensor):
        frame_idx = torch.full((), frame_idx, dtype=torch.int32, device=dev)

    _set_row_(pg.kf_points, idx, can, points_l)
    _set_row_(pg.kf_normals, idx, can, normals_l)
    pg = pg._replace(
        kf_poses=_put_rows(pg.kf_poses, widx, T_wc[None]),
        kf_frame=_put_rows(pg.kf_frame, widx, frame_idx.reshape(1)),
        kf_desc=_put_rows(pg.kf_desc, widx, kf_descriptor(points_l, normals_l)[None]),
        num_kf=pg.num_kf + can.to(torch.int32),
    )

    # Odometry edge (idx-1) -> idx.
    has_prev = can & (idx > 0) & (pg.num_edges < e_cap)
    prev = torch.clamp(idx - 1, min=0)
    T_meas = se3_inverse(_row(pg.kf_poses, prev)) @ T_wc
    eidx = torch.where(has_prev, pg.num_edges, e_cap).reshape(1)
    return pg._replace(
        edge_i=_put_rows(pg.edge_i, eidx, prev.reshape(1)),
        edge_j=_put_rows(pg.edge_j, eidx, idx.reshape(1)),
        edge_T=_put_rows(pg.edge_T, eidx, T_meas[None]),
        edge_is_loop=_put_rows(pg.edge_is_loop, eidx, False),
        edge_weight=_put_rows(pg.edge_weight, eidx, 1.0),
        num_edges=pg.num_edges + has_prev.to(torch.int32),
    )


# ----------------------------------------------------------------- loops
class LoopInfo(NamedTuple):
    """How many closures one call inserted and the quality of the best."""

    n_closed: torch.Tensor   # () int32
    inliers: torch.Tensor    # () int32 best closure's ICP inliers (-1 none)
    residual: torch.Tensor   # () f32 best closure's ICP residual (inf none)


def detect_loop(
    pg: PoseGraph,
    cam_level: CameraConfig,
    pg_cfg: PoseGraphConfig,
    icp_cfg: ICPConfig,
    enable=True,
) -> Tuple[PoseGraph, torch.Tensor, LoopInfo]:
    """Try to close loops for the ``loop_queries`` NEWEST keyframes.

    Per query keyframe: candidates = the ``loop_candidates`` best older
    keyframes outside the recency window (appearance-ranked under a
    widened pose gate by default); verification = a short coarse-level
    ICP between the keyframes' stored maps from two starts (the drifted
    current pose and the candidate's own pose), all (query, start,
    candidate) triples in one batch.  The best verified candidate per
    query wins; up to ``loop_queries`` edges insert under masks.
    ``enable`` (a bool or 0-d tensor) masks the whole detection.  Returns
    (graph, any loop found, LoopInfo)."""
    dev = pg.kf_poses.device
    k_cap = pg.kf_poses.shape[0]
    e_cap = pg.edge_i.shape[0]
    n_cand = min(pg_cfg.loop_candidates, k_cap)
    Q = max(1, min(pg_cfg.loop_queries, k_cap))

    qs_raw = (pg.num_kf - 1) - torch.arange(Q, dtype=torch.int32, device=dev)
    qs = torch.clamp(qs_raw, min=0)
    q_ok = (qs_raw >= 0) & ~pg.kf_loop_done[qs.long()] & enable

    loop_icp_cfg = ICPConfig(
        iters=(pg_cfg.loop_icp_iters,),
        dist_threshold=icp_cfg.dist_threshold * 2.0,
        angle_threshold_deg=icp_cfg.angle_threshold_deg,
    )
    gate = pg_cfg.loop_max_dist * (
        pg_cfg.loop_appearance_dist_factor if pg_cfg.loop_appearance else 1.0
    )

    # Candidate selection, every query at once ([Q, K]).
    cur_pose = pg.kf_poses[qs.long()]
    d = norm3(pg.kf_poses[None, :, :3, 3] - cur_pose[:, None, :3, 3])
    ks = torch.arange(k_cap, dtype=torch.int32, device=dev)
    eligible = (ks[None, :] <= qs[:, None] - pg_cfg.loop_candidate_window) & (d <= gate)
    if pg_cfg.loop_appearance:
        score_sel = torch.sum(torch.abs(pg.kf_desc[None] - pg.kf_desc[qs.long()][:, None]), dim=-1)
    else:
        score_sel = d
    sel_masked = torch.where(eligible, score_sel, math.inf)
    sel_sorted, order = torch.sort(sel_masked, dim=1, stable=True)
    cand_ids = order[:, :n_cand]                      # [Q, C] int64
    cand_has = torch.isfinite(sel_sorted[:, :n_cand])

    # Verification: the candidates' maps placed in the world at their
    # poses; ICP of the query's camera-space maps against them.
    cand_poses = pg.kf_poses[cand_ids]                # [Q, C, 4, 4]
    cand_pts = pg.kf_points[cand_ids]                 # [Q, C, h, w, 3]
    cand_nrm = pg.kf_normals[cand_ids]
    mvalid = torch.any(cand_pts != 0.0, dim=-1, keepdim=True)
    Tc = cand_poses[:, :, None, None]
    mp = torch.where(mvalid, transform_points(Tc, cand_pts), 0.0)
    mn = torch.where(mvalid, rotate_vectors(Tc, cand_nrm), 0.0)
    inits = torch.stack([cur_pose[:, None].expand_as(cand_poses), cand_poses], dim=1)

    def verify(T_init, T_model, cp, cn, mp_w, mn_w):
        return icp_track(cam_level, loop_icp_cfg, T_init, T_model, [cp], [cn], [mp_w], [mn_w])

    over_cand = vmap(verify, in_dims=(0, 0, None, None, 0, 0))
    over_init = vmap(over_cand, in_dims=(0, None, None, None, None, None))
    res = vmap(over_init)(
        inits, cand_poses, pg.kf_points[qs.long()], pg.kf_normals[qs.long()], mp, mn
    )  # fields [Q, 2, C, ...]
    ok_all = (
        res.ok
        & (res.residual < pg_cfg.loop_max_residual)
        & (res.num_inliers > icp_cfg.min_corresp * 4)
        # A rank-deficient system (bare wall, uniform corridor) converges
        # from anywhere along its null direction: never a verification.
        & (obs_ratio(res.gram) > pg_cfg.loop_min_obs_ratio)
    )
    # When both starts verify they must agree on the pose: translation-
    # invariant geometry lets each converge near its own start.
    both = ok_all[:, 0] & ok_all[:, 1]
    t_diff = norm3(res.T_wc[:, 0, :, :3, 3] - res.T_wc[:, 1, :, :3, 3])
    consistent = (t_diff < icp_cfg.dist_threshold) | ~both
    ok_all = (ok_all & consistent[:, None] & cand_has[:, None]).reshape(Q, -1)
    inl_all = res.num_inliers.reshape(Q, -1)
    res_all = res.residual.reshape(Q, -1)
    T_flat = res.T_wc.reshape(Q, -1, 4, 4)
    cand2 = torch.cat([cand_ids, cand_ids], dim=1)
    score = torch.where(ok_all, inl_all, -1)
    best = torch.argmax(score, dim=1, keepdim=True)   # [Q, 1], first maximum

    def take(x):
        return torch.gather(x, 1, best)[:, 0]

    good_q = (take(score) >= 0) & q_ok
    cand_q = take(cand2)
    inl_q, res_q = take(inl_all), take(res_all)
    T_best = torch.take_along_dim(T_flat, best[:, :, None, None], dim=1)[:, 0]
    T_q = se3_inverse(pg.kf_poses[cand_q]) @ T_best

    # Insert up to Q loop edges at contiguous slots, newest query first.
    rank = torch.cumsum(good_q.to(torch.int32), dim=0, dtype=torch.int32) - 1
    fits = good_q & (pg.num_edges + rank < e_cap)
    eidx = torch.where(fits, pg.num_edges + rank, e_cap)
    n_fit = torch.sum(fits, dtype=torch.int32)
    pg = pg._replace(
        edge_i=_put_rows(pg.edge_i, eidx, cand_q),
        edge_j=_put_rows(pg.edge_j, eidx, qs),
        edge_T=_put_rows(pg.edge_T, eidx, T_q),
        edge_is_loop=_put_rows(pg.edge_is_loop, eidx, True),
        edge_weight=_put_rows(pg.edge_weight, eidx, pg_cfg.loop_edge_weight),
        num_edges=pg.num_edges + n_fit,
        kf_loop_done=_put_rows(pg.kf_loop_done, torch.where(fits, qs, k_cap), True),
    )
    found = torch.any(fits)
    qbest = torch.argmax(torch.where(fits, inl_q, -1))
    info = LoopInfo(
        n_closed=n_fit,
        inliers=torch.where(found, _row(inl_q, qbest), -1),
        residual=torch.where(found, _row(res_q, qbest), math.inf),
    )
    return pg, found, info


# ----------------------------------------------------------------- residuals
def edge_residuals(twists: torch.Tensor, pg: PoseGraph) -> torch.Tensor:
    """Stacked 6-vector residuals r_e = log(T_meas^-1 (exp(x_i) T_i)^-1
    (exp(x_j) T_j)) for every edge slot [E, 6] (invalid slots -> 0)."""
    poses = se3_exp(twists) @ pg.kf_poses
    Ti = poses[pg.edge_i.long()]
    Tj = poses[pg.edge_j.long()]
    r = se3_log(se3_inverse(pg.edge_T) @ (se3_inverse(Ti) @ Tj))
    valid = (torch.arange(pg.edge_i.shape[0], device=twists.device) < pg.num_edges)[:, None]
    return torch.where(valid, r, 0.0)


def _huber_weights(r: torch.Tensor, delta: float) -> torch.Tensor:
    """Per-edge IRLS weights for the Huber loss on ||r_e||."""
    n = torch.linalg.vector_norm(r, dim=-1)
    return torch.where(n <= delta, 1.0, true_div(delta, torch.clamp(n, min=1e-12)))


def _edge_residual(xi, xj, ti, tj, tm):
    pi = se3_exp(xi) @ ti
    pj = se3_exp(xj) @ tj
    return se3_log(se3_inverse(tm) @ (se3_inverse(pi) @ pj))


def edge_jacobians(
    poses: torch.Tensor,
    edge_i: torch.Tensor,
    edge_j: torch.Tensor,
    edge_T: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-edge residuals and local 6x6 Jacobian blocks at the current
    poses, every edge linearized around zero incremental twist:
    ``(r [E,6], A = dr/dxi [E,6,6], B = dr/dxj [E,6,6])``."""
    Ti = poses[edge_i.long()]
    Tj = poses[edge_j.long()]
    z = torch.zeros((edge_i.shape[0], 6), dtype=poses.dtype, device=poses.device)
    r = vmap(_edge_residual)(z, z, Ti, Tj, edge_T)
    A = vmap(jacfwd(_edge_residual, argnums=0))(z, z, Ti, Tj, edge_T)
    B = vmap(jacfwd(_edge_residual, argnums=1))(z, z, Ti, Tj, edge_T)
    return r, A, B


def _pcg_solve(
    A: torch.Tensor,
    B: torch.Tensor,
    r: torch.Tensor,
    we: torch.Tensor,
    edge_i: torch.Tensor,
    edge_j: torch.Tensor,
    k_cap: int,
    damping: float,
    cg_iters: int,
    axis=None,
) -> torch.Tensor:
    """Solve (H + damping I) dx = -b matrix-free with block-Jacobi PCG.

    H = sum_e w_e J_e^T J_e is never formed; a Hessian-vector product is
    two [E,6,6]x[E,6] batched products and one segment sum.  Gauge: node 0
    pinned (its block acts as identity).  With ``axis`` (a
    ``parallel.collectives.MapAxis``) the edge arrays are this member's
    share and each segment sum is summed over the members: a [K,6] per
    Hessian-vector product and for the gradient, a [K,6,6] for the
    preconditioner."""
    dev = A.device
    E = edge_i.shape[0]
    nodes = torch.arange(k_cap, dtype=edge_i.dtype, device=dev)
    gauge = (nodes > 0).to(torch.float32)[:, None]
    inc_i = (nodes[:, None] == edge_i[None, :]).to(torch.float32)   # [K, E]
    inc_j = (nodes[:, None] == edge_j[None, :]).to(torch.float32)
    eye6 = torch.eye(6, device=dev)

    def seg(gi, gj):
        """sum over the edges at each node: [E, ...] -> [K, ...]."""
        shape = (k_cap,) + gi.shape[1:]
        out = (inc_i @ gi.reshape(E, -1) + inc_j @ gj.reshape(E, -1)).reshape(shape)
        return out if axis is None else axis.psum(out)

    def mv(M, x):     # [N,a,b] x [N,b] -> [N,a]
        return (M @ x[..., None])[..., 0]

    def mtv(M, x):    # [N,a,b] x [N,a] -> [N,b]
        return (M.transpose(-1, -2) @ x[..., None])[..., 0]

    ei, ej = edge_i.long(), edge_j.long()

    def hvp(v):
        v = v * gauge
        u = (mv(A, v[ei]) + mv(B, v[ej])) * we[:, None]
        return seg(mtv(A, u), mtv(B, u)) * gauge + damping * v

    rw = r * we[:, None]
    b = seg(mtv(A, rw), mtv(B, rw)) * gauge

    # Block-Jacobi preconditioner: the [6,6] diagonal blocks of H.
    wA = A * we[:, None, None]
    wB = B * we[:, None, None]
    P = seg(A.transpose(-1, -2) @ wA, B.transpose(-1, -2) @ wB)
    P = P + (damping + 1e-8) * eye6
    P = torch.where(gauge[..., None] > 0, P, eye6)
    Minv = torch.linalg.inv_ex(P).inverse

    def apply_M(x):
        return mv(Minv, x) * gauge

    x = torch.zeros((k_cap, 6), device=dev)
    res = -b - hvp(x)
    z = apply_M(res)
    p = z
    rz = torch.sum(res * z)
    for _ in range(cg_iters):
        hp = hvp(p)
        denom = torch.sum(p * hp)
        alpha = torch.where(torch.abs(denom) > 1e-20, rz / denom, 0.0)
        x = x + alpha * p
        res = res - alpha * hp
        z = apply_M(res)
        rz_n = torch.sum(res * z)
        beta = torch.where(torch.abs(rz) > 1e-20, rz_n / rz, 0.0)
        p = z + beta * p
        rz = rz_n
    return torch.where(torch.all(torch.isfinite(x)), x, 0.0)


def _finish(pg: PoseGraph, poses: torch.Tensor) -> Tuple[PoseGraph, torch.Tensor]:
    """The graph with its live keyframes at ``poses``, and its chi2."""
    k_cap = pg.kf_poses.shape[0]
    live = (torch.arange(k_cap, device=poses.device) < pg.num_kf)[:, None, None]
    pg = pg._replace(kf_poses=torch.where(live, poses, pg.kf_poses))
    zero = torch.zeros((k_cap, 6), device=poses.device)
    return pg, torch.sum(edge_residuals(zero, pg) ** 2)


def optimize_pcg(pg: PoseGraph, cfg: PoseGraphConfig) -> Tuple[PoseGraph, torch.Tensor]:
    """Scalable Gauss-Newton: per-edge Jacobian blocks + matrix-free PCG,
    linear in the edge count.  Semantics (gauge, damping, Huber IRLS,
    weights) as :func:`optimize`'s dense solve."""
    k_cap = pg.kf_poses.shape[0]
    e_cap = pg.edge_i.shape[0]
    evalid = (torch.arange(e_cap, device=pg.kf_poses.device) < pg.num_edges).to(torch.float32)
    poses = pg.kf_poses
    for _ in range(cfg.gn_iters):
        r, A, B = edge_jacobians(poses, pg.edge_i, pg.edge_j, pg.edge_T)
        we = _huber_weights(r, cfg.huber_delta) * pg.edge_weight * evalid
        dx = _pcg_solve(A, B, r, we, pg.edge_i, pg.edge_j, k_cap, cfg.damping, cfg.cg_iters)
        poses = se3_exp(dx) @ poses
    return _finish(pg, poses)


def optimize(pg: PoseGraph, cfg: PoseGraphConfig) -> Tuple[PoseGraph, torch.Tensor]:
    """Damped Gauss-Newton over all keyframe poses (gauge: node 0 fixed).
    ``cfg.solver``: "pcg" (default) is :func:`optimize_pcg`; "dense" the
    explicit [6K, 6K] solve below, the exact-semantics reference.  Returns
    (optimized graph, final chi2)."""
    if cfg.solver == "pcg":
        return optimize_pcg(pg, cfg)
    dev = pg.kf_poses.device
    k_cap = pg.kf_poses.shape[0]
    n_params = 6 * k_cap
    # Gauge fixing: node 0's rows and columns zeroed, identity on its
    # diagonal block.
    mask = (torch.arange(n_params, device=dev) >= 6).to(torch.float32)
    eye = torch.eye(n_params, device=dev)

    def flat_residuals(t):
        return edge_residuals(t, pg).reshape(-1)

    twists = torch.zeros((k_cap, 6), device=dev)
    for _ in range(cfg.gn_iters):
        r = edge_residuals(twists, pg)                              # [E, 6]
        J = jacfwd(flat_residuals)(twists).reshape(-1, n_params)    # [6E, 6K]
        w = torch.repeat_interleave(_huber_weights(r, cfg.huber_delta) * pg.edge_weight, 6)
        Jw = J * w[:, None]
        H = Jw.T @ J
        b = Jw.T @ r.reshape(-1)
        H = H * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
        b = b * mask
        H = H + cfg.damping * eye
        dx = torch.linalg.solve_ex(H, -b).result
        dx = torch.where(torch.all(torch.isfinite(dx)), dx, 0.0)
        twists = twists + dx.reshape(k_cap, 6)
    return _finish(pg, se3_exp(twists) @ pg.kf_poses)
