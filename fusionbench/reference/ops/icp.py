# Frozen copy of topfusion_tpu_torch/ops/icp.py at commit 81038a6, the yardstick's plain reference.
"""Projective point-to-plane ICP, frame-to-model (port of
``topfusion_tpu/ops/icp.py``).

Each gated correspondence contributes a row ``[J | r]`` (7 floats) and
the system is one Gram matmul ``G = rows^T rows`` (``torch.matmul`` with
TF32 off, as XLA computed it outside any kernel); the 6x6 damped solve
stays on the device (``torch.linalg.solve_ex``, no error-check sync), so
``icp_track`` makes no host sync.  It returns the final undamped 6x6
Gram matrix; ``obs_ratio(gram)`` turns it into the observability ratio
that loop verification gates on, only for its one reader
(``models/posegraph.detect_loop``): the JAX package computes the ratio
in every call, and XLA drops it unread from every jitted step.  The
eigenvalues come from a fixed-sweep Jacobi solver in float64, on the
card the hand-written kernel ``csrc/eig6.cu`` (``ops/cuda/eig6.py``),
on the CPU its plain twin here; neither synchronizes the host
(``torch.linalg.eigvalsh`` does on the card, to check its result).

Gather modes: ``flat`` (the default; here a row gather of the
concatenated 6-channel map, nearest or bilinear), ``take`` (plain
indexing, the semantic reference) and ``onehot`` (nearest association
through ``ops/gather_mm.banded_projective_gather``, which drops
correspondences displaced vertically beyond ``onehot_v_margin``; its
bilinear iterations, the polish among them, go through ``take`` as in
the JAX package).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from ..config import CameraConfig, ICPConfig
from ..geometry.camera import project
from ..geometry.se3 import (
    rotate_vectors,
    se3_exp,
    se3_inverse,
    transform_points,
)
from .gather_mm import banded_projective_gather

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class ICPResult(NamedTuple):
    T_wc: torch.Tensor          # (4, 4) estimated camera-to-world pose
    ok: torch.Tensor            # () bool — tracking success
    residual: torch.Tensor      # () mean |r| over inliers at final iter
    num_inliers: torch.Tensor   # () int32 at final iter
    # (6, 6) f32 final (undamped) JtJ: ``obs_ratio(gram)`` is the JAX
    # package's ``obs_ratio``.
    gram: torch.Tensor


# Jacobi sweeps over the 15 (p, q) pairs of a 6x6 matrix, as csrc/eig6.cu
# (whose note gives the count).
JACOBI_SWEEPS = 8
_PAIRS = tuple((p, q) for p in range(6) for q in range(p + 1, 6))


def _jacobi_rotate(a: torch.Tensor, p: int, q: int) -> None:
    """One Rutishauser rotation of the symmetric [B, 6, 6] float64 ``a``
    at (p, q), in place, skipped (by a select) where a_pq is 0: the
    float64 operations of ``csrc/eig6.cu``'s ``rotate``, one rounding
    each (every division a tensor by a tensor)."""
    apq, app, aqq = a[:, p, q], a[:, p, p], a[:, q, q]
    one = torch.ones_like(apq)
    theta = (aqq - app) / (apq * 2.0)
    sgn = torch.where(theta >= 0.0, one, -one)
    t = sgn / (torch.abs(theta) + torch.sqrt(theta * theta + 1.0))
    c = one / torch.sqrt(t * t + 1.0)
    s = t * c
    tau = (s / (c + 1.0))[:, None]
    s = s[:, None]
    h = t * apq
    skip = (apq == 0.0)[:, None]
    ap, aq = a[:, :, p], a[:, :, q]
    new_p = ap - s * (aq + tau * ap)
    new_q = aq + s * (ap - tau * aq)
    new_p[:, p], new_p[:, q] = app - h, 0.0
    new_q[:, q], new_q[:, p] = aqq + h, 0.0
    new_p = torch.where(skip, ap, new_p)
    new_q = torch.where(skip, aq, new_q)
    a[:, :, p] = new_p
    a[:, p, :] = new_p
    a[:, :, q] = new_q
    a[:, q, :] = new_q


def jacobi_eigvals6(gram: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of [..., 6, 6] symmetric matrices (the lower triangle
    is read, as ``torch.linalg.eigvalsh`` reads it), ascending, float64:
    ``JACOBI_SWEEPS`` cyclic Jacobi sweeps in float64, the plain twin of
    the kernel ``csrc/eig6.cu``, bit for bit."""
    batch = gram.shape[:-2]
    g = gram.reshape(-1, 6, 6).to(torch.float64)
    lower = torch.ones(6, 6, dtype=torch.bool, device=g.device).tril()
    a = torch.where(lower, g, g.transpose(-1, -2))
    for _ in range(JACOBI_SWEEPS):
        for p, q in _PAIRS:
            _jacobi_rotate(a, p, q)
    eig = torch.diagonal(a, dim1=-2, dim2=-1)
    return torch.sort(eig, dim=-1).values.reshape(*batch, 6)


def ratio_from_eigvals(eig: torch.Tensor) -> torch.Tensor:
    """``clamp(lambda_min, 0) / clamp(lambda_max, 1e-20)`` of [..., 6]
    eigenvalues, each rounded to float32 first and divided in float32 (as
    the ratio of ``torch.linalg.eigvalsh``'s float32 eigenvalues was);
    NaN propagates."""
    lo = torch.amin(eig, dim=-1).to(torch.float32)
    hi = torch.amax(eig, dim=-1).to(torch.float32)
    return torch.where(lo < 0.0, 0.0, lo) / torch.where(hi < 1e-20, 1e-20, hi)


def obs_ratio_plain(gram: torch.Tensor) -> torch.Tensor:
    """``obs_ratio`` in plain PyTorch: the kernel's twin."""
    return ratio_from_eigvals(jacobi_eigvals6(gram))


def obs_ratio(gram: torch.Tensor) -> torch.Tensor:
    """Observability of [..., 6, 6] float32 JtJ matrices: lambda_min /
    lambda_max (float32), ~1e-7 on rank-deficient geometry (a bare wall),
    ~1e-3 and more on a well-constrained scene.  On the card the kernel
    ``csrc/eig6.cu`` (one launch, no host sync); on the CPU its plain
    twin."""
    return obs_ratio_plain(gram)


def _any_nonzero(x: torch.Tensor) -> torch.Tensor:
    return torch.any(x != 0.0, dim=-1)


def _bilinear_quad(uf, vf, h, w, gather):
    """Corners (g00, g01, g10, g11) of the quad at (uf, vf), clamped to
    the image, with the fractional weights (fu, fv) [..., 1]."""
    u0 = torch.clamp(torch.floor(uf).to(torch.int32), 0, w - 2)
    v0 = torch.clamp(torch.floor(vf).to(torch.int32), 0, h - 2)
    fu = torch.clamp(uf - u0.to(uf.dtype), 0.0, 1.0)[..., None]
    fv = torch.clamp(vf - v0.to(vf.dtype), 0.0, 1.0)[..., None]
    return gather(u0, v0), fu, fv


def _lerp(g00, g01, g10, g11, fu, fv):
    return (
        g00 * (1 - fu) * (1 - fv)
        + g01 * fu * (1 - fv)
        + g10 * (1 - fu) * fv
        + g11 * fu * fv
    )


def _normalized(nq_w):
    nq_norm = torch.linalg.vector_norm(nq_w, dim=-1, keepdim=True)
    return nq_w / torch.clamp(nq_norm, min=1e-12), nq_norm[..., 0]


def build_normal_equations(
    cam: CameraConfig,
    T_est: torch.Tensor,
    T_model: torch.Tensor,
    curr_points: torch.Tensor,
    curr_normals: torch.Tensor,
    model_points: torch.Tensor,
    model_normals: torch.Tensor,
    dist_thresh: float,
    angle_cos_thresh: float,
    bilinear: bool = False,
    gather_mode: str = "take",
    onehot_v_margin: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One projective-association pass -> 7x7 Gram matrix + inlier count.

    ``G[:6, :6] = JtJ``, ``G[:6, 6] = Jtr``, ``G[6, 6] = r^T r``.
    """
    h, w = model_points.shape[:2]
    curr_valid = _any_nonzero(curr_points)

    p_w = transform_points(T_est, curr_points)
    n_w = rotate_vectors(T_est, curr_normals)

    p_model_cam = transform_points(se3_inverse(T_model), p_w)
    uv, z = project(cam, p_model_cam)
    uf, vf = uv[..., 0], uv[..., 1]
    in_bounds = (uf >= 0.0) & (uf <= w - 1.0) & (vf >= 0.0) & (vf <= h - 1.0) & (z > 0.0)

    if gather_mode == "flat":
        # Points and normals as one [h*w, 6] table gathered by rows (the JAX
        # package pads rows to 8 channels for the TPU's layout).
        cat = torch.cat([model_points, model_normals], dim=-1).reshape(h * w, 6)

    if gather_mode == "flat" and bilinear:
        # One row gather of all four corners; quad usable only if all four
        # corners are valid, else the nearest corner of the quad.
        def gather(u0, v0):
            base = (v0 * w + u0).long()
            quad = cat[torch.stack([base, base + 1, base + w, base + w + 1], dim=-1)]
            return [quad[..., i, :] for i in range(4)]

        (g00, g01, g10, g11), fu, fv = _bilinear_quad(uf, vf, h, w, gather)
        all_valid = (
            _any_nonzero(g00[..., :3]) & _any_nonzero(g01[..., :3])
            & _any_nonzero(g10[..., :3]) & _any_nonzero(g11[..., :3])
        )
        lerped = _lerp(g00, g01, g10, g11, fu, fv)
        right = (fu[..., 0] > 0.5)[..., None]
        down = (fv[..., 0] > 0.5)[..., None]
        near = torch.where(
            down, torch.where(right, g11, g10), torch.where(right, g01, g00)
        )
        gathered = torch.where(all_valid[..., None], lerped, near)
        q_w = gathered[..., :3]
        nq_w, nq_norm = _normalized(gathered[..., 3:6])
        model_valid = _any_nonzero(q_w) & (nq_norm > 1e-6)
    elif bilinear:
        def gather(u0, v0):
            u0, v0 = u0.long(), v0.long()
            return [(mp[v0, u0], mp[v0, u0 + 1], mp[v0 + 1, u0], mp[v0 + 1, u0 + 1])
                    for mp in (model_points, model_normals)]

        ((q00, q01, q10, q11), (n00, n01, n10, n11)), fu, fv = _bilinear_quad(
            uf, vf, h, w, gather
        )
        all_valid = (
            _any_nonzero(q00) & _any_nonzero(q01)
            & _any_nonzero(q10) & _any_nonzero(q11)
        )
        un = torch.clamp(torch.round(uf).to(torch.int32), 0, w - 1).long()
        vn = torch.clamp(torch.round(vf).to(torch.int32), 0, h - 1).long()
        q_w = torch.where(all_valid[..., None],
                          _lerp(q00, q01, q10, q11, fu, fv), model_points[vn, un])
        nq_w = torch.where(all_valid[..., None],
                           _lerp(n00, n01, n10, n11, fu, fv), model_normals[vn, un])
        nq_w, nq_norm = _normalized(nq_w)
        model_valid = _any_nonzero(q_w) & (nq_norm > 1e-6)
    elif gather_mode == "onehot":
        # Rounded with no clip, as the JAX package: the band gather gates
        # off-image and non-finite indices itself.
        un = torch.round(uf).to(torch.int32)
        vn = torch.round(vf).to(torch.int32)
        cat = torch.cat([model_points, model_normals], dim=-1)
        gathered, band_ok = banded_projective_gather(cat, un, vn, v_margin=onehot_v_margin)
        q_w = gathered[..., :3]
        nq_w = gathered[..., 3:]
        model_valid = band_ok & _any_nonzero(q_w)
    else:
        un = torch.clamp(torch.round(uf).to(torch.int32), 0, w - 1).long()
        vn = torch.clamp(torch.round(vf).to(torch.int32), 0, h - 1).long()
        if gather_mode == "flat":
            gathered = cat[vn * w + un]
            q_w = gathered[..., :3]
            nq_w = gathered[..., 3:6]
        else:
            q_w = model_points[vn, un]
            nq_w = model_normals[vn, un]
        model_valid = _any_nonzero(q_w)

    diff = p_w - q_w
    dist2 = torch.sum(diff * diff, dim=-1)
    angle_cos = torch.sum(nq_w * n_w, dim=-1)

    mask = (
        curr_valid
        & in_bounds
        & model_valid
        & (dist2 <= dist_thresh * dist_thresh)
        & (angle_cos >= angle_cos_thresh)
    )

    r = torch.sum(nq_w * diff, dim=-1)
    j_omega = torch.linalg.cross(p_w, nq_w, dim=-1)
    rows = torch.cat([j_omega, nq_w, r[..., None]], dim=-1)
    rows = torch.where(mask[..., None], rows, 0.0).reshape(-1, 7)

    G = rows.T @ rows
    count = torch.sum(mask, dtype=torch.int32)
    return G, count


def _solve_increment(
    G: torch.Tensor,
    count: torch.Tensor,
    cfg: ICPConfig,
    min_corresp: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """6x6 damped solve -> (twist xi, ok flag), without a host sync."""
    A = G[:6, :6]
    b = -G[:6, 6]
    eye = torch.eye(6, dtype=G.dtype, device=G.device)
    A_damped = A + cfg.damping * torch.diag(torch.diag(A)) + 1e-12 * eye
    det = torch.linalg.det(A_damped)
    xi, info = torch.linalg.solve_ex(A_damped, b)
    finite = torch.all(torch.isfinite(xi)) & (info == 0)
    ok = (
        (torch.abs(det) > cfg.min_det)
        & (count >= (cfg.min_corresp if min_corresp is None else min_corresp))
        & finite
    )
    xi = torch.where(ok & finite, xi, 0.0)
    return xi, ok


def icp_track(
    cam0: CameraConfig,
    cfg: ICPConfig,
    T_init: torch.Tensor,
    T_model: torch.Tensor,
    curr_points_pyr: List[torch.Tensor],
    curr_normals_pyr: List[torch.Tensor],
    model_points_pyr: List[torch.Tensor],
    model_normals_pyr: List[torch.Tensor],
    axis=None,
) -> ICPResult:
    """Coarse-to-fine frame-to-model tracking: levels coarsest first with
    ``cfg.iters[level]`` iterations each; the last
    ``bilinear_polish_iters`` of the finest level associate bilinearly
    on rows subsampled by a further ``polish_stride``.

    With ``axis`` (a ``parallel.collectives.MapAxis``) each member passes
    its own rows of the current maps, and the 7x7 Gram matrix and the
    correspondence count are summed over the axis in every iteration,
    before the solve, so that every member takes the same step.
    """
    dev = T_init.device
    T_est = T_init
    ok_all = torch.ones((), dtype=torch.bool, device=dev)
    residual = torch.zeros((), dtype=torch.float32, device=dev)
    inliers = torch.zeros((), dtype=torch.int32, device=dev)
    G_last = torch.zeros((7, 7), dtype=torch.float32, device=dev)

    n_levels = len(curr_points_pyr)
    for level in range(n_levels - 1, -1, -1):
        iters = cfg.iters[level] if level < len(cfg.iters) else 0
        if iters == 0:
            continue
        cam_l = cam0.at_level(level)
        cp, cn = curr_points_pyr[level], curr_normals_pyr[level]
        mp, mn = model_points_pyr[level], model_normals_pyr[level]
        if level == 0 and cfg.level0_stride > 1:
            st = cfg.level0_stride
            cp, cn = cp[::st, ::st], cn[::st, ::st]

        def step(carry, bilinear_l):
            T = carry[0]
            G, count = build_normal_equations(
                cam_l, T, T_model, cp, cn, mp, mn,
                cfg.dist_threshold, cfg.angle_threshold_cos,
                bilinear=bilinear_l, gather_mode=cfg.gather_mode,
                onehot_v_margin=cfg.onehot_v_margin,
            )
            if axis is not None:
                G, count = axis.psum_gram(G, count)
            xi, step_ok = _solve_increment(
                G, count, cfg, min_corresp=max(8, cfg.min_corresp // 4 ** level)
            )
            T = torch.where(step_ok, se3_exp(xi) @ T, T)
            res = torch.sqrt(G[6, 6] / torch.clamp(count, min=1).to(torch.float32))
            # Tracking health is the LAST iteration's gate (a rejected step
            # freezes the pose and later iterations may recover).
            return T, step_ok, res, count, G

        polish = (
            min(cfg.bilinear_polish_iters, iters)
            if (level == 0 and not cfg.bilinear)
            else 0
        )
        carry = (T_est, ok_all, residual, inliers, G_last)
        for _ in range(iters - polish):
            carry = step(carry, cfg.bilinear)
        if polish:
            ps = cfg.polish_stride
            # Subsample further only while the system keeps plenty of rows.
            if ps > 1 and (cp.shape[0] // ps) * (cp.shape[1] // ps) >= 4096:
                cp, cn = cp[::ps, ::ps], cn[::ps, ::ps]
            else:
                ps = 1
            for _ in range(polish):
                carry = step(carry, True)
            T, ok, res, cnt, G = carry
            # Inliers reported at pre-polish row density.
            carry = (T, ok, res, cnt * (ps * ps), G)
        T_est, ok_all, residual, inliers, G_last = carry

    return ICPResult(
        T_wc=T_est, ok=ok_all, residual=residual, num_inliers=inliers,
        gram=G_last[:6, :6],
    )
