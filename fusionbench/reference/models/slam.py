# Frozen copy of topfusion_tpu_torch/models/slam.py at commit 81038a6, the yardstick's plain reference,
# trimmed to what SlamSystem.process_chunk reaches eagerly (no runner, warm-up, render or swap).
"""Full SLAM system: block-sparse fusion odometry + keyframe pose graph
(port of ``topfusion_tpu/models/slam.py``), on the card unless the caller
names another device.

A chunk of frames is one call: the fusion step over every frame, the
keyframe inserts at every ``keyframe_every``-th frame of the chunk
(masked by ``do_kf`` and by tracking success), loop detection for the
keyframes inserted, and the re-integration ring's writes.  ``frame0`` and
``do_kf`` are 0-d device tensors and every part runs, masked, whatever
their values, as in the JAX package's ``_chunk_impl``: one program serves
every chunk of a given length.  The chunk reads nothing back until its
end, where one ``.cpu()`` of one packed tensor brings the poses, the
per-frame health and the loop flags to the host: one host sync per chunk,
whatever the number of frames (loop verification's eigenvalues come from
the eig6 kernel, which does not sync).

Here the chunk, the solve and the re-integration run eagerly.

Loop optimization and map re-integration fire on the host after a
closure, as in the JAX package: the pose-graph solve (one fetch), then
(when the newest keyframe moved by more than ``min_map_correction``) a
rebuild that wipes the map and re-fuses the stored keyframe depths, and
the ring's frames at full rate, at their corrected poses, one integrate
launch per re-fused frame, then re-anchors the live pose and model maps
(one fetch of the correction).

The live fusion pose stays consistent with the map (frame-to-model ICP
needs both in one frame); the pose graph keeps the optimized trajectory
that ATE and export read.

State that the JAX package replaces functionally is written in place
here where a copy would be large: the keyframe depth store, the ring, and
the graph's keyframe maps (see ``models/posegraph.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..geometry.se3 import se3_inverse
from ..ops.blockmap import reset_block_map
from ..ops.depth import depth_to_meters, downsample_depth, preprocess_depth
from ..ops.normals import compute_points_normals, resize_points_normals
from ..ops.splat import splat_model_maps
from ..ops.tsdf_block import allocate_from_depth, visible_blocks
from ..utils.device_info import entry_device
from ..utils.numerics import norm3
from .block_pipeline import BlockPipeline, BlockState
from .posegraph import (
    PoseGraph,
    _row,
    _set_row_,
    add_keyframe,
    detect_loop,
    make_pose_graph,
    optimize,
)

# Per-frame fields of the chunk's packed fetch, after the 16 of the pose.
_AUX_FIELDS = ("ok", "was_reset", "num_inliers", "num_blocks", "blocks_dropped",
               "visible_overflow")


def _i16(depth: torch.Tensor) -> torch.Tensor:
    """A u16 depth tensor's bits as int16 (u16 tensors support only
    casts; the selects and scatters of the depth stores run on these)."""
    return depth.view(torch.int16)


def stack_aux(auxes: list) -> NamedTuple:
    """Per-frame auxes as one, each field stacked to [n]."""
    return type(auxes[0])(*[torch.stack(v) for v in zip(*auxes)])


def _as_tensor(x) -> torch.Tensor:
    """A tensor as it is; an array (a read-only one too) as a CPU copy."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


class SlamSystem:
    def __init__(self, cfg: PipelineConfig, device="cuda"):
        if cfg.blockmap.out_of_core:
            raise NotImplementedError("the reference has no out-of-core cache")
        self.cfg = cfg
        self.device = entry_device(device)
        pgc = cfg.posegraph
        self.cam_l = cfg.camera.at_level(pgc.keyframe_level)
        self.pipe = BlockPipeline(self.cfg, self.device)
        self.state: BlockState = self.pipe.init()
        self.graph: PoseGraph = make_pose_graph(pgc, self.cam_l, self.device)
        self.kf_depth_buf, self.kf_odom_buf, ring = self._buffers()
        # Re-integration ring (reint_ring > 0): the last R raw depths, their
        # odometry poses and their latest keyframe index, on the device.
        self.R = pgc.reint_ring
        if self.R > 0:
            self.ring_depths, self.ring_poses, self.ring_kf = ring
        self.odom_poses: List[np.ndarray] = []
        self.kf_for_frame: List[int] = []   # index of the latest kf per frame
        self.kf_odom_poses: List[np.ndarray] = []  # kf pose at insert time
        self.loops_closed: int = 0
        self.reintegrations: int = 0
        self.frame_idx: int = 0

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        """A packed result of the chunk or the solve on the host, the
        chunk's decisions among it."""
        return t.cpu().numpy()

    # ------------------------------------------------------------------
    def _buffers(self):
        """Empty (keyframe depth store [K, H, W] u16, keyframe odometry
        poses [K, 4, 4], ring or None)."""
        pgc, cam, dev = self.cfg.posegraph, self.cfg.camera, self.device
        k = pgc.max_keyframes
        kf_buf = torch.zeros((k, cam.height, cam.width), dtype=torch.uint16, device=dev)
        kf_odom = torch.zeros((k, 4, 4), device=dev)
        ring = None
        if pgc.reint_ring > 0:
            r = pgc.reint_ring
            ring = (torch.zeros((r, cam.height, cam.width), dtype=torch.uint16, device=dev),
                    torch.zeros((r, 4, 4), device=dev),
                    torch.full((r,), -1, dtype=torch.int32, device=dev))
        return kf_buf, kf_odom, ring

    def _ring(self):
        if self.R > 0:
            return (self.ring_depths, self.ring_poses, self.ring_kf)
        return None

    # ------------------------------------------------------------------
    def _kf_maps(self, depth_mm):
        """Camera-space point and normal maps of a keyframe at
        ``keyframe_level``."""
        _, pyr = preprocess_depth(depth_mm, self.cfg.preproc)
        d = pyr[0]
        for _ in range(self.cfg.posegraph.keyframe_level):
            d = downsample_depth(d, self.cfg.preproc.pyramid_sigma_depth)
        return compute_points_normals(self.cam_l, d)

    # ------------------------------------------------------------------
    def _chunk(self, state, graph, kf_buf, kf_odom_buf, ring, depths, rgbs,
               frame0: torch.Tensor, do_kf: torch.Tensor):
        """The fusion step over the chunk's frames, then ``_chunk_tail``.
        ``frame0`` (int32, the global index of ``depths[0]``; the caller
        chunk-aligns it) and ``do_kf`` (bool) are 0-d device tensors.
        Returns (state, graph, kf_buf, kf_odom_buf, ring, poses [n,4,4],
        auxes (each field stacked to [n]), found, added, LoopInfo), all on
        the device."""
        n = depths.shape[0]
        poses, auxes = [], []
        for i in range(n):
            state, aux = self.pipe.step(state, depths[i], None if rgbs is None else rgbs[i])
            poses.append(state.T_wc)
            auxes.append(aux)
        poses, auxes = torch.stack(poses), stack_aux(auxes)
        graph, found, added, loop_info = self._chunk_tail(
            graph, kf_buf, kf_odom_buf, ring, depths, poses, auxes, frame0, do_kf)
        return (state, graph, kf_buf, kf_odom_buf, ring, poses, auxes,
                found, added, loop_info)

    def _chunk_tail(self, graph, kf_buf, kf_odom_buf, ring, depths, poses, auxes,
                    frame0: torch.Tensor, do_kf: torch.Tensor):
        """What follows the chunk's steps: the keyframe inserts at offsets
        0, keyframe_every, ... (each masked by ``do_kf`` and by its frame's
        tracking), loop detection for them (masked by any insert), the
        ring's writes.  ``kf_buf``, ``kf_odom_buf``, the ring and the
        graph's keyframe maps are written in place.  Returns (graph, found,
        added, LoopInfo)."""
        cfg = self.cfg
        dev = self.device
        n = depths.shape[0]
        offsets = list(range(0, n, cfg.posegraph.keyframe_every))
        k_cap = graph.kf_poses.shape[0]
        num_kf0 = graph.num_kf
        added = []
        for off in offsets:
            p, nrm = self._kf_maps(depths[off])
            idx = graph.num_kf
            do_add = do_kf & ~auxes.was_reset[off]
            graph = add_keyframe(graph, poses[off], p, nrm, frame0 + off, do_add)
            # Added only if it FIT: past max_keyframes the graph drops
            # it, and the host's keyframe list must not grow past it.
            fit = do_add & (idx < k_cap)
            _set_row_(_i16(kf_buf), idx, fit, _i16(depths[off]))
            _set_row_(kf_odom_buf, idx, fit, poses[off])
            added.append(fit)
        added = torch.stack(added)
        # Detection covers every keyframe this chunk inserted.
        pgc_chunk = dataclasses.replace(
            cfg.posegraph,
            loop_queries=max(cfg.posegraph.loop_queries, len(offsets)),
        )
        graph, found, loop_info = detect_loop(
            graph, self.cam_l, pgc_chunk, cfg.icp, enable=torch.any(added)
        )

        if ring is not None:
            # Every frame of the chunk into slot (frame % R): raw depth,
            # odometry pose, and the frame's LATEST keyframe index.
            rd, rp, rk = ring
            frames = torch.arange(n, dtype=torch.int32, device=dev)
            idxs = ((frames + frame0) % rd.shape[0]).long()
            off_arr = torch.arange(0, n, cfg.posegraph.keyframe_every,
                                   dtype=torch.int32, device=dev)
            count_le = torch.sum((off_arr[None, :] <= frames[:, None]) & added[None, :],
                                 dim=1, dtype=torch.int32)
            latest = num_kf0 - 1 + count_le
            _i16(rd)[idxs] = _i16(depths)
            rp[idxs] = poses
            rk[idxs] = torch.where(latest >= 0, latest, -1)

        return graph, found, added, loop_info

    def _pack(self, poses, auxes, found, added, loop_info) -> torch.Tensor:
        """The chunk's results as one float64 tensor (exact for the
        float32 poses and the integer counts): the poses, the per-frame
        fields of ``_AUX_FIELDS``, found, added, the loop info."""
        n = poses.shape[0]
        per_frame = torch.stack([getattr(auxes, f).to(torch.float64) for f in _AUX_FIELDS], dim=1)
        return torch.cat([
            poses.reshape(n, 16).to(torch.float64).reshape(-1),
            per_frame.reshape(-1),
            found.reshape(1).to(torch.float64),
            added.to(torch.float64),
            torch.stack([loop_info.n_closed.to(torch.float64),
                         loop_info.inliers.to(torch.float64),
                         loop_info.residual.to(torch.float64)]),
        ])

    def packed_len(self, n: int) -> int:
        """The length of ``_pack``'s tensor for a chunk of ``n`` frames."""
        n_offsets = len(range(0, n, self.cfg.posegraph.keyframe_every))
        return (16 + len(_AUX_FIELDS)) * n + 1 + n_offsets + 3

    def _fetch(self, packed: torch.Tensor, n: int) -> dict:
        """A chunk of ``n`` frames' packed results on the host, by ONE
        device-to-host copy."""
        packed = self._to_host(packed)
        k = 16 * n
        aux = packed[k: k + len(_AUX_FIELDS) * n].reshape(n, len(_AUX_FIELDS))
        rest = packed[k + len(_AUX_FIELDS) * n:]
        return {
            "poses": packed[:k].reshape(n, 4, 4).astype(np.float32),
            **{f: aux[:, i] for i, f in enumerate(_AUX_FIELDS)},
            "found": bool(rest[0]),
            "added": rest[1:-3] != 0,
            "loop_closures": int(rest[-3]),
            "loop_inliers": int(rest[-2]),
            "loop_residual": float(rest[-1]),
        }

    # ------------------------------------------------------------------
    def _optimize_ex(self, graph: PoseGraph, kf_odom_last: torch.Tensor):
        """Pose-graph solve + the re-anchor decision's inputs: (graph, the
        newest keyframe's optimized pose, how far it moved)."""
        graph, _chi2 = optimize(graph, self.cfg.posegraph)
        kf_opt_last = _row(graph.kf_poses, torch.clamp(graph.num_kf - 1, min=0))
        moved = norm3(kf_opt_last[:3, 3] - kf_odom_last[:3, 3])
        return graph, kf_opt_last, moved

    # ------------------------------------------------------------------
    def _fuse_at(self, state: BlockState, depth_mm, T_wc) -> BlockState:
        """Fuse one depth image at a FIXED pose (no tracking): the
        primitive of post-loop re-integration, one integrate launch."""
        cfg = self.cfg
        raw = depth_to_meters(depth_mm, cfg.preproc.max_sensor_depth)
        m, _ = allocate_from_depth(state.block_map(), cfg.camera, cfg.tsdf, cfg.blockmap,
                                   T_wc, raw)
        vis = visible_blocks(m, cfg.camera, cfg.tsdf, cfg.blockmap, T_wc)
        m, _ = self.pipe.integrate(m, T_wc, raw, vis)
        return self.pipe.write_map(state, m)

    def _refresh_maps(self, state: BlockState, T_wc) -> BlockState:
        """The ICP model-map pyramid from the (rebuilt) map at the
        corrected live pose, and the full-scan visible set in place of the
        aged one."""
        cfg = self.cfg
        m = state.block_map()
        vis = visible_blocks(m, cfg.camera, cfg.tsdf, cfg.blockmap, T_wc)
        rc = splat_model_maps(
            m, cfg.camera, cfg.tsdf, cfg.blockmap, T_wc, vis,
            surfels_per_block=cfg.raycast.surfels_per_block,
            dilate_passes=cfg.raycast.dilate_passes,
        )
        mp, mn = [rc.points], [rc.normals]
        for _ in range(cfg.preproc.pyramid_levels - 1):
            p, n = resize_points_normals(mp[-1], mn[-1])
            mp.append(p)
            mn.append(n)
        return state._replace(T_wc=T_wc, model_points=tuple(mp), model_normals=tuple(mn),
                              vis_slots=vis[0])

    def _reint_start(self, state: BlockState, frame_now: torch.Tensor):
        """The rebuild's wipe (``reset_block_map``), and the first frame the
        ring covers, ``max(frame_now - R, 0)`` (1 << 30 without a ring:
        nothing covered).  ``frame_now`` is a 0-d int32 device tensor.
        Returns (state, ring_min)."""
        st = self.pipe.write_map(state, reset_block_map(state.block_map()))
        if self.R > 0:
            ring_min = torch.clamp(frame_now - self.R, min=0)
        else:
            ring_min = torch.full((), 1 << 30, dtype=torch.int32, device=frame_now.device)
        return st, ring_min

    def _reint_kf(self, st: BlockState, graph: PoseGraph, kf_buf, ring_min, k) -> BlockState:
        """The keyframe body: keyframe ``k`` (a 0-d int32 device tensor)
        re-fused from the store at its optimized pose; one whose frame the
        ring covers re-fuses zero depth (it still launches)."""
        covered = _row(graph.kf_frame, k) >= ring_min
        d = torch.where(covered, 0, _i16(_row(kf_buf, k))).view(torch.uint16)
        return self._fuse_at(st, d, _row(graph.kf_poses, k))

    def _reint_ring(self, st: BlockState, graph: PoseGraph, kf_odom_buf, ring, g) -> BlockState:
        """The ring body: global frame ``g`` (a 0-d int32 device tensor)
        from slot g % R at its corrected pose ``kf_opt[k] @ inv(kf_odom[k])
        @ T_odom``, k its latest keyframe (none: zero depth)."""
        rd, rp, rk = ring
        slot = g % rd.shape[0]
        kk = _row(rk, slot)
        k = torch.clamp(kk, min=0)
        corr_f = _row(graph.kf_poses, k) @ se3_inverse(_row(kf_odom_buf, k))
        d = torch.where(kk >= 0, _i16(_row(rd, slot)), 0).view(torch.uint16)
        return self._fuse_at(st, d, corr_f @ _row(rp, slot))

    def _reint_finish(self, st: BlockState, T_live, graph: PoseGraph, kf_odom_last):
        """The re-anchor: the live pose ``T_live`` through the newest
        keyframe's correction, and the model maps from the rebuilt map
        there.  Returns (state, correction 4x4)."""
        kf_opt_last = _row(graph.kf_poses, torch.clamp(graph.num_kf - 1, min=0))
        corr = kf_opt_last @ se3_inverse(kf_odom_last)
        return self._refresh_maps(st, corr @ T_live), corr

    def _reint(self, state, graph, kf_buf, kf_odom_last, kf_odom_buf, ring,
               frame_now: int, num_kf: int):
        """Global re-integration after a loop closure: wipe the map,
        re-fuse the stored keyframe depths at their OPTIMIZED poses and,
        with a ring, every ring frame at its corrected pose, then
        re-anchor the live pose and model maps.  The loops' trip counts
        are host integers (``num_kf`` keyframes, the ring's frames before
        ``frame_now``); their indices are device values, as in the JAX
        package's while loops.  Returns (state, correction 4x4)."""
        i32 = dict(dtype=torch.int32, device=self.device)
        st, ring_min = self._reint_start(state, torch.full((), frame_now, **i32))
        k = torch.zeros((), **i32)
        for _ in range(num_kf):
            st = self._reint_kf(st, graph, kf_buf, ring_min, k)
            k = k + 1
        if ring is not None:
            g = ring_min
            for _ in range(frame_now - max(frame_now - self.R, 0)):
                st = self._reint_ring(st, graph, kf_odom_buf, ring, g)
                g = g + 1
        return self._reint_finish(st, state.T_wc, graph, kf_odom_last)

    # ------------------------------------------------------------------
    def _dispatch_chunk(self, depths, rgb, do_kf: bool) -> torch.Tensor:
        """The chunk at ``self.frame_idx`` over the live buffers
        (``_chunk``).  Returns the packed results on the device (``_fetch``
        reads them)."""
        dev = self.device
        out = self._chunk(self.state, self.graph, self.kf_depth_buf, self.kf_odom_buf,
                          self._ring(), depths, rgb,
                          torch.full((), self.frame_idx, dtype=torch.int32, device=dev),
                          torch.full((), do_kf, dtype=torch.bool, device=dev))
        self.state, self.graph, self.kf_depth_buf, self.kf_odom_buf = out[:4]
        if self.R > 0:
            self.ring_depths, self.ring_poses, self.ring_kf = out[4]
        return self._pack(*out[5:10])

    def _solve(self, kf_odom_last: torch.Tensor) -> torch.Tensor:
        """The pose-graph solve over the live graph (``_optimize_ex``);
        returns the newest keyframe's optimized pose and how far it moved,
        packed [17] on the device."""
        self.graph, kf_opt_last, moved = self._optimize_ex(self.graph, kf_odom_last)
        return torch.cat([kf_opt_last.reshape(-1), moved.reshape(1)])

    def process_chunk(self, depths, do_kf: bool = True, rgb=None) -> List[dict]:
        """Process N frames ([N, H, W] depth in mm, a tensor or array);
        ``depths[0]`` is the chunk's keyframe when ``do_kf``.  ``rgb``
        ([N, H, W, 3] uint8) also fuses color (``cfg.tsdf.use_color``).
        Call with chunk-aligned frame indices (the app does).  Returns one
        info dict per frame."""
        cfg = self.cfg
        depths = _as_tensor(depths).to(self.device)
        if depths.dtype != torch.uint16:
            depths = depths.to(torch.uint16)
        n = depths.shape[0]
        if self.R > 0 and n > self.R:
            # Frame g goes to ring slot g % R: a longer chunk would write
            # one slot twice and break the rebuild's slot invariant.
            raise ValueError(
                f"chunk of {n} frames exceeds posegraph.reint_ring="
                f"{self.R}; use chunks <= the ring length or enlarge it"
            )
        if rgb is not None:
            rgb = _as_tensor(rgb).to(self.device)

        got = self._fetch(self._dispatch_chunk(depths, rgb, bool(do_kf)), n)
        offsets = list(range(0, n, cfg.posegraph.keyframe_every))

        infos = []
        for i in range(n):
            self.odom_poses.append(got["poses"][i])
            infos.append({
                "frame": self.frame_idx + i,
                "ok": bool(got["ok"][i]),
                "reset": bool(got["was_reset"][i]),
                "inliers": int(got["num_inliers"][i]),
                "blocks": int(got["num_blocks"][i]),
                "dropped": int(got["blocks_dropped"][i]),
                "visible_overflow": int(got["visible_overflow"][i]),
                "loop": False,
            })
        # A keyframe at frame i anchors frames i.. onward.
        j = 0
        for i in range(n):
            while j < len(offsets) and offsets[j] == i:
                if got["added"][j]:
                    self.kf_odom_poses.append(got["poses"][i])
                j += 1
            self.kf_for_frame.append(max(len(self.kf_odom_poses) - 1, 0))
        self.frame_idx += n

        if got["found"]:
            for key in ("loop_closures", "loop_inliers", "loop_residual"):
                infos[0][key] = got[key]
            kidx = len(self.kf_odom_poses) - 1
            kf_odom_last = self.kf_odom_buf[kidx].clone()
            solved = self._solve(kf_odom_last)
            kf_opt_last = solved[:16].reshape(4, 4)
            host = self._to_host(solved)
            kf_opt_last_np, moved = host[:16].reshape(4, 4), float(host[16])
            self.loops_closed += 1
            infos[0]["loop"] = True
            pgc = cfg.posegraph
            if pgc.map_correction == "reintegrate" and moved > pgc.min_map_correction:
                self.state, corr = self._reint(
                    self.state, self.graph, self.kf_depth_buf, kf_odom_last,
                    self.kf_odom_buf, self._ring(), self.frame_idx, len(self.kf_odom_poses),
                )
                corr_np = corr.cpu().numpy()
                # This chunk was tracked before the correction: move its
                # exported odometry into the corrected frame.
                for j in range(1, n + 1):
                    self.odom_poses[-j] = corr_np @ self.odom_poses[-j]
                self.kf_odom_poses[-1] = kf_opt_last_np
                # Mirror the re-anchor on the device buffers the ring
                # correction reads, or a SECOND closure would apply this
                # correction twice.
                self.kf_odom_buf[kidx] = kf_opt_last
                if self.R > 0:
                    sel = self.ring_kf == kidx
                    self.ring_poses.copy_(torch.where(sel[:, None, None], corr @ self.ring_poses,
                                                      self.ring_poses))
                self.reintegrations += 1
                infos[0]["reintegrated"] = True
        return infos
