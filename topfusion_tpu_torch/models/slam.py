"""Full SLAM system: block-sparse fusion odometry + keyframe pose graph
(port of ``topfusion_tpu/models/slam.py``), on the card unless the caller
names another device.

A chunk of frames is one call: the fusion step over every frame (a Python
loop over ``BlockPipeline.step``), the keyframe inserts at every
``keyframe_every``-th frame of the chunk (masked by tracking success),
loop detection for the keyframes inserted, and the re-integration ring's
writes.  The chunk reads nothing back until its end, where one ``.cpu()``
of one packed tensor brings the poses, the per-frame health and the loop
flags to the host.  Its host syncs are ICP's ``eigvalsh`` per frame, one
more for the batched loop verification, and that fetch: n + 2 for n
frames.

Loop optimization and map re-integration fire on the host after a
closure, as in the JAX package: the pose-graph solve, then (when the
newest keyframe moved by more than ``min_map_correction``) a rebuild that
wipes the map and re-fuses the stored keyframe depths, and the ring's
frames at full rate, at their corrected poses, one integrate launch per
re-fused frame, then re-anchors the live pose and model maps.

The live fusion pose stays consistent with the map (frame-to-model ICP
needs both in one frame); the pose graph keeps the optimized trajectory
that ATE and export read.

State that the JAX package replaces functionally is written in place
here where a copy would be large: the keyframe depth store, the ring, and
the graph's keyframe maps (see ``models/posegraph.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List

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
from .block_pipeline import BlockPipeline, BlockState, shade
from .posegraph import (
    LoopInfo,
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


def _as_tensor(x) -> torch.Tensor:
    """A tensor as it is; an array (a read-only one too) as a CPU copy."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


class SlamSystem:
    def __init__(self, cfg: PipelineConfig, render_in_chunk: bool = False, device="cuda"):
        self.cfg = cfg
        self.device = entry_device(device)
        pgc = cfg.posegraph
        self.cam_l = cfg.camera.at_level(pgc.keyframe_level)
        # Shade the model maps the step already made into a display image
        # inside the chunk (one elementwise pass, not a raycast).
        self.render_in_chunk = render_in_chunk
        self._build_pipe()
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
        self.last_render = None   # device image when render_in_chunk
        # Out-of-core host cache: spill cold blocks between chunks,
        # restore them on frustum re-entry.
        self.swap = None
        if cfg.blockmap.out_of_core:
            self._attach_swap()

    # ------------------------------------------------------------------
    # Construction hooks: the sharded system (parallel/sharded_slam.py)
    # replaces the pipeline, the cache, the solve, the fuse-at-pose, the
    # model-map refresh and the host fetch, and inherits the rest.
    def _build_pipe(self) -> None:
        self.pipe = BlockPipeline(self.cfg, self.device)
        self.state: BlockState = self.pipe.init()

    def _attach_swap(self) -> None:
        from .host_cache import HostBlockCache

        cfg = self.cfg
        self.swap = HostBlockCache(cfg.blockmap, cfg.tsdf, cfg.camera, device=self.device)

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
               frame0: int, do_kf: bool):
        """The fusion step over the chunk's frames, the keyframe inserts at
        offsets 0, keyframe_every, ... of the chunk (when ``do_kf``; the
        caller chunk-aligns ``frame0``), loop detection for them, and the
        ring's writes.  ``kf_buf``, ``kf_odom_buf``, the ring and the
        graph's keyframe maps are written in place.  Returns (state, graph,
        kf_buf, kf_odom_buf, ring, poses [n,4,4], auxes, found, added,
        image or None, LoopInfo), all on the device."""
        cfg = self.cfg
        dev = self.device
        n = depths.shape[0]
        poses, auxes = [], []
        for i in range(n):
            state, aux = self.pipe.step(state, depths[i], None if rgbs is None else rgbs[i])
            poses.append(state.T_wc)
            auxes.append(aux)
        poses = torch.stack(poses)

        offsets = list(range(0, n, cfg.posegraph.keyframe_every))
        k_cap = graph.kf_poses.shape[0]
        num_kf0 = graph.num_kf
        if do_kf:
            added = []
            for off in offsets:
                p, nrm = self._kf_maps(depths[off])
                idx = graph.num_kf
                do_add = ~auxes[off].was_reset
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
        else:
            added = torch.zeros((len(offsets),), dtype=torch.bool, device=dev)
            found = torch.zeros((), dtype=torch.bool, device=dev)
            loop_info = LoopInfo(
                n_closed=torch.zeros((), dtype=torch.int32, device=dev),
                inliers=torch.full((), -1, dtype=torch.int32, device=dev),
                residual=torch.full((), float("inf"), device=dev),
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

        img = None
        if self.render_in_chunk:
            img = shade(state.model_points[0], state.model_normals[0], state.T_wc)
        return (state, graph, kf_buf, kf_odom_buf, ring, poses, auxes,
                found, added, img, loop_info)

    def _fetch(self, poses, auxes, found, added, loop_info) -> dict:
        """The chunk's results on the host, by ONE device-to-host copy of
        one packed float64 tensor (exact for the float32 poses and the
        integer counts)."""
        n = poses.shape[0]
        per_frame = torch.stack(
            [torch.stack([getattr(a, f) for a in auxes]).to(torch.float64) for f in _AUX_FIELDS],
            dim=1,
        )
        packed = torch.cat([
            poses.reshape(n, 16).to(torch.float64).reshape(-1),
            per_frame.reshape(-1),
            found.reshape(1).to(torch.float64),
            added.to(torch.float64),
            torch.stack([loop_info.n_closed.to(torch.float64),
                         loop_info.inliers.to(torch.float64),
                         loop_info.residual.to(torch.float64)]),
        ])
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

    def _reint(self, state, graph, kf_buf, kf_odom_last, kf_odom_buf, ring,
               frame_now: int, num_kf: int):
        """Global re-integration after a loop closure: wipe the map,
        re-fuse the stored keyframe depths at their OPTIMIZED poses and,
        with a ring, every ring frame at its corrected pose ``kf_opt[k] @
        inv(kf_odom[k]) @ T_odom`` (k = its latest keyframe); a keyframe
        whose frame the ring covers re-fuses zero depth (it still
        launches).  Both loops' trip counts are host integers
        (``num_kf`` keyframes, the ring's frames before ``frame_now``).
        Then re-anchor the live pose and model maps.  Returns (state,
        correction 4x4)."""
        st = self.pipe.write_map(state, reset_block_map(state.block_map()))
        ring_min = max(frame_now - ring[0].shape[0], 0) if ring is not None else 1 << 30
        for k in range(num_kf):
            covered = graph.kf_frame[k] >= ring_min
            d = torch.where(covered, 0, _i16(kf_buf[k])).view(torch.uint16)
            st = self._fuse_at(st, d, graph.kf_poses[k])
        if ring is not None:
            rd, rp, rk = ring
            for g in range(ring_min, frame_now):
                slot = g % rd.shape[0]
                k = torch.clamp(rk[slot], min=0)
                corr_f = _row(graph.kf_poses, k) @ se3_inverse(_row(kf_odom_buf, k))
                d = torch.where(rk[slot] >= 0, _i16(rd[slot]), 0).view(torch.uint16)
                st = self._fuse_at(st, d, corr_f @ rp[slot])
        # The live pose re-anchors through the newest keyframe's correction.
        kf_opt_last = _row(graph.kf_poses, torch.clamp(graph.num_kf - 1, min=0))
        corr = kf_opt_last @ se3_inverse(kf_odom_last)
        return self._refresh_maps(st, corr @ state.T_wc), corr

    # ------------------------------------------------------------------
    def warmup(self, chunk_size: int, with_rgb: bool = False) -> None:
        """Build the CUDA library and make every call the SLAM loop makes
        (two chunks, the solve, the re-integration, a chunk after it, a
        render and the fetch) on throwaway state, so that the first real
        chunk pays no lazy initialisation (library handles, kernel
        modules, the allocator's first blocks).  Nothing here compiles
        per shape, so the throwaway chunks hold at most two frames
        whatever ``chunk_size``.  The live state is untouched."""
        if self.device.type == "cuda":
            from ..ops.cuda.build import load_library

            load_library("integrate")
        n = min(chunk_size, 2)
        cam, dev = self.cfg.camera, self.device
        depths = torch.zeros((n, cam.height, cam.width), dtype=torch.uint16, device=dev)
        rgb = (torch.zeros((n, cam.height, cam.width, 3), dtype=torch.uint8, device=dev)
               if with_rgb else None)
        kf_buf, kf_odom, ring = self._buffers()
        graph = make_pose_graph(self.cfg.posegraph, self.cam_l, dev)
        out = self._chunk(self.pipe.init(), graph, kf_buf, kf_odom, ring, depths, rgb, 0, True)
        out = self._chunk(*out[:5], depths, rgb, 0, True)
        eye = torch.eye(4, device=dev)
        g, _, moved = self._optimize_ex(out[1], eye)
        st_r, corr = self._reint(out[0], g, out[2], eye, out[3], out[4], n, int(g.num_kf))
        out = self._chunk(st_r, g, *out[2:5], depths, rgb, 0, True)
        img = out[9] if self.render_in_chunk else self.pipe.render(out[0])
        self._fetch(out[5], out[6], out[7], out[8], out[10])
        torch.cat([moved.reshape(1), corr.reshape(-1), img.reshape(-1)[:1].float()]).cpu()

    # ------------------------------------------------------------------
    def _swap_before(self, T_pred) -> None:
        """Out-of-core restore of the blocks visible from ``T_pred``."""
        m = self.swap.before_step(self.state.block_map(), T_pred)
        self.state = self.pipe.write_map(self.state, m)

    def _swap_after(self) -> None:
        """Recency update + eviction under capacity pressure; the aged
        visible list follows a compaction (remapped on the device)."""
        m, remap = self.swap.after_step(self.state.block_map(), self.state.vis_slots)
        self.state = self.pipe.write_map(self.state, m)
        if remap is not None:
            vs = self.state.vis_slots
            self.state = self.state._replace(
                vis_slots=torch.where(vs >= 0, remap[vs.clamp(min=0).long()], -1))

    # ------------------------------------------------------------------
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

        if self.swap is not None:
            # Restore host-cached blocks visible from the last pose (lag:
            # one chunk, as the model maps lag one frame).
            self._swap_before(self.odom_poses[-1] if self.odom_poses
                              else np.eye(4, dtype=np.float32))

        out = self._chunk(self.state, self.graph, self.kf_depth_buf, self.kf_odom_buf,
                          self._ring(), depths, rgb, self.frame_idx, bool(do_kf))
        self.state, self.graph, self.kf_depth_buf, self.kf_odom_buf = out[:4]
        if self.R > 0:
            self.ring_depths, self.ring_poses, self.ring_kf = out[4]
        self.last_render = out[9]
        got = self._fetch(out[5], out[6], out[7], out[8], out[10])

        if self.swap is not None:
            self._swap_after()
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
            self.graph, kf_opt_last, moved = self._optimize_ex(self.graph, kf_odom_last)
            host = self._to_host(torch.cat([kf_opt_last.reshape(-1), moved.reshape(1)]))
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
                    self.ring_poses = torch.where(sel[:, None, None], corr @ self.ring_poses,
                                                  self.ring_poses)
                self.reintegrations += 1
                infos[0]["reintegrated"] = True
                if self.swap is not None:
                    # The map was rebuilt in the CORRECTED frame: carry the
                    # spilled blocks through the correction by re-keying;
                    # recency restarts.
                    self.swap.remap_store(corr_np)
                    self.swap.last_seen[:] = 0
        return infos

    # ------------------------------------------------------------------
    def process_frame(self, depth_mm) -> dict:
        """A chunk of one frame, the keyframe cadence decided on the host."""
        do_kf = self.frame_idx % self.cfg.posegraph.keyframe_every == 0
        return self.process_chunk(_as_tensor(depth_mm)[None], do_kf=do_kf)[0]

    # ------------------------------------------------------------------
    def optimized_trajectory(self) -> List[np.ndarray]:
        """Full-rate trajectory with the pose-graph corrections: each
        frame's odometry pose re-anchored to its latest keyframe's
        optimized pose."""
        if not self.kf_odom_poses:
            return list(self.odom_poses)
        kf_opt = self.graph.kf_poses.cpu().numpy()
        out = []
        for f, T in enumerate(self.odom_poses):
            k = self.kf_for_frame[f]
            correction = kf_opt[k] @ np.linalg.inv(self.kf_odom_poses[k])
            out.append(correction @ T)
        return out

    def render(self):
        return self.pipe.render(self.state)
