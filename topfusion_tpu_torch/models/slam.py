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

On the card the chunk, the solve and the re-integration are CUDA graphs
(``CapturedSlam`` below, the counterpart of the JAX package's
``jax.jit``s), replayed over the system's live buffers.  On the CPU, and
in a system whose ``_make_runner`` gives no runner (the sharded one),
the same functions run eagerly.

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
the graph's keyframe maps (see ``models/posegraph.py``).  On the card
the live buffers belong to the runner's graphs: every write between
chunks goes INTO them (``_set_state``, ``copy_``), never rebinds them.
"""

from __future__ import annotations

import dataclasses
import time
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
from .block_pipeline import BlockPipeline, BlockState, shade
from .captured import CapturedStep, Graph, copy_into, map_state, stack_aux
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


def _as_tensor(x) -> torch.Tensor:
    """A tensor as it is; an array (a read-only one too) as a CPU copy."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


class SlamSystem:
    def __init__(self, cfg: PipelineConfig, render_in_chunk: bool = False, device="cuda"):
        self.cfg = cfg
        self.device = entry_device(device)
        self._runner = None
        self._warmed = False
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

    def _make_runner(self):
        """The runner of the captured chunk, solve and rebuild over this
        system's live buffers; None runs them eagerly (the sharded
        system)."""
        return CapturedSlam(self)

    def _get_runner(self):
        """On the card, the runner (made on first use); else None."""
        if self._runner is None and self.device.type == "cuda":
            self._runner = self._make_runner()
        return self._runner

    def _set_state(self, state: BlockState) -> None:
        """Make ``state`` the live one: written into the runner's buffers
        when there is a runner, else bound."""
        if self._runner is not None:
            copy_into(self.state, state)
        else:
            self.state = state

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
        auxes (each field stacked to [n]), found, added, image or None,
        LoopInfo), all on the device."""
        n = depths.shape[0]
        poses, auxes = [], []
        for i in range(n):
            state, aux = self.pipe.step(state, depths[i], None if rgbs is None else rgbs[i])
            poses.append(state.T_wc)
            auxes.append(aux)
        poses, auxes = torch.stack(poses), stack_aux(auxes)
        graph, found, added, img, loop_info = self._chunk_tail(
            state, graph, kf_buf, kf_odom_buf, ring, depths, poses, auxes, frame0, do_kf)
        return (state, graph, kf_buf, kf_odom_buf, ring, poses, auxes,
                found, added, img, loop_info)

    def _chunk_tail(self, state, graph, kf_buf, kf_odom_buf, ring, depths, poses, auxes,
                    frame0: torch.Tensor, do_kf: torch.Tensor):
        """What follows the chunk's steps: the keyframe inserts at offsets
        0, keyframe_every, ... (each masked by ``do_kf`` and by its frame's
        tracking), loop detection for them (masked by any insert), the
        ring's writes and the shade.  ``kf_buf``, ``kf_odom_buf``, the ring
        and the graph's keyframe maps are written in place.  Returns
        (graph, found, added, image or None, LoopInfo)."""
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

        img = None
        if self.render_in_chunk:
            img = shade(state.model_points[0], state.model_normals[0], state.T_wc)
        return graph, found, added, img, loop_info

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
        package's while loops.  On the card with a runner the captured
        bodies replay over the live buffers (``state`` etc. must be
        them); else the bodies run eagerly.  Returns (state, correction
        4x4)."""
        runner = self._get_runner()
        if runner is not None:
            return runner.reint(state, graph, kf_buf, kf_odom_last, kf_odom_buf, ring,
                                frame_now, num_kf)
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
    def _warm_eager(self, chunk_size: int, with_rgb: bool = False) -> None:
        """Build the CUDA libraries and make every call the SLAM loop makes
        (two chunks, the solve, the re-integration, a chunk after it, a
        render and the fetch) eagerly, on throwaway state, so that neither
        the first real chunk nor a capture pays a lazy initialisation
        (library handles, kernel modules, the allocator's first blocks).
        Nothing here compiles per shape, so the throwaway chunks hold at
        most two frames whatever ``chunk_size``.  The live state is
        untouched."""
        if self.device.type == "cuda":
            from ..ops.cuda.build import load_library

            load_library("integrate")
            load_library("eig6")
        n = min(chunk_size, 2)
        cam, dev = self.cfg.camera, self.device
        depths = torch.zeros((n, cam.height, cam.width), dtype=torch.uint16, device=dev)
        rgb = (torch.zeros((n, cam.height, cam.width, 3), dtype=torch.uint8, device=dev)
               if with_rgb else None)
        kf_buf, kf_odom, ring = self._buffers()
        graph = make_pose_graph(self.cfg.posegraph, self.cam_l, dev)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        yes = torch.ones((), dtype=torch.bool, device=dev)
        out = self._chunk(self.pipe.init(), graph, kf_buf, kf_odom, ring, depths, rgb, zero, yes)
        out = self._chunk(*out[:5], depths, rgb, zero, yes)
        eye = torch.eye(4, device=dev)
        g, kf_opt, moved = self._optimize_ex(out[1], eye)
        i32 = dict(dtype=torch.int32, device=dev)
        st, ring_min = self._reint_start(out[0], torch.full((), n, **i32))
        st = self._reint_kf(st, g, out[2], ring_min, torch.zeros((), **i32))
        if ring is not None:
            st = self._reint_ring(st, g, out[3], out[4], ring_min)
        st_r, corr = self._reint_finish(st, out[0].T_wc, g, eye)
        out = self._chunk(st_r, g, *out[2:5], depths, rgb, zero, yes)
        img = out[9] if self.render_in_chunk else self.pipe.render(out[0])
        self._fetch(self._pack(out[5], out[6], out[7], out[8], out[10]), n)
        torch.cat([kf_opt.reshape(-1), moved.reshape(1), corr.reshape(-1),
                   img.reshape(-1)[:1].float()]).cpu()
        self._warmed = True

    def warmup(self, chunk_size: int, with_rgb: bool = False) -> None:
        """The eager warm-up (``_warm_eager``), then, on the card, the
        captures of the chunk of ``chunk_size`` frames (its steps and its
        tail), the solve and the rebuild's bodies over the live buffers'
        shapes.  A capture runs nothing, so the live state is left as it
        was."""
        self._warm_eager(chunk_size, with_rgb)
        runner = self._get_runner()
        if runner is not None:
            runner.prepare(chunk_size, with_rgb)

    # ------------------------------------------------------------------
    def _swap_before(self, T_pred) -> None:
        """Out-of-core restore of the blocks visible from ``T_pred``."""
        m = self.swap.before_step(self.state.block_map(), T_pred)
        self._set_state(self.pipe.write_map(self.state, m))

    def _swap_after(self) -> None:
        """Recency update + eviction under capacity pressure; the aged
        visible list follows a compaction (remapped on the device)."""
        m, remap = self.swap.after_step(self.state.block_map(), self.state.vis_slots)
        st = self.pipe.write_map(self.state, m)
        if remap is not None:
            vs = st.vis_slots
            st = st._replace(vis_slots=torch.where(vs >= 0, remap[vs.clamp(min=0).long()], -1))
        self._set_state(st)

    # ------------------------------------------------------------------
    def _dispatch_chunk(self, depths, rgb, do_kf: bool) -> torch.Tensor:
        """The chunk at ``self.frame_idx`` over the live buffers: replayed
        by the runner, or ``_chunk`` eagerly.  Returns the packed results
        on the device (``_fetch`` reads them)."""
        runner = self._get_runner()
        if runner is not None:
            return runner.chunk(depths, rgb, self.frame_idx, do_kf)
        dev = self.device
        out = self._chunk(self.state, self.graph, self.kf_depth_buf, self.kf_odom_buf,
                          self._ring(), depths, rgb,
                          torch.full((), self.frame_idx, dtype=torch.int32, device=dev),
                          torch.full((), do_kf, dtype=torch.bool, device=dev))
        self.state, self.graph, self.kf_depth_buf, self.kf_odom_buf = out[:4]
        if self.R > 0:
            self.ring_depths, self.ring_poses, self.ring_kf = out[4]
        self.last_render = out[9]
        return self._pack(out[5], out[6], out[7], out[8], out[10])

    def _solve(self, kf_odom_last: torch.Tensor) -> torch.Tensor:
        """The pose-graph solve over the live graph (replayed by the
        runner, or ``_optimize_ex`` eagerly); returns the newest
        keyframe's optimized pose and how far it moved, packed [17] on the
        device."""
        runner = self._get_runner()
        if runner is not None:
            return runner.solve(kf_odom_last)
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

        if self.swap is not None:
            # Restore host-cached blocks visible from the last pose (lag:
            # one chunk, as the model maps lag one frame).
            self._swap_before(self.odom_poses[-1] if self.odom_poses
                              else np.eye(4, dtype=np.float32))

        got = self._fetch(self._dispatch_chunk(depths, rgb, bool(do_kf)), n)

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


# ----------------------------------------------------------------------
class _Tail:
    """The static buffers and the graph of one chunk length's tail."""

    def __init__(self, n: int, rgb: bool, aux: NamedTuple, slam, device):
        cam = slam.cfg.camera
        self.depths = torch.zeros((n, cam.height, cam.width), dtype=torch.int32,
                                  device=device).to(torch.uint16)
        self.rgbs = (torch.zeros((n, cam.height, cam.width, 3), dtype=torch.uint8, device=device)
                     if rgb else None)
        self.poses = torch.zeros((n, 4, 4), device=device)
        self.auxes = type(aux)(*[torch.zeros((n, *a.shape), dtype=a.dtype, device=device)
                                 for a in aux])
        # Results read after the replay, so allocated outside any capture
        # (the shared pool's memory is every graph's scratch).
        self.fetch = torch.zeros((slam.packed_len(n),), dtype=torch.float64, device=device)
        self.image = (torch.zeros((cam.height, cam.width, 3), dtype=torch.uint8, device=device)
                      if slam.render_in_chunk else None)
        self.graph = None


class CapturedSlam:
    """``SlamSystem``'s chunk, solve and rebuild as CUDA graphs over the
    system's live buffers (state, pose graph, keyframe stores, ring),
    made by the system on the card (``SlamSystem._make_runner``).

    For a chunk of n frames it replays n step graphs (a
    ``models/captured.CapturedStep`` over the live state) and one graph
    of the chunk's tail (keyframe inserts, loop detection, the ring's
    writes, the shade, the packing of the fetch), then the caller makes
    the one fetch; for a closure, one graph of the solve; for a rebuild,
    the JAX package's while-loop bodies (the wipe, a keyframe, a ring
    frame, the re-anchor), each captured once and replayed as many times
    as the host's counts say.  The tail is captured once per (chunk
    length, color) key, on first use, as ``jax.jit`` compiles once per
    shape; the rest on first use too, after the system's eager warm-up.
    Every graph of one system shares one memory pool: each keeps its
    results in static buffers allocated outside any capture, so what the
    pool holds is only one graph's temporaries at a time.  ``captures``
    and ``capture_s`` count the graphs captured and the seconds they
    took."""

    LIVE = ("state", "graph", "kf_depth_buf", "kf_odom_buf", "ring_depths", "ring_poses",
            "ring_kf")

    def __init__(self, slam):
        self.slam = slam
        self.device = slam.device
        dev = self.device
        self.pool = torch.cuda.graph_pool_handle()
        # The step graph writes the state back into these: unaliased,
        # contiguous copies.  The other stores are the system's own.
        slam.state = map_state(torch.clone, slam.state)
        self.live = {name: getattr(slam, name) for name in self.LIVE if hasattr(slam, name)}
        i32 = dict(dtype=torch.int32, device=dev)
        self.frame0 = torch.zeros((), **i32)
        self.do_kf = torch.zeros((), dtype=torch.bool, device=dev)
        self.frame_now = torch.zeros((), **i32)
        self.ring_min = torch.zeros((), **i32)
        self.k = torch.zeros((), **i32)
        self.g = torch.zeros((), **i32)
        self.kf_odom_last = torch.zeros((4, 4), device=dev)
        self.solved = torch.zeros((17,), device=dev)
        self.corr = torch.zeros((4, 4), device=dev)
        self.steps = {}     # rgb -> CapturedStep over the live state
        self.tails = {}     # (n, rgb) -> _Tail
        self.solve_graph = None
        self.rebuild = None  # (wipe, keyframe body, ring body or None, re-anchor)
        self.captures = 0
        self.capture_s = 0.0

    # ------------------------------------------------------------------
    def _adopt(self) -> None:
        """Bring values that were bound to the system's attributes (a
        restore, a state carried in) into the live buffers, and bind the
        buffers back."""
        for name, buf in self.live.items():
            cur = getattr(self.slam, name)
            if cur is not buf:
                if isinstance(buf, tuple):
                    copy_into(buf, cur)
                else:
                    buf.copy_(cur)
                setattr(self.slam, name, buf)

    def _captured(self, make):
        """``make()``'s capture, after the system's eager warm-up, counted
        and timed."""
        if not self.slam._warmed:
            self.slam._warm_eager(1)
        t0 = time.perf_counter()
        with torch.cuda.device(self.device), torch.no_grad():
            out = make()
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return out

    def _capture(self, fn) -> Graph:
        return self._captured(lambda: Graph(fn, self.pool))

    def _ring(self):
        """The live ring buffers, or None."""
        if self.slam.R == 0:
            return None
        return tuple(self.live[k] for k in ("ring_depths", "ring_poses", "ring_kf"))

    def _step(self, rgb: bool) -> CapturedStep:
        if rgb not in self.steps:
            self.steps[rgb] = self._captured(lambda: CapturedStep(
                self.slam.pipe, self.live["state"], rgb=rgb, pool=self.pool, adopt=True))
        return self.steps[rgb]

    def _tail(self, n: int, rgb: bool) -> _Tail:
        key = (n, rgb)
        if key in self.tails:
            return self.tails[key]
        slam = self.slam
        t = _Tail(n, rgb, self._step(rgb)._aux, slam, self.device)
        live = self.live

        def tail():
            graph, found, added, img, info = slam._chunk_tail(
                live["state"], live["graph"], live["kf_depth_buf"], live["kf_odom_buf"],
                self._ring(), t.depths, t.poses, t.auxes, self.frame0, self.do_kf)
            copy_into(live["graph"], graph)
            t.fetch.copy_(slam._pack(t.poses, t.auxes, found, added, info))
            if img is not None:
                t.image.copy_(img)

        t.graph = self._capture(tail)
        self.tails[key] = t
        return t

    def _solve(self) -> Graph:
        if self.solve_graph is None:
            slam, live = self.slam, self.live

            def solve():
                graph, kf_opt_last, moved = slam._optimize_ex(live["graph"], self.kf_odom_last)
                copy_into(live["graph"], graph)
                self.solved.copy_(torch.cat([kf_opt_last.reshape(-1), moved.reshape(1)]))

            self.solve_graph = self._capture(solve)
        return self.solve_graph

    def _rebuild(self):
        if self.rebuild is None:
            slam, live = self.slam, self.live

            def wipe():
                st, ring_min = slam._reint_start(live["state"], self.frame_now)
                copy_into(live["state"], st)
                self.ring_min.copy_(ring_min)
                self.k.zero_()
                self.g.copy_(ring_min)

            def keyframe():
                st = slam._reint_kf(live["state"], live["graph"], live["kf_depth_buf"],
                                    self.ring_min, self.k)
                copy_into(live["state"], st)
                self.k.add_(1)

            def ring_frame():
                st = slam._reint_ring(live["state"], live["graph"], live["kf_odom_buf"],
                                      self._ring(), self.g)
                copy_into(live["state"], st)
                self.g.add_(1)

            def reanchor():
                st, corr = slam._reint_finish(live["state"], live["state"].T_wc, live["graph"],
                                              self.kf_odom_last)
                copy_into(live["state"], st)
                self.corr.copy_(corr)

            self.rebuild = (self._capture(wipe), self._capture(keyframe),
                            self._capture(ring_frame) if slam.R > 0 else None,
                            self._capture(reanchor))
        return self.rebuild

    # ------------------------------------------------------------------
    def prepare(self, n: int, rgb: bool = False) -> None:
        """Capture what a chunk of ``n`` frames, a solve and a rebuild
        replay, now rather than on first use."""
        self._adopt()
        self._tail(n, rgb)
        self._solve()
        self._rebuild()

    def chunk(self, depths: torch.Tensor, rgbs, frame0: int, do_kf: bool) -> torch.Tensor:
        """The chunk of ``depths`` ([n, H, W] u16 on the card; ``rgbs``
        [n, H, W, 3] or None) at global frame ``frame0``: n step replays,
        each frame's pose and aux copied into slot i, one tail replay.
        Returns the packed results (a static buffer: read it before the
        next chunk).  No host sync."""
        self._adopt()
        n = depths.shape[0]
        t = self._tail(n, rgbs is not None)
        step = self._step(rgbs is not None)
        t.depths.copy_(depths)
        if rgbs is not None:
            t.rgbs.copy_(rgbs)
        self.frame0.fill_(frame0)
        self.do_kf.fill_(do_kf)
        st = self.live["state"]
        for i in range(n):
            step._depth.copy_(t.depths[i])
            if rgbs is not None:
                step._rgb.copy_(t.rgbs[i])
            step.replay()
            t.poses[i].copy_(st.T_wc)
            for dst, src in zip(t.auxes, step._aux):
                dst[i].copy_(src)
        t.graph.replay()
        self.slam.last_render = t.image
        return t.fetch

    def solve(self, kf_odom_last: torch.Tensor) -> torch.Tensor:
        """The solve over the live graph: [17] (the newest keyframe's
        optimized pose, how far it moved from ``kf_odom_last``), a static
        buffer."""
        self._adopt()
        g = self._solve()
        self.kf_odom_last.copy_(kf_odom_last)
        g.replay()
        return self.solved

    def reint(self, state, graph, kf_buf, kf_odom_last, kf_odom_buf, ring,
              frame_now: int, num_kf: int):
        """The rebuild over the live buffers (which ``state``, ``graph``,
        ``kf_buf``, ``kf_odom_buf`` and ``ring`` must be): the wipe,
        ``num_kf`` keyframe bodies, a ring body per frame the ring holds
        before ``frame_now``, the re-anchor.  Returns (the live state, the
        correction 4x4, a static buffer)."""
        self._adopt()
        live = self.live
        given = (state, graph, kf_buf, kf_odom_buf) + (tuple(ring) if ring is not None else ())
        want = (live["state"], live["graph"], live["kf_depth_buf"], live["kf_odom_buf"]) + (
            tuple(self._ring()) if ring is not None else ())
        if any(a is not b for a, b in zip(given, want)):
            raise ValueError("CapturedSlam.reint rebuilds the system's live buffers only")
        wipe, keyframe, ring_frame, reanchor = self._rebuild()
        self.kf_odom_last.copy_(kf_odom_last)
        self.frame_now.fill_(frame_now)
        wipe.replay()
        for _ in range(num_kf):
            keyframe.replay()
        if ring_frame is not None:
            for _ in range(frame_now - max(frame_now - self.slam.R, 0)):
                ring_frame.replay()
        reanchor.replay()
        return live["state"], self.corr
