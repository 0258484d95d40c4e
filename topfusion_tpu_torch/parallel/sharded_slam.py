"""The composed system: full SLAM on the sharded block map (port of
``topfusion_tpu/parallel/sharded_slam.py``), one process per shard over a
``MapAxis``.

Everything that exists is reused:

  * the per-frame map work is ``ShardedBlockPipeline.step`` (summed ICP,
    owned allocation, local integration, composited splat);
  * the chunk (steps, keyframe inserts, loop detection, the ring) is
    ``models/slam.SlamSystem._chunk``, inherited: the map is this
    shard's, the pose graph, keyframe buffers and ring are replicated and
    advance identically on every shard.  It runs eagerly (``_make_runner``
    gives no runner): the gloo collectives of a world that shares one
    card cannot be captured in a CUDA graph;
  * the loop's solve goes through ``parallel/dist_ba.optimize_distributed``
    on the same axis: the edges split over the shards, keyframe-sized
    sums.  As in the JAX package this is PCG whatever
    ``posegraph.solver`` says;
  * re-integration is the inherited ``_reint`` with its two map
    primitives, fuse-at-pose and the model-map refresh, in their
    shard-aware forms;
  * the out-of-core swap is ``models/host_cache.ShardedHostCache``, whose
    ``remap_store`` exchanges re-keyed blocks between the shards.

The JAX package runs one SPMD program, so its host code cannot diverge
between shards.  Here each shard's host decides for itself whether a loop
was found, whether the correction moved enough to rebuild, which
keyframes were added, and how many frames a rebuild re-fuses; each branch
issues collectives.  So the packed fetch of the chunk and that of the
solve are broadcast from shard 0 before the host reads them
(``_to_host``): every shard takes the same branches by construction.

With one shard every collective returns its input and the system is
``SlamSystem``, bit for bit.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..config import PipelineConfig, resolve_pallas_integrate
from ..models.block_pipeline import BlockState
from ..models.host_cache import ShardedHostCache
from ..models.posegraph import PoseGraph, _row
from ..models.slam import SlamSystem
from ..ops.cuda.integrate import integrate_blocks_cuda
from ..ops.depth import depth_to_meters
from ..ops.normals import resize_points_normals
from ..ops.splat import splat_model_maps
from ..ops.tsdf_block import allocate_from_depth, integrate_blocks, visible_blocks
from ..utils.checkpoint import load_state, save_state
from ..utils.device_info import entry_device
from ..utils.numerics import norm3
from .block_sharded import ShardedBlockPipeline
from .collectives import MapAxis, make_mesh
from .dist_ba import optimize_distributed
from .multihost import check_same_frame, restore_sharded_checkpoint, save_sharded_checkpoint


class ShardedSlamSystem(SlamSystem):
    """``SlamSystem`` with the map sharded over ``axis`` (a ``MapAxis``, on
    its device; by default the initialized default group on ``device``,
    the card unless the caller names another).  The host surface is
    ``SlamSystem``'s; every shard calls every method with the same
    arguments.  Color fusion is not sharded."""

    def __init__(self, cfg: PipelineConfig, axis: MapAxis | None = None,
                 render_in_chunk: bool = False, device="cuda"):
        self.axis = make_mesh(entry_device(device)) if axis is None else axis
        super().__init__(cfg, render_in_chunk=render_in_chunk, device=self.axis.device)

    # ------------------------------------------------------------- build
    def _build_pipe(self) -> None:
        self.pipe = ShardedBlockPipeline(self.cfg, self.axis, self.device)
        self.state: BlockState = self.pipe.init()

    def _attach_swap(self) -> None:
        self.swap = ShardedHostCache(self.pipe)

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        """Shard 0's packed result on every shard's host: one broadcast."""
        return self.axis.broadcast(t).cpu().numpy()

    def _make_runner(self):
        """None: the chunk, the solve and the rebuild run eagerly (gloo's
        collectives cannot be captured)."""
        return None

    # ---------------------------------------------------------- optimize
    def _optimize_ex(self, graph: PoseGraph, kf_odom_last: torch.Tensor):
        """The solve with the edges split over the axis (keyframe-sized
        sums, ``parallel/dist_ba.py``), then the re-anchor decision's
        inputs."""
        graph, _chi2 = optimize_distributed(graph, self.cfg.posegraph, self.axis)
        kf_opt_last = _row(graph.kf_poses, torch.clamp(graph.num_kf - 1, min=0))
        moved = norm3(kf_opt_last[:3, 3] - kf_odom_last[:3, 3])
        return graph, kf_opt_last, moved

    # ------------------------------------------------------------- reint
    def _fuse_at(self, state: BlockState, depth_mm, T_wc) -> BlockState:
        """Fuse one depth image at a fixed pose into the sharded map, as
        the step does: candidates split over the shards' rows and
        gathered, only owned blocks inserted, the shard's visible blocks
        integrated locally (the kernel on the card)."""
        lc, dev = self.pipe.local_cfg, self.device
        raw = depth_to_meters(depth_mm, lc.preproc.max_sensor_depth)
        m, _ = allocate_from_depth(state.block_map(), lc.camera, lc.tsdf, lc.blockmap, T_wc, raw,
                                   shard=self.pipe.shard, row_shard=self.axis)
        vis = visible_blocks(m, lc.camera, lc.tsdf, lc.blockmap, T_wc)
        fn = integrate_blocks_cuda if resolve_pallas_integrate(lc.blockmap, dev) else integrate_blocks
        m, _ = fn(m, lc.camera, lc.tsdf, lc.blockmap, T_wc, raw, vis)
        return self.pipe.write_map(state, m)

    def _refresh_maps(self, state: BlockState, T_wc) -> BlockState:
        """The model maps from the rebuilt sharded map: the shards' splats
        composited, then the replicated pyramid; the shard's full-scan
        visible set."""
        lc = self.pipe.local_cfg
        m = state.block_map()
        vis = visible_blocks(m, lc.camera, lc.tsdf, lc.blockmap, T_wc)
        rc = splat_model_maps(
            m, lc.camera, lc.tsdf, lc.blockmap, T_wc, vis,
            surfels_per_block=lc.raycast.surfels_per_block,
            dilate_passes=lc.raycast.dilate_passes,
            axis=self.axis,
        )
        mp, mn = [rc.points], [rc.normals]
        for _ in range(lc.preproc.pyramid_levels - 1):
            p, n = resize_points_normals(mp[-1], mn[-1])
            mp.append(p)
            mn.append(n)
        return state._replace(T_wc=T_wc, model_points=tuple(mp), model_normals=tuple(mn),
                              vis_slots=vis[0])

    # -------------------------------------------------------------- swap
    def _swap_before(self, T_pred) -> None:
        self.state = self.swap.before_step(self.state, T_pred)

    def _swap_after(self) -> None:
        self.state = self.swap.after_step(self.state)

    # -------------------------------------------------------- checkpoint
    def _replicated(self):
        return (self.graph, self.kf_depth_buf, self.kf_odom_buf, self._ring() or ())

    def save_checkpoint(self, path: str) -> None:
        """Checkpoint of the composed system, the JAX package's files:
        every shard writes its local map to ``{path}.map.proc{rank}.npz``
        (``multihost.save_sharded_checkpoint``); shard 0 writes the
        replicated state (pose graph, keyframe buffers, ring) to
        ``{path}.rep.npz`` and the host bookkeeping to
        ``{path}.host.json``.  Each file is written under a temporary name
        and renamed.  ``path`` must be on a file system every shard
        sees."""
        rank = self.axis.rank
        save_sharded_checkpoint(f"{path}.map.proc{rank}.npz", self.state, self.frame_idx,
                                self.odom_poses, rank)
        if rank != 0:
            return
        tmp = f"{path}.rep.tmp.npz"
        save_state(tmp, self._replicated())
        os.replace(tmp, f"{path}.rep.npz")
        host = {
            "kf_for_frame": self.kf_for_frame,
            "kf_odom_poses": [np.asarray(p).tolist() for p in self.kf_odom_poses],
            "loops_closed": self.loops_closed,
            "reintegrations": self.reintegrations,
        }
        with open(f"{path}.host.json.tmp", "w") as f:
            json.dump(host, f)
        os.replace(f"{path}.host.json.tmp", f"{path}.host.json")

    def restore_checkpoint(self, path: str) -> None:
        """Restore a ``save_checkpoint`` into this freshly built system of
        the same configuration and world size; every shard loads its own
        map.  The files carry no epoch marker (nor do the JAX package's),
        and shards that resumed from different saves would issue
        different collectives: so every shard's frame index, and the
        frame count of the host bookkeeping, are gathered once, and every
        shard raises unless they all agree."""
        frame = -1
        err = None
        try:
            state, frame, poses = restore_sharded_checkpoint(
                f"{path}.map.proc{self.axis.rank}.npz", self.state, self.axis.rank)
            rep = load_state(f"{path}.rep.npz", self._replicated())
            with open(f"{path}.host.json") as f:
                host = json.load(f)
            if len(host["kf_for_frame"]) != frame:
                err, frame = (f"{path}.host.json covers {len(host['kf_for_frame'])} frames, "
                              f"the map {frame}"), -1
        except (OSError, KeyError, ValueError) as e:
            err = f"{type(e).__name__}: {e}"
        try:
            check_same_frame(self.axis, frame, f"{path}")
        except RuntimeError as e:
            raise RuntimeError(f"{e}" + (f"; this member: {err}" if err else "")) from None
        self.state, self.frame_idx, self.odom_poses = state, frame, poses
        self.graph, self.kf_depth_buf, self.kf_odom_buf = rep[:3]
        if self.R > 0:
            self.ring_depths, self.ring_poses, self.ring_kf = rep[3]
        self.kf_for_frame = list(host["kf_for_frame"])
        self.kf_odom_poses = [np.asarray(p, np.float32) for p in host["kf_odom_poses"]]
        self.loops_closed = int(host["loops_closed"])
        self.reintegrations = int(host["reintegrations"])


# ----------------------------------------------------------------------
def dryrun_sharded_slam(n_devices: int, axis: MapAxis | None = None, device="cuda") -> None:
    """The composed system at tiny shapes on a world of ``n_devices``
    shards: two chunks through the chunk program (keyframes inserted,
    loop detection run), then the distributed solve and the sharded
    re-integration, forced.  Every member of ``axis`` (by default the
    initialized default group) calls it."""
    from ..config import (
        BlockMapConfig,
        CameraConfig,
        ICPConfig,
        PoseGraphConfig,
        PreprocConfig,
        RaycastConfig,
        TSDFConfig,
    )
    from ..io.synthetic import SyntheticScene

    dev = entry_device(device)
    axis = make_mesh(dev) if axis is None else axis
    if axis.size != n_devices:
        raise ValueError(f"need a world of {n_devices} shards, have {axis.size}")
    cam = CameraConfig(width=64, height=48, fx=48.0, fy=48.0, cx=32.0, cy=24.0)
    cfg = PipelineConfig(
        camera=cam,
        preproc=PreprocConfig(bilateral_kernel_size=3, pyramid_levels=2),
        icp=ICPConfig(iters=(2, 2), level0_stride=1),
        tsdf=TSDFConfig(voxel_size=0.01, trunc_dist=0.04),
        blockmap=BlockMapConfig(
            capacity=512 * n_devices,
            max_new_blocks_per_frame=256 * n_devices,
            max_visible_blocks=256 * n_devices,
            alloc_pixel_stride=1,
        ),
        raycast=RaycastConfig(max_steps=48),
        posegraph=PoseGraphConfig(keyframe_every=2, max_keyframes=8, max_edges=16,
                                  loop_candidates=2, reint_ring=4),
    )
    slam = ShardedSlamSystem(cfg, axis, device=dev)
    depth = SyntheticScene().render_depth_mm(cam, torch.eye(4, device=dev))
    depths = torch.stack([depth, depth])
    infos = slam.process_chunk(depths, do_kf=True)
    infos += slam.process_chunk(depths, do_kf=True)
    if not all(i["ok"] for i in infos):
        raise RuntimeError("sharded SLAM lost tracking on a static frame")
    eye = torch.eye(4, device=dev)
    g, _, moved = slam._optimize_ex(slam.graph, eye)
    st, corr = slam._reint(slam.state, g, slam.kf_depth_buf, eye, slam.kf_odom_buf, slam._ring(),
                           slam.frame_idx, int(g.num_kf))
    total = int(axis.psum(st.num_blocks.reshape(1)))
    if total <= 0 or not bool(torch.isfinite(corr).all()) or not bool(torch.isfinite(moved)):
        raise RuntimeError(f"sharded re-integration failed: {total} blocks")
