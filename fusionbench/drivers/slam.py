"""Driver of the configurations whose entry is the port's SLAM system:
``models.slam.SlamSystem.process_chunk`` on its captured runner, after
``SlamSystem.warmup(chunk)``.

Set-up renders the pass's frames on the card and holds them on the host,
as a sensor delivers them, builds the system and warms it.  The window
offers the frames open loop at the mix's rate: frame i is due at
i / rate seconds, and a chunk is handed over when its last frame is due
(or at once, when the system is behind).  A frame's latency runs from
its due time to its pose on the host.  Every chunk due in the window is
run; one that ends after the window's close is late, not missing.

The comparison checks the window's first chunk and its first ``LEAD``
chunks, both from the fresh system, and ``SAMPLED`` chunks drawn from the
seed, each from the program's state before it.  With ``"arrival": "closed"`` the chunks follow each other at once (the
knee's measurement) and ``notes.closed_fps`` gives the rate.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from fusionbench import compare, traffic
from fusionbench.system import Cut, HostSnapshot, build_config, fresh_peak, sync
from fusionbench.trace import Slice

from fusionbench.drivers.captured_step import faulty_step

# Chunks the comparison checks besides the window's first, drawn from the
# seed after the keyframes the loop search skips (closures come then).
SAMPLED = 2
FIRST_SAMPLED = 8
# The window's first chunks, compared as one run from the fresh system:
# the first loop closures and solves, and what the map and the graph
# gather before them.
LEAD = 12
SLICE_CHUNKS = 2
LIVE = ("state", "graph", "kf_depth_buf", "kf_odom_buf")
HOST = ("odom_poses", "kf_for_frame", "kf_odom_poses", "loops_closed", "reintegrations",
        "frame_idx")


class Driver:
    def __init__(self, run):
        self.run = run

    def setup(self) -> None:
        import topfusion_tpu_torch.config as port_config
        from topfusion_tpu_torch.models.slam import SlamSystem

        r = self.run
        mix = r.traffic
        phases = r.notes.setdefault("setup_phases_s", {})
        t = time.perf_counter()
        self.pipeline = r.config["pipeline"]
        self.chunk = mix["chunk"]
        self.poses = traffic.poses(mix, r.seed, r.seconds)
        frames = traffic.render(mix, self.pipeline["camera"], self.poses, r.device)
        n = frames.shape[0] - frames.shape[0] % self.chunk
        self.frames = frames[:n].cpu()
        if r.device.type == "cuda":
            self.frames = self.frames.pin_memory()
        del frames
        fresh_peak(r.device)
        self.n_chunks = n // self.chunk
        phases["traffic"] = time.perf_counter() - t
        t = time.perf_counter()
        self.slam = SlamSystem(build_config(port_config, self.pipeline), device=r.device)
        if r.fault:
            self.slam.pipe.step = faulty_step(self.slam.pipe.step, r.fault)
        self.slam.warmup(self.chunk)
        sync(r.device)
        phases["system_warmup"] = time.perf_counter() - t
        t = time.perf_counter()
        if r.trace and r.device.type == "cuda" and hasattr(self.slam, "_solve"):
            self._time_solves()
        self.compared = [0] + traffic.sample(r.seed, SAMPLED, FIRST_SAMPLED, self.n_chunks)
        self.lead = min(LEAD, self.n_chunks)
        self.spare = [HostSnapshot.like(self._live()) for _ in self.compared]
        self.spare_post = [HostSnapshot.like(self._post()) for _ in range(len(self.compared) + 1)]
        sync(r.device)
        phases["snapshot_buffers"] = time.perf_counter() - t

    def _time_solves(self) -> None:
        """CUDA events around each pose-graph solve of the window."""
        solve = self.slam._solve
        r = self.run
        self.solve_events = []

        def timed(*a, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = solve(*a, **kw)
            end.record()
            if self.in_window:
                self.solve_events.append((start, end))
            return out

        self.slam._solve = timed
        self.in_window = False

    def _live(self):
        return tuple(getattr(self.slam, k) for k in LIVE)

    def _post(self):
        return (self.slam.state, self.slam.graph.kf_poses, self.slam.graph.num_kf)

    def _host(self) -> dict:
        return {k: (list(v) if isinstance(v, list) else v)
                for k, v in ((k, getattr(self.slam, k)) for k in HOST)}

    # ------------------------------------------------------------------
    def window(self) -> None:
        r = self.run
        mix = r.traffic
        closed = mix["arrival"] == "closed"
        rate = None if closed else float(mix["arrival"]["rate_fps"])
        sl = Slice(r.spans) if r.trace and r.device.type == "cuda" else None
        slice_c0 = self.n_chunks // 2
        self.cuts = []
        self.results = []
        due = []
        done = []
        self.in_window = True
        t0 = time.perf_counter()
        for c in range(self.n_chunks):
            i0 = c * self.chunk
            pre = None
            if c in self.compared:
                with r.spans.span("snapshot"):
                    pre = (self.spare.pop(0).take(self._live()), self._host())
            if c == 0:
                first = pre
            if sl is not None and c == slice_c0:
                sync(r.device)
                sl.start()
            if not closed:
                hand_off = t0 + (i0 + self.chunk - 1) / rate
                wait = hand_off - time.perf_counter()
                if wait > 0:
                    with r.spans.span("wait"):
                        time.sleep(wait)
            t_call = time.perf_counter()
            with r.spans.span("process_chunk"):
                infos = self.slam.process_chunk(self.frames[i0:i0 + self.chunk])
            t_done = time.perf_counter()
            r.chunk_s.append(t_done - t_call)
            for i in range(self.chunk):
                due.append(t_call if closed else t0 + (i0 + i) / rate)
                done.append(t_done)
            self.results.append(infos)
            if pre is not None:
                with r.spans.span("snapshot"):
                    post = self.spare_post.pop(0).take(self._post())
                poses = np.stack(self.slam.odom_poses[-self.chunk:])
                self.cuts.append((Cut(c, range(i0, i0 + self.chunk), pre), post, infos, poses))
            if c == self.lead - 1:
                with r.spans.span("snapshot"):
                    post = self.spare_post.pop(0).take(self._post())
                n = self.lead * self.chunk
                self.cuts.append((Cut(-self.lead, range(0, n), first), post,
                                  [i for infos in self.results for i in infos],
                                  np.stack(self.slam.odom_poses[-n:])))
            if sl is not None and c == slice_c0 + SLICE_CHUNKS - 1:
                sl.stop()
                r.slice = sl.result
                r.slice_frames = SLICE_CHUNKS * self.chunk
        self.in_window = False
        r.window_s = done[-1] - t0
        r.latencies = [b - a for a, b in zip(due, done)]
        r.frames_done = len(done)
        r.attempted = self.n_chunks * self.chunk
        r.failed = sum(not info["ok"] for infos in self.results for info in infos)
        if getattr(self, "solve_events", None):
            sync(r.device)
            r.solve_ms = [a.elapsed_time(b) for a, b in self.solve_events]
        lat = sorted(r.latencies)
        r.notes.update(
            chunks=self.n_chunks, frames=r.frames_done,
            loops_closed=self.slam.loops_closed, reintegrations=self.slam.reintegrations,
            keyframes=len(self.slam.kf_odom_poses),
            closing_chunks=sum(bool(infos[0]["loop"]) for infos in self.results),
            latency_ms_median=1000 * lat[len(lat) // 2],
            latency_ms_max=1000 * lat[-1],
            late_chunks=sum(1 for s in r.chunk_s if s > self.chunk / (rate or 1e9)),
            blocks=self.results[-1][-1]["blocks"],
            visible_overflow_frames=sum(info["visible_overflow"] > 0
                                        for infos in self.results for info in infos),
            compared_chunks=[c[0].index for c in self.cuts],
        )
        if closed:
            r.notes["closed_fps"] = r.frames_done / r.window_s

    def after(self) -> None:
        pass

    def release(self) -> None:
        del self.slam

    # ------------------------------------------------------------------
    def _reference_chunk(self, cut, tf32: bool):
        """A reference system loaded with the program's state before
        ``cut`` (live buffers and host lists), run over its frames chunk
        by chunk."""
        import fusionbench.reference.config as ref_config
        from fusionbench.reference.models.block_pipeline import BlockState
        from fusionbench.reference.models.posegraph import PoseGraph
        from fusionbench.reference.models.slam import SlamSystem

        r = self.run
        ref = SlamSystem(build_config(ref_config, self.pipeline), device=r.device)
        snap, host = cut.pre
        state, graph, kf_buf, kf_odom = snap.to(r.device)
        ref.state, ref.graph = BlockState(*state), PoseGraph(*graph)
        ref.kf_depth_buf, ref.kf_odom_buf = kf_buf, kf_odom
        for k, v in host.items():
            setattr(ref, k, list(v) if isinstance(v, list) else v)
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        infos = []
        try:
            for i0 in range(cut.frames.start, cut.frames.stop, self.chunk):
                infos += ref.process_chunk(self.frames[i0:i0 + self.chunk])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        return {"state": ref.state, "kf_poses": ref.graph.kf_poses, "num_kf": ref.graph.num_kf,
                "poses": np.stack(ref.odom_poses[-len(cut.frames):]), "infos": infos}

    def _gaps(self, a: dict, b: dict) -> dict:
        """The numbers between two results of one chunk."""
        mu = self.pipeline["tsdf"]["trunc_dist"]
        pose = compare.pose_gap_mm(torch.from_numpy(a["poses"]), torch.from_numpy(b["poses"]))
        if [i["ok"] for i in a["infos"]] != [i["ok"] for i in b["infos"]]:
            pose = float("inf")
        n = int(b["num_kf"])
        kf = compare.pose_gap_mm(a["kf_poses"][:n], b["kf_poses"][:n])
        keys = ("loop", "reintegrated", "loop_closures")
        if int(a["num_kf"]) != n or [[i.get(k) for k in keys] for i in a["infos"]] != \
                [[i.get(k) for k in keys] for i in b["infos"]]:
            kf = float("inf")
        sdf, wt = compare.map_gaps(a["state"], b["state"], mu)
        return {"pose_gap_mm": pose, "kf_pose_gap_mm": kf, "sdf_gap_mm": sdf, "weight_gap": wt,
                "model_gap_mm": compare.model_gap_mm(a["state"].model_points[0],
                                                     b["state"].model_points[0])}

    def check(self):
        r = self.run
        numbers, control = {}, ({} if r.control else None)
        for cut, post, infos, poses in self.cuts:
            ref = self._reference_chunk(cut, False)
            state, kf_poses, num_kf = post.to(r.device)
            prog = {"state": state, "kf_poses": kf_poses, "num_kf": num_kf, "poses": poses,
                    "infos": infos}
            numbers = compare.worst(numbers, self._gaps(prog, ref))
            del prog, state
            if control is not None:
                low = self._reference_chunk(cut, True)
                control = compare.worst(control, self._gaps(low, ref))
        return numbers, control
