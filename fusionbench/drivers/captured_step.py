"""Driver of the configurations whose entry is the port's captured
fusion step: ``models.captured.CapturedStep`` over
``models.block_pipeline.BlockPipeline``, in a closed loop.

Set-up renders the pass's frames to the card, builds the pipeline,
captures the step, runs the pass's first chunk from a fresh map (the
start the comparison checks) and the mix's set-up laps.  The window
runs chunks until ``seconds`` have passed, each chunk ``CapturedStep.run``
and one fetch of its per-frame results to the host; a lap of a mix with
``"replay": "laps"`` starts from a fresh map (``CapturedStep.load``).

The comparison checks the start, the first whole lap from a fresh map
(in the set-up laps, or else the window's first), both against the
reference run from a fresh map, and ``SAMPLED`` chunks of the window,
each from the program's state before it.
"""

from __future__ import annotations

import time

import torch

from fusionbench import compare, traffic
from fusionbench.system import Cut, HostSnapshot, build_config, fresh_peak, sync
from fusionbench.trace import Slice, profiled

# Chunks of the window the comparison checks, drawn from the seed among
# the chunks a system at FLOOR_FPS would finish in the window's first
# half (the traced slice lies in its second half).
SAMPLED = 2
FLOOR_FPS = 20.0
SLICE_CHUNKS = 4
# Cut indices of the start (the first chunk) and the first whole lap,
# both from a fresh map.
START, LAP = -1, -2


def faulty_step(step, fault):
    """``step`` broken as the comparison's tests break it."""
    def frozen(state, depth, *a):
        return state, step(state, depth, *a)[1]

    def half(state, depth, *a):
        d = depth.clone()
        d[: d.shape[0] // 2] = 0
        return step(state, d, *a)

    def altered(state, depth, *a):
        new, aux = step(state, depth, *a)
        shift = torch.zeros_like(new.T_wc)
        shift[0, 3] = 0.001
        return new._replace(T_wc=new.T_wc + shift), aux

    return {"frozen": frozen, "half": half, "altered": altered}[fault]


class Driver:
    def __init__(self, run):
        self.run = run

    # ------------------------------------------------------------------
    def setup(self) -> None:
        import topfusion_tpu_torch.config as port_config
        from topfusion_tpu_torch.models.block_pipeline import BlockPipeline
        from topfusion_tpu_torch.models.captured import CapturedStep

        r = self.run
        mix = r.traffic
        phases = r.notes.setdefault("setup_phases_s", {})
        t = time.perf_counter()
        self.pipeline = r.config["pipeline"]
        self.chunk = mix["chunk"]
        self.poses = traffic.poses(mix, r.seed, r.seconds)
        self.frames = traffic.render(mix, self.pipeline["camera"], self.poses, r.device)
        n = self.frames.shape[0] - self.frames.shape[0] % self.chunk
        self.chunks = [range(i, i + self.chunk) for i in range(0, n, self.chunk)]
        fresh_peak(r.device)
        phases["traffic"] = time.perf_counter() - t
        t = time.perf_counter()
        self.cfg = build_config(port_config, self.pipeline)
        self.pipe = BlockPipeline(self.cfg, r.device)
        if r.fault:
            self.pipe.step = faulty_step(self.pipe.step, r.fault)
        self.runner = CapturedStep(self.pipe, self.pipe.init())
        sync(r.device)
        phases["capture"] = time.perf_counter() - t
        t = time.perf_counter()
        # Host buffers of the compared chunks' states, before and after.
        like = self.runner.state()
        self.spare = [HostSnapshot.like(like) for _ in range(2 * SAMPLED + 2 + bool(r.trace))]
        del like
        # The start: the pass's first chunk from a fresh map.
        aux = self._fetch(self.runner.run(self._frames(self.chunks[0])))
        self.cuts = [(Cut(START, self.chunks[0], None), self._snapshot(), aux)]
        # Each chunk's results since the map was fresh, until a whole lap
        # from a fresh map has been kept for the comparison.
        self.lap = [aux]
        self.pos = 1
        self._lap_done()
        for _ in range(mix.get("setup_laps", 0)):
            while self.pos:
                self._step_chunk()
        if mix.get("replay") == "laps":
            self.runner.load(self.pipe.init())
            self.pos = 0
            if self.lap is not None:
                self.lap = []
        sync(r.device)
        phases["first_lap"] = time.perf_counter() - t

    def _snapshot(self) -> HostSnapshot:
        return self.spare.pop().take(self.runner.state())

    def _frames(self, idx: range) -> torch.Tensor:
        return self.frames[idx.start:idx.stop]

    def _fetch(self, aux) -> dict:
        """The chunk's per-frame results on the host, by one copy."""
        packed = torch.stack([v.to(torch.float64) for v in aux]).cpu()
        return {f: packed[i] for i, f in enumerate(aux._fields)}

    def _lap_done(self) -> None:
        """At the end of the first lap from a fresh map, keep its state
        and its frames' ``ok`` for the comparison."""
        if self.lap is None or self.pos:
            return
        with self.run.spans.span("snapshot"):
            post = self._snapshot()
        ok = torch.cat([a["ok"] for a in self.lap])
        self.cuts.append((Cut(LAP, range(0, len(ok)), None), post, {"ok": ok}))
        self.lap = None

    def _step_chunk(self, snapshot: bool = False):
        """The chunk at ``pos`` of the pass; returns its fetched results
        and, with ``snapshot``, the state it started from on the host."""
        r = self.run
        pre = None
        if self.pos == 0 and r.traffic.get("replay") == "laps":
            with r.spans.span("load"):
                self.runner.load(self.pipe.init())
            if self.lap is not None:
                self.lap = []
        if snapshot:
            with r.spans.span("snapshot"):
                pre = self._snapshot()
        with r.spans.span("run"):
            aux = self.runner.run(self._frames(self.chunks[self.pos]))
        with r.spans.span("fetch"):
            host = self._fetch(aux)
        self.pos = (self.pos + 1) % len(self.chunks)
        if self.lap is not None:
            self.lap.append(host)
            self._lap_done()
        return host, pre

    # ------------------------------------------------------------------
    def window(self) -> None:
        r = self.run
        floor = int(r.seconds * FLOOR_FPS / self.chunk)
        sampled = set(traffic.sample(r.seed, SAMPLED, 0, max(floor // 2, 1)))
        sl = Slice(r.spans) if r.trace and r.device.type == "cuda" else None
        self.auxes = []
        self.chunk_times = []
        self.slice_pre = None
        k = 0
        slice_k0 = None
        t0 = time.perf_counter()
        while True:
            pos = self.pos
            tc = time.perf_counter()
            host, pre = self._step_chunk(k in sampled)
            self.chunk_times.append(time.perf_counter() - tc)
            self.auxes.append(host)
            if pre is not None:
                with r.spans.span("snapshot"):
                    post = self._snapshot()
                self.cuts.append((Cut(k, self.chunks[pos], pre), post, host))
            k += 1
            t = time.perf_counter() - t0
            if sl is not None:
                if slice_k0 is None and t >= r.seconds / 2:
                    self.slice_pre = (self.pos, self._snapshot())
                    sync(r.device)
                    slice_k0 = k
                    sl.start()
                elif slice_k0 is not None and sl.result is None and k == slice_k0 + SLICE_CHUNKS:
                    sl.stop()
                    r.slice = sl.result
                    r.slice_frames = SLICE_CHUNKS * self.chunk
                    self.slice_aux = self.auxes[slice_k0:k]
            if t >= r.seconds and (sl is None or sl.result is not None):
                break
        r.window_s = t
        ct = sorted(self.chunk_times)
        r.notes["chunk_ms_quartiles"] = [1000 * ct[len(ct) // 4], 1000 * ct[len(ct) // 2],
                                         1000 * ct[3 * len(ct) // 4]]
        # Chunks 10% slower than the fastest quarter, and the last of them.
        slow = [i for i, x in enumerate(self.chunk_times) if x > 1.1 * ct[len(ct) // 4]]
        r.notes["slow_chunks"] = [len(slow), slow[-1] if slow else None]
        r.frames_done = k * self.chunk
        r.attempted = r.frames_done
        r.failed = int(sum(int((a["ok"] == 0).sum()) for a in self.auxes))
        last = self.auxes[-1]
        r.notes.update(
            chunks=k, frames=r.frames_done,
            num_blocks=int(last["num_blocks"][-1]),
            num_blocks_max=int(max(float(a["num_blocks"].max()) for a in self.auxes)),
            blocks_dropped=int(sum(float(a["blocks_dropped"].sum()) for a in self.auxes)),
            visible_overflow_max=int(max(float(a["visible_overflow"].max()) for a in self.auxes)),
            visible_overflow_frames=int(sum(int((a["visible_overflow"] > 0).sum())
                                            for a in self.auxes)),
            resets=int(sum(float(a["was_reset"].sum()) for a in self.auxes)),
            compared_chunks=[c[0].index for c in self.cuts],
        )
        if r.traffic.get("replay") == "laps":
            lap = self.auxes[:len(self.chunks)]
            r.notes["lap_frames"] = len(self.chunks) * self.chunk
            r.notes["first_lap_overflow_frames"] = int(sum(int((a["visible_overflow"] > 0).sum())
                                                           for a in lap))

    # ------------------------------------------------------------------
    def after(self) -> None:
        """Traced run only: each frame of the slice replayed from the
        state before it, for the voxels integration updated; then ICP and
        allocation with the visible set, one eager call each on the next
        frame, profiled."""
        from topfusion_tpu_torch.ops.depth import preprocess_depth
        from topfusion_tpu_torch.ops.icp import icp_track
        from topfusion_tpu_torch.ops.normals import build_maps_pyramid
        from topfusion_tpu_torch.ops.tsdf_block import (
            allocate_from_depth,
            visible_blocks_incremental,
        )

        r = self.run
        cfg, cam, bm = self.cfg, self.cfg.camera, self.cfg.blockmap
        state = self.runner.state()
        f = self.frames[self.chunks[self.pos][0]]
        raw_m, pyr = preprocess_depth(f, cfg.preproc)
        cur_pts, cur_nrm = build_maps_pyramid(cam, pyr)

        def icp():
            return icp_track(cam, cfg.icp, state.T_wc, state.T_wc, cur_pts, cur_nrm,
                             list(state.model_points), list(state.model_normals))

        T = icp().T_wc
        d_cull = raw_m if bm.visible_occlusion_cull else None

        def alloc():
            m, info = allocate_from_depth(state.block_map(), cam, cfg.tsdf, bm, T, raw_m,
                                          return_touched=True)
            return visible_blocks_incremental(m, cam, cfg.tsdf, bm, T, state.vis_slots,
                                              info.touched_slots, return_overflow=True,
                                              depth=d_cull)

        if r.device.type == "cuda":
            r.stages["icp"] = profiled(icp)
            r.stages["alloc"] = profiled(alloc)
        if self.slice_pre is not None:
            pos, snap = self.slice_pre
            self.runner.load(snap.to(r.device))
            vox = bm.block_size ** 3
            for c in range(SLICE_CHUNKS):
                p = (pos + c) % len(self.chunks)
                if p == 0 and r.traffic.get("replay") == "laps":
                    # As the window did: a lap starts from a fresh map.
                    self.runner.load(self.pipe.init())
                for i in self.chunks[p]:
                    before = self.runner.state()
                    aux = self.runner.run(self.frames[i:i + 1])
                    after = self.runner.state()
                    upd = int(((before.tsdf != after.tsdf) | (before.weight != after.weight)).sum())
                    r.integrate.append((upd, int(aux.num_visible[0]) * vox,
                                        after.tsdf.element_size()))

    def release(self) -> None:
        del self.runner, self.pipe

    # ------------------------------------------------------------------
    def _reference_chunk(self, ref, ref_types, cut, tf32: bool):
        """The reference's state and per-frame ``ok`` after ``cut``'s
        frames, from the program's state before it (a fresh map for the
        start)."""
        dev = self.run.device
        state = ref.init() if cut.pre is None else ref_types(*cut.pre.to(dev))
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            oks = []
            for i in cut.frames:
                state, aux = ref.step(state, self.frames[i])
                oks.append(bool(aux.ok))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        return state, oks

    def _gaps(self, prog, prog_ok, ref, ref_ok) -> dict:
        mu = self.pipeline["tsdf"]["trunc_dist"]
        pose = compare.pose_gap_mm(prog.T_wc, ref.T_wc)
        if list(prog_ok) != list(ref_ok):
            pose = float("inf")
        sdf, wt = compare.map_gaps(prog, ref, mu)
        return {"pose_gap_mm": pose, "sdf_gap_mm": sdf, "weight_gap": wt,
                "model_gap_mm": compare.model_gap_mm(prog.model_points[0], ref.model_points[0])}

    def check(self):
        """The comparison: every compared chunk through the reference,
        from the program's state before it; the worst of each number.
        With ``control``, also the reference in TF32 in the program's
        place."""
        import fusionbench.reference.config as ref_config
        from fusionbench.reference.models.block_pipeline import BlockPipeline, BlockState

        r = self.run
        ref = BlockPipeline(build_config(ref_config, self.pipeline), r.device)
        numbers, control = {}, ({} if r.control else None)
        for cut, post, host in self.cuts:
            ref_state, ref_ok = self._reference_chunk(ref, BlockState, cut, False)
            prog = post.to(r.device)
            prog_ok = [bool(x) for x in host["ok"]]
            numbers = compare.worst(numbers, self._gaps(prog, prog_ok, ref_state, ref_ok))
            del prog
            if control is not None:
                low, low_ok = self._reference_chunk(ref, BlockState, cut, True)
                control = compare.worst(control, self._gaps(low, low_ok, ref_state, ref_ok))
        return numbers, control
