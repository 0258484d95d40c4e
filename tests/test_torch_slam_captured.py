"""The SLAM system's compiled entry points (``models/slam.py``'s chunk with
0-d device ``frame0`` / ``do_kf``, its re-integration bodies, and the
runner ``models/slam.CapturedSlam``) against the JAX package on the
CPU, at tests/test_torch_slam.py's configuration (80x64, keyframes every
3 frames, an 8-frame ring, every correction rebuilding the map) on its
15-frame out-and-back.

One JAX run: the JAX ``SlamSystem`` over the frames in chunks of 3, the
whole state kept before every chunk, and the arguments and results of
every ``_reint`` it makes.  From those carried states:

* the port's ``_chunk`` (frame0 a nonzero 0-d int32 tensor, do_kf a 0-d
  bool tensor, both ways) against the jitted JAX ``_chunk_impl`` with the
  same arguments, to tests/test_torch_slam.py's tolerances (decisions
  equal, poses within 1e-4);
* the port's ``_reint`` (its wipe, keyframe, ring and re-anchor bodies)
  against the JAX ``_reint`` on the arguments of the run's last rebuild,
  which re-fuses keyframes older than the ring from the store and the
  ring's 8 frames;
* the runner's buffer logic (``models/slam.CapturedSlam``, given to a
  CPU system by hand), with every CUDA graph replaced by a re-run of the
  function it captures (a CPU has no graphs): bit-identical to the eager
  system over the whole run, a state carried in mid-run included.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_slam import make_cfg
from tests.test_torch_slam import carried_gt, correcting
from topfusion_tpu.io.synthetic import SyntheticScene
from topfusion_tpu.models.slam import SlamSystem as JaxSlam
from topfusion_tpu_torch.convert import (
    _fields_numpy,
    block_state_from_numpy,
    config_from_reference,
    pose_graph_from_numpy,
    slam_state_from_numpy,
    slam_state_to_numpy,
)
from topfusion_tpu_torch.models import captured
from topfusion_tpu_torch.models import slam as slam_mod
from topfusion_tpu_torch.models.slam import SlamSystem

torch.set_num_threads(2)

RING = 8
CARRIED_CHUNKS = (2, 4)  # chunks run from a carried state: frame0 6 and 12


def rebuilding_cfg():
    return correcting(make_cfg(), reint_ring=RING)


def numpy_tree(x):
    return jax.tree.map(np.asarray, x)


@pytest.fixture(scope="module")
def jax_run():
    cfg = rebuilding_cfg()
    scene = SyntheticScene()
    depths = np.stack([np.asarray(scene.render_depth_mm(cfg.camera, jnp.asarray(T, jnp.float32)))
                       for T in carried_gt()])
    js = JaxSlam(cfg)
    reints = []
    reint = js._reint

    def recorded(*args):
        out = reint(*args)
        reints.append((numpy_tree(args), numpy_tree(out)))
        return out

    js._reint = recorded
    ke = cfg.posegraph.keyframe_every
    before, chunks = [], {}
    for c in range(len(depths) // ke):
        before.append(slam_state_to_numpy(js))
        if c in CARRIED_CHUNKS:
            for do_kf in (True, False):
                args = (js.state, js.graph, js.kf_depth_buf, js.kf_odom_buf, js._ring(),
                        jnp.asarray(depths[c * ke:(c + 1) * ke]), None,
                        jnp.asarray(c * ke, jnp.int32), jnp.asarray(do_kf))
                chunks[c, do_kf] = numpy_tree(js._chunk(*args))
        js.process_chunk(depths[c * ke:(c + 1) * ke])
    return dict(cfg=cfg, depths=depths, before=before, chunks=chunks, reints=reints,
                loops=js.loops_closed)


def port_system(values):
    ts = SlamSystem(config_from_reference(rebuilding_cfg()), device="cpu")
    slam_state_from_numpy(values, ts)
    return ts


# ----------------------------------------------------------------- chunk
@pytest.fixture(scope="module")
def port_chunks(jax_run):
    ke = jax_run["cfg"].posegraph.keyframe_every
    out = {}
    for c, do_kf in jax_run["chunks"]:
        ts = port_system(jax_run["before"][c])
        res = ts._chunk(ts.state, ts.graph, ts.kf_depth_buf, ts.kf_odom_buf, ts._ring(),
                        torch.from_numpy(jax_run["depths"][c * ke:(c + 1) * ke]), None,
                        torch.full((), c * ke, dtype=torch.int32),
                        torch.full((), do_kf, dtype=torch.bool))
        out[c, do_kf] = res
    return out


CASES = [(c, k) for c in CARRIED_CHUNKS for k in (True, False)]
IDS = [f"frame0_{3 * c}_do_kf_{k}" for c, k in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_chunk_decisions_equal_jax(jax_run, port_chunks, case):
    """Tracking health, the keyframes added, the loop flags and counts,
    and the graph's integer fields equal the JAX chunk's."""
    got, want = port_chunks[case], jax_run["chunks"][case]
    auxes, jaux = got[6], want[6]
    for name in ("ok", "was_reset", "num_blocks", "blocks_dropped", "visible_overflow"):
        np.testing.assert_array_equal(getattr(auxes, name).numpy(), getattr(jaux, name), name)
    assert bool(got[7]) == bool(want[7])                     # found
    np.testing.assert_array_equal(got[8].numpy(), want[8])   # added
    assert int(got[10].n_closed) == int(want[10].n_closed)
    g, w = got[1], want[1]
    for name in ("num_kf", "kf_frame", "edge_i", "edge_j", "edge_is_loop", "num_edges",
                 "kf_loop_done"):
        np.testing.assert_array_equal(getattr(g, name).numpy(), getattr(w, name), name)
    if not case[1]:  # no keyframe: the graph keeps its keyframes
        assert int(g.num_kf) == int(jax_run["before"][case[0]]["graph"]["num_kf"])
    assert bool(want[8].any()) == case[1]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_chunk_poses_and_stores_follow_jax(jax_run, port_chunks, case):
    """Poses within 1e-4 (tests/test_torch_slam.py's tolerance), graph
    poses and measured transforms within 1e-5, the keyframe depth store
    and the ring's depths and keyframe indices equal, their poses within
    1e-4."""
    got, want = port_chunks[case], jax_run["chunks"][case]
    np.testing.assert_allclose(got[5].numpy(), want[5], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[0].T_wc.numpy(), want[0].T_wc, rtol=0, atol=1e-4)
    for name in ("kf_poses", "edge_T"):
        np.testing.assert_allclose(getattr(got[1], name).numpy(), getattr(want[1], name),
                                   rtol=0, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_allclose(got[3].numpy(), want[3], rtol=0, atol=1e-4)
    (rd, rp, rk), (jd, jp, jk) = got[4], want[4]
    np.testing.assert_array_equal(rd.numpy(), jd)
    np.testing.assert_array_equal(rk.numpy(), jk)
    np.testing.assert_allclose(rp.numpy(), jp, rtol=0, atol=1e-4)


# ----------------------------------------------------------------- rebuild
@pytest.fixture(scope="module")
def rebuilt(jax_run):
    """The port's ``_reint`` on the arguments of the JAX run's last
    rebuild."""
    (state, graph, kf_buf, kf_odom_last, kf_odom_buf, ring, frame_now), (jst, jcorr) = \
        jax_run["reints"][-1]
    ts = SlamSystem(config_from_reference(rebuilding_cfg()), device="cpu")
    st = block_state_from_numpy(_fields_numpy(state), "cpu")
    g = pose_graph_from_numpy(_fields_numpy(graph), "cpu")
    t = torch.from_numpy
    ring_t = tuple(t(np.array(x)) for x in ring)
    got_st, got_corr = ts._reint(st, g, t(np.array(kf_buf)), t(np.array(kf_odom_last)),
                                 t(np.array(kf_odom_buf)), ring_t, int(frame_now),
                                 int(graph.num_kf))
    return dict(got=(got_st, got_corr), want=(jst, jcorr), frame_now=int(frame_now),
                kf_frame=np.asarray(graph.kf_frame)[:int(graph.num_kf)])


def test_rebuild_covers_store_and_ring(jax_run, rebuilt):
    """The rebuild compared re-fuses keyframes older than the ring from
    the store, and the ring's 8 frames."""
    assert jax_run["loops"] >= 2 and len(jax_run["reints"]) >= 2
    ring_min = max(rebuilt["frame_now"] - RING, 0)
    assert (rebuilt["kf_frame"] < ring_min).any() and (rebuilt["kf_frame"] >= ring_min).any()
    assert rebuilt["frame_now"] - ring_min == RING


@pytest.mark.parametrize("field", ["bucket_keys", "bucket_slots", "block_coords", "num_blocks",
                                   "frame", "resets"])
def test_rebuild_map_equals_jax(rebuilt, field):
    np.testing.assert_array_equal(getattr(rebuilt["got"][0], field).numpy(),
                                  np.asarray(getattr(rebuilt["want"][0], field)))


def test_rebuild_fusion_and_reanchor_follow_jax(rebuilt):
    """The correction within 1e-5 and the live pose within 1e-4; tsdf
    within 5e-3 and weights equal on all but 0.1% of the voxels
    (tests/test_torch_slam.py's map tolerances), the re-anchored model
    maps within 1e-3 m on all but 1% of the pixels (a surfel at a
    silhouette moves with the last bits of the pose), the visible set
    equal."""
    (st, corr), (jst, jcorr) = rebuilt["got"], rebuilt["want"]
    np.testing.assert_allclose(corr.numpy(), np.asarray(jcorr), rtol=0, atol=1e-5)
    np.testing.assert_allclose(st.T_wc.numpy(), np.asarray(jst.T_wc), rtol=0, atol=1e-4)
    assert (np.abs(st.tsdf.numpy().astype(np.float64) - np.asarray(jst.tsdf)) > 5e-3).mean() <= 1e-3
    assert (st.weight.numpy() != np.asarray(jst.weight)).mean() <= 1e-3
    for lvl, (p, jp) in enumerate(zip(st.model_points, jst.model_points)):
        assert (np.abs(p.numpy() - np.asarray(jp)) > 1e-3).mean() <= 1e-2, lvl
    np.testing.assert_array_equal(st.vis_slots.numpy(), np.asarray(jst.vis_slots))


# ----------------------------------------------------------------- runner
class ReRun:
    """A graph stand-in: replay re-runs the captured function."""

    def __init__(self, fn, pool=None):
        self.fn, self.per_replay = fn, {}

    def replay(self):
        self.fn()


class ReRunStep:
    """``CapturedStep`` over the live state with each replay a re-run of
    the step (the aux of a first, discarded step gives the shapes)."""

    def __init__(self, pipe, state, rgb=False, pool=None, adopt=False):
        assert adopt
        self.pipe, self._static = pipe, state
        cam = pipe.cfg.camera
        self._depth = torch.zeros((cam.height, cam.width), dtype=torch.int32).to(torch.uint16)
        self._rgb = torch.zeros((cam.height, cam.width, 3), dtype=torch.uint8) if rgb else None
        _, self._aux = pipe.step(state, self._depth, self._rgb)

    def replay(self):
        new, self._aux = self.pipe.step(self._static, self._depth, self._rgb)
        captured._copy_state(self._static, new)


@pytest.fixture(scope="module")
def rerun_runner(jax_run):
    """The whole run through the eager system and through ``CapturedSlam``
    with re-run graphs, both carried into the JAX state after chunk 3
    before chunk 4."""
    mp = pytest.MonkeyPatch()
    mp.setattr(slam_mod, "Graph", ReRun)
    mp.setattr(slam_mod, "CapturedStep", ReRunStep)
    mp.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    mp.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    try:
        cfg = config_from_reference(rebuilding_cfg())
        ke = cfg.posegraph.keyframe_every
        eager, runner = SlamSystem(cfg, device="cpu"), SlamSystem(cfg, device="cpu")
        runner._runner = slam_mod.CapturedSlam(runner)
        depths = torch.from_numpy(jax_run["depths"])
        infos = ([], [])
        for c in range(len(depths) // ke):
            if c == 4:
                for s in (eager, runner):
                    slam_state_from_numpy(jax_run["before"][c], s)
            for s, inf in zip((eager, runner), infos):
                inf += s.process_chunk(depths[c * ke:(c + 1) * ke])
        return dict(eager=eager, runner=runner, infos=infos)
    finally:
        mp.undo()


def test_runner_made_its_graphs(rerun_runner):
    """One step, one tail (chunks of 3), the solve and the four rebuild
    bodies; the system's attributes are the runner's buffers."""
    slam = rerun_runner["runner"]
    r = slam._runner
    assert isinstance(r, slam_mod.CapturedSlam) and r.captures == 7
    assert set(r.tails) == {(3, False)} and r.solve_graph is not None and r.rebuild[2] is not None
    for name, buf in r.live.items():
        assert getattr(slam, name) is buf, name
    assert slam.loops_closed >= 2 and slam.reintegrations >= 2


def test_runner_is_the_eager_system(rerun_runner):
    """Infos, trajectories, graph, map, stores and ring bit-identical to
    the eager system's."""
    e, r = rerun_runner["eager"], rerun_runner["runner"]
    assert rerun_runner["infos"][0] == rerun_runner["infos"][1]
    for key in ("odom_poses", "kf_odom_poses"):
        np.testing.assert_array_equal(np.stack(getattr(e, key)), np.stack(getattr(r, key)))
    np.testing.assert_array_equal(np.stack(e.optimized_trajectory()),
                                  np.stack(r.optimized_trajectory()))
    got, want = slam_state_to_numpy(r), slam_state_to_numpy(e)
    for part in ("state", "graph"):
        for name, w in want[part].items():
            for a, b in zip(*((got[part][name], w) if isinstance(w, tuple)
                              else ((got[part][name],), (w,)))):
                np.testing.assert_array_equal(a, b, err_msg=f"{part}.{name}")
    for name in ("kf_depth_buf", "kf_odom_buf"):
        np.testing.assert_array_equal(got[name], want[name])
    for a, b in zip(got["ring"], want["ring"]):
        np.testing.assert_array_equal(a, b)
    assert (e.loops_closed, e.reintegrations) == (r.loops_closed, r.reintegrations)


def test_rebuild_refuses_other_buffers(rerun_runner):
    """The captured rebuild works on the live buffers only."""
    slam = rerun_runner["runner"]
    with pytest.raises(ValueError, match="live buffers"):
        slam._runner.reint(slam.state, slam.graph, slam.kf_depth_buf.clone(), torch.eye(4),
                           slam.kf_odom_buf, slam._ring(), slam.frame_idx, 1)
