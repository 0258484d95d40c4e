"""The port's app and its support modules against the JAX package's on
the CPU: checkpoints written by either package loaded by the other,
config files and ``--set`` overrides, the metrics logger, the TUM and
ICL loaders frame by frame on directories written by
scripts/make_synthetic_dataset.py, and ``python -m
topfusion_tpu_torch.apps.run_fusion --device cpu`` on the ICL directory,
held to tests/test_icl_format.py's checks.  Everything here is compared
EQUAL (no arithmetic differs), but for the logger's clock readings."""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from topfusion_tpu.config import PipelineConfig, tiny_test_config
from topfusion_tpu.io import datasets as jds
from topfusion_tpu.io.trajectory import load_tum_trajectory as j_load_tum
from topfusion_tpu.models.block_pipeline import BlockPipeline as JaxPipeline
from topfusion_tpu.models.posegraph import make_pose_graph as j_make_pose_graph
from topfusion_tpu.utils import checkpoint as jck
from topfusion_tpu.utils import config_io as jcio
from topfusion_tpu.utils.metrics import MetricsLogger as JaxLogger
from topfusion_tpu_torch.apps.run_fusion import write_png
from topfusion_tpu_torch.convert import config_from_reference
from topfusion_tpu_torch.io import datasets as tds
from topfusion_tpu_torch.io.gif import MAX_COLOR_ERROR, MAX_GREY_ERROR, gif_frames
from topfusion_tpu_torch.io.trajectory import load_tum_trajectory, save_tum_trajectory
from topfusion_tpu_torch.models.block_pipeline import BlockPipeline
from topfusion_tpu_torch.models.posegraph import make_pose_graph
from topfusion_tpu_torch.utils import checkpoint as tck
from topfusion_tpu_torch.utils import config_io as tcio
from topfusion_tpu_torch.utils.metrics import MetricsLogger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(args, timeout, check=True):
    # Two threads, as the test processes have: beside the other test
    # workers, a process with a thread per core would oversubscribe.
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable] + args, capture_output=True, text=True,
                       timeout=timeout, env=env, cwd=ROOT)
    if check:
        assert r.returncode == 0, (r.stdout[-1000:], r.stderr[-2000:])
    return r


# ----------------------------------------------------------------- datasets
@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    """A 12-frame ICL directory (tests/test_icl_format.py's) and a 6-frame
    noisy TUM directory, written side by side by the generator."""
    base = tmp_path_factory.mktemp("seq")
    dirs = {"icl": str(base / "icl_synth"), "tum": str(base / "tum_synth")}
    script = os.path.join(ROOT, "scripts", "make_synthetic_dataset.py")
    # The script sets a shared JAX compilation cache only where none is set.
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               JAX_COMPILATION_CACHE_DIR=str(base / "jax_cache"))
    procs = [
        subprocess.Popen([sys.executable, script, "--out", dirs["icl"], "--frames", "12",
                          "--noise", "0", "--format", "icl", "--angle", "4", "--shift", "0.04"],
                         cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE),
        subprocess.Popen([sys.executable, script, "--out", dirs["tum"], "--frames", "6",
                          "--noise", "1"],
                         cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE),
    ]
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-2000:]
    finally:
        for p in procs:
            p.kill()
    return dirs


@pytest.mark.parametrize("kind", ["icl", "tum"])
def test_open_sequence_matches_jax(sequences, kind):
    root = sequences[kind]
    got, want = tds.open_sequence(root), jds.open_sequence(root)
    assert type(got).__name__ == type(want).__name__ == ("ICLSequence" if kind == "icl"
                                                         else "TUMSequence")
    assert dataclasses.asdict(got.camera) == dataclasses.asdict(want.camera)
    assert (got.camera.fy < 0) == (kind == "icl")
    assert len(got) == len(want)
    frames = list(got)
    for g, w in zip(frames, want):
        assert g.timestamp == w.timestamp
        assert g.depth_mm.dtype == np.uint16
        np.testing.assert_array_equal(g.depth_mm, w.depth_mm)
        assert (g.rgb is None) and (w.rgb is None)
        np.testing.assert_array_equal(got.gt_pose_at(g.timestamp), want.gt_pose_at(w.timestamp))
    assert (frames[0].depth_mm > 0).mean() > 0.3


def test_tum_trajectory_files_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    from topfusion_tpu_torch.geometry.se3 import se3_exp

    poses = [se3_exp(torch.tensor(rng.normal(0, 0.5, 6), dtype=torch.float32)).numpy()
             for _ in range(8)]
    path = str(tmp_path / "traj.txt")
    save_tum_trajectory(path, poses, [0.1 * i for i in range(8)])
    ts, got = load_tum_trajectory(path)
    jts, want = j_load_tum(path)
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    np.testing.assert_allclose(np.stack(got), np.stack(poses), atol=2e-6)


# ----------------------------------------------------------------- the app
def test_app_on_icl_sequence(sequences, tmp_path):
    """tests/test_icl_format.py's run of the app, through the port's app on
    the CPU: the same overrides, millimetre odometry, every file written;
    with ``--video --orbit-video 3``, a half-size render per chunk in
    video.gif and 3 full-size views of the map in orbit.gif."""
    out = str(tmp_path / "run")
    r = run(["-m", "topfusion_tpu_torch.apps.run_fusion", "--sequence", sequences["icl"],
             "--out", out, "--device", "cpu", "--chunk", "4", "--render-every", "4",
             "--video", "--orbit-video", "3",
             "--set", "icp.iters=4,3,2", "--set", "blockmap.capacity=8192",
             "--set", "blockmap.max_visible_blocks=4096", "--set", "tsdf.voxel_size=0.01",
             "--set", "tsdf.trunc_dist=0.04"], timeout=600)
    with open(os.path.join(out, "metrics.json")) as f:
        summary = json.load(f)
    assert "ate_odom_m" in summary, r.stdout[-500:]
    assert summary["ate_odom_m"] < 0.005, summary
    assert summary["frames"] == 12 and summary["resets"] == 0 and summary["device"] == "cpu"
    # The chunks' spans from the trace (the eager CPU run has no graph marks).
    assert {"slam.chunk", "slam.dispatch", "slam.fetch"} <= set(summary["chunk_phase_ms"])
    assert summary["stage_ms"] == {} and summary["trace_dropped"] == 0
    for name in ("trajectory_odom.txt", "trajectory_opt.txt", "state.npz", "cloud.ply",
                 "metrics.jsonl", "config.yaml", "render_final.png", "render_00008.png",
                 "video.gif", "orbit.gif"):
        assert os.path.exists(os.path.join(out, name)), name
    # The GIFs: 3 chunks at half of 320x240 shown 200 ms each, 3 orbit views
    # at 320x240 shown 100 ms each; shaded, not blank.
    assert gif_frames(os.path.join(out, "video.gif")) == [(160, 120, 20)] * 3
    assert gif_frames(os.path.join(out, "orbit.gif")) == [(320, 240, 10)] * 3
    import imageio.v3 as iio

    # Shaded surface pixels are grey (and stay grey in the GIF); the
    # background gradient is not.  The video's views and the orbit's
    # first (the tracked pose) show the map.
    def surface(frames):
        return ((frames[..., 0] == frames[..., 1]) & (frames[..., 1] == frames[..., 2])).mean(
            axis=(1, 2))

    video = iio.imread(os.path.join(out, "video.gif"), index=None, mode="RGB")
    orbit = iio.imread(os.path.join(out, "orbit.gif"), index=None, mode="RGB")
    assert (surface(video) > 0.3).all() and surface(orbit)[0] > 0.3, (surface(video), surface(orbit))
    assert all(f.std() > 5 for f in [*video, *orbit])
    assert 0.1 < summary["orbit_coverage"] <= 1.0
    # The second chunk's preview is the PNG written after it, within the
    # GIF palette's error (render_final.png is not: it is full size).
    png = iio.imread(os.path.join(out, "render_00008.png")).astype(np.int64)
    gif = iio.imread(os.path.join(out, "video.gif"), index=1, mode="RGB").astype(np.int64)
    grey = (png[..., 0] == png[..., 1]) & (png[..., 1] == png[..., 2])
    assert np.abs(gif - png)[grey].max() <= MAX_GREY_ERROR
    assert np.abs(gif - png).max() <= MAX_COLOR_ERROR
    # The trajectory carries the sequence's timestamps; the config and the
    # checkpoint load into the JAX package.
    jts, _ = j_load_tum(os.path.join(out, "trajectory_odom.txt"))
    np.testing.assert_allclose(jts, [f.timestamp for f in jds.open_sequence(sequences["icl"])],
                               atol=1e-6)
    cfg = jcio.load_config(os.path.join(out, "config.yaml"))
    assert cfg.camera.fy < 0 and cfg.blockmap.pool_dtype == "int16"
    state = jck.load_state(os.path.join(out, "state.npz"), JaxPipeline(cfg).init())
    assert int(state.num_blocks) > 0


def test_app_runs_on_the_card_unless_told():
    """Without --device the app asks for the card: where there is none it
    exits non-zero with the entry point's error, and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = run(["-m", "topfusion_tpu_torch.apps.run_fusion", "--synthetic", "3",
             "--out", os.devnull + "_x"], timeout=120, check=False)
    assert r.returncode != 0 and "torch.cuda.is_available" in r.stderr


def test_write_png_round_trips(tmp_path):
    import imageio.v3 as iio

    rng = np.random.default_rng(2)
    for shape in ((5, 7, 3), (4, 9)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        path = str(tmp_path / f"x{len(shape)}.png")
        write_png(path, img)
        np.testing.assert_array_equal(iio.imread(path), img)


# ----------------------------------------------------------------- checkpoints
def _filled(state, rng):
    """``state`` with every floating and integer leaf random (bools kept),
    so a shuffled leaf order cannot pass."""
    def fill(x):
        a = np.asarray(x)
        if a.dtype == bool:
            return a
        if a.dtype == ml_dtypes.bfloat16 or a.dtype.kind == "f":
            return rng.uniform(-1, 1, a.shape).astype(a.dtype)
        return rng.integers(0, 100, a.shape).astype(a.dtype)

    return type(state)(*[tuple(jnp.asarray(fill(y)) for y in v) if isinstance(v, tuple)
                         else jnp.asarray(fill(v)) for v in state])


def _leaves(state):
    out = []
    for v in state:
        for x in (v if isinstance(v, tuple) else (v,)):
            t = x.to(torch.float32) if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16 else x
            a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(x)
            out.append(a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a)
    return out


@pytest.mark.parametrize("dtype", ["float32", "int16", "bfloat16"])
def test_checkpoints_load_across_packages(tmp_path, dtype):
    """A BlockState and a PoseGraph saved by the JAX package load into the
    port, and the port's files load into the JAX package, leaf for leaf."""
    rng = np.random.default_rng(5)
    base = tiny_test_config()
    cfg = dataclasses.replace(base, blockmap=dataclasses.replace(base.blockmap, pool_dtype=dtype))
    tcfg = config_from_reference(cfg)
    cam_l = cfg.camera.at_level(1)
    cases = [
        (_filled(JaxPipeline(cfg).init(), rng), BlockPipeline(tcfg, "cpu").init()),
        (_filled(j_make_pose_graph(cfg.posegraph, cam_l), rng),
         make_pose_graph(tcfg.posegraph, tcfg.camera.at_level(1), "cpu")),
    ]
    for i, (jstate, like) in enumerate(cases):
        path = str(tmp_path / f"jax{i}.npz")
        jck.save_state(path, jstate)
        got = tck.load_state(path, like)
        assert type(got) is type(like)
        for g, w, ref in zip(_leaves(got), _leaves(jstate), _leaves(like)):
            assert g.dtype == ref.dtype
            np.testing.assert_array_equal(g, w)
        back = str(tmp_path / f"port{i}.npz")
        tck.save_state(back, got)
        again = jck.load_state(back, jstate)
        for g, w in zip(_leaves(again), _leaves(jstate)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_load_state_refuses_another_config(tmp_path):
    base = tiny_test_config()
    path = str(tmp_path / "s.npz")
    tck.save_state(path, BlockPipeline(config_from_reference(base), "cpu").init())
    bigger = dataclasses.replace(base, blockmap=dataclasses.replace(
        base.blockmap, capacity=2 * base.blockmap.capacity))
    with pytest.raises(ValueError, match="config mismatch"):
        tck.load_state(path, BlockPipeline(config_from_reference(bigger), "cpu").init())


# ----------------------------------------------------------------- config IO
OVERRIDES = ["tsdf.voxel_size=0.01", "icp.iters=4,3,2", "blockmap.use_pallas_integrate=auto",
             "posegraph.solver=dense", "blockmap.out_of_core=true", "camera.fy=-480.0",
             "blockmap.capacity=0x2000"]


@pytest.mark.parametrize("ext", ["json", "yaml"])
def test_config_files_and_overrides_match_jax(tmp_path, ext):
    want = jcio.apply_overrides(PipelineConfig(), OVERRIDES)
    got = tcio.apply_overrides(config_from_reference(PipelineConfig()), OVERRIDES)
    assert got == config_from_reference(want)
    assert got.icp.iters == (4, 3, 2) and got.blockmap.use_pallas_integrate is None
    assert got.blockmap.capacity == 8192 and got.blockmap.out_of_core
    path = str(tmp_path / f"cfg.{ext}")
    tcio.save_config(path, got)
    assert tcio.load_config(path) == got
    assert config_from_reference(jcio.load_config(path)) == got
    jpath = str(tmp_path / f"jcfg.{ext}")
    jcio.save_config(jpath, want)
    assert tcio.load_config(jpath) == got
    with open(path) as f, open(jpath) as g:
        assert f.read() == g.read()
    with pytest.raises(KeyError, match="unknown config key"):
        tcio.apply_overrides(got, ["tsdf.no_such_field=1"])
    with pytest.raises(ValueError, match="key=value"):
        tcio.apply_overrides(got, ["tsdf.voxel_size"])


# ----------------------------------------------------------------- metrics
def test_metrics_logger_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    records = [{"frame": i, "ok": bool(i % 5), "reset": i == 7, "loop": i == 9,
                "inliers": int(rng.integers(100, 1000)), "blocks": int(rng.integers(1, 50)),
                "residual": float(rng.uniform(0, 0.01))} for i in range(40)]
    paths = [str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")]
    loggers = [MetricsLogger(paths[0], print_every=0), JaxLogger(paths[1], print_every=0)]
    for rec in records:
        for lg in loggers:
            lg.log_frame(rec)
    got, want = (lg.summary() for lg in loggers)
    clock = {"fps_mean", "frame_time_p50_ms", "frame_time_p95_ms"}
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in clock} == \
        {k: v for k, v in want.items() if k not in clock}
    assert got["resets"] == 1 and got["loops"] == 1 and got["frames"] == 40
    for lg in loggers:
        lg.close()
    lines = [[json.loads(x) for x in open(p)] for p in paths]
    for a, b in zip(*lines):
        a.pop("frame_time_s")
        b.pop("frame_time_s")
        assert a == b
